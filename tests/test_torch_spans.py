"""The port's span registry (``tagdust_tpu_torch/spans.py``) on the CPU.

Four ``tagdust`` jobs of the port's CLI, in process: a barcode job on
``-engine torch`` streamed in windows of 64 reads over chunks of 256, a
second such job on another file, an ``-arch`` job, and a calibrating job on
``-engine exact`` (one-shot labelling).  Each job's ``controller.TIMINGS``
must hold a span for every layer its path runs, count the streamed windows,
hold its own job alone, and split ``runner.label`` into parts no longer
than the whole.  Without a profiler no span opens a ``record_function``
range; under ``torch.profiler`` the main thread's ``tagdust.*`` ranges are
in the trace, nest inside ``tagdust.runner.label`` and lie on the Unix
clock.  The benchmark's nine span readers read the record.
"""

import time

import pytest
import torch

from tagdust_tpu_torch import controller, spans, stats
from tagdust_tpu_torch.cli.tagdust import main
from tagdust_tpu_torch.engine import runner

from test_torch_cli import ARCH_FILE, ARCHS, write_fastq

ENV = {"TAGDUST_TPU_BT": "8", "TAGDUST_TPU_WINDOW": "64", "TAGDUST_TPU_CHUNK": "256"}
WINDOW = ("runner.prepare", "runner.dispatch", "runner.fetch", "runner.wait",
          "runner.extract")
STREAM = ("controller.stats", "controller.model_build", "runner.label", *WINDOW,
          "io.reader_wait", "io.writer_wait", "io.parse", "io.write")
KEYS = {
    "stream": STREAM + ("runner.engine_build",),
    "again": STREAM + ("runner.engine_build",),
    "arch": STREAM + ("detection", "detect.stats", "detect.build", "detect.read",
                      "detect.score", "detect.pick", "runner.engine_build"),
    "calibrate": ("controller.stats", "calibration.emit", "calibration.score",
                  "calibration.sweep", "controller.model_build", "runner.label",
                  "runner.oneshot", "runner.engine_build", "io.reader_wait",
                  "io.writer_wait", "io.parse", "io.write"),
}
FLAGS = {
    "stream": [*ARCHS["barcode"], "-Q", "10", "-engine", "torch"],
    "again": [*ARCHS["barcode"], "-Q", "10", "-engine", "torch"],
    "arch": ["-arch", "{arch_file}", "-Q", "10", "-engine", "torch"],
    "calibrate": [*ARCHS["barcode"], "-rtest", "-seed", "7", "-engine", "exact"],
}


def _job(tmp, name: str, seed: int) -> dict:
    """One job of ``FLAGS[name]`` on 600 reads: its TIMINGS, windows and
    wall edges on the Unix clock."""
    fq = str(tmp / f"{name}.fq")
    write_fastq(fq, 600, seed=seed)
    flags = [f.format(arch_file=tmp / "arch.txt") for f in FLAGS[name]]
    w0 = runner.STREAM_STATS["windows"]
    t0 = time.time_ns()
    main([fq, *flags, "-o", str(tmp / name)])
    t1 = time.time_ns()
    return {"timings": dict(controller.TIMINGS), "reads": 600, "t0": t0, "t1": t1,
            "windows": runner.STREAM_STATS["windows"] - w0}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    (tmp / "arch.txt").write_text(ARCH_FILE)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        # every job builds its own engine, as a new file does
        mp.setattr(runner, "_ENGINE_CACHE", {})
        mp.setattr(stats, "_STATS_CACHE", {})
        return {name: _job(tmp, name, seed) for seed, name in enumerate(FLAGS, 1)}


@pytest.mark.parametrize("name", list(KEYS))
def test_every_layer_the_path_runs_has_its_span(jobs, name):
    t = jobs[name]["timings"]
    assert t is not controller.TIMINGS and controller.TIMINGS is spans.TIMINGS
    for key in KEYS[name]:
        assert t.get(key + ".calls", 0) >= 1, key
        assert t[key] >= 0.0, key
    assert t["calibration"] is not None
    assert (t["detection"] > 0) == (name == "arch")


@pytest.mark.parametrize("name", ["stream", "again", "arch"])
def test_the_waits_count_the_jobs_windows(jobs, name):
    job = jobs[name]
    assert job["windows"] >= 3
    for key in WINDOW:
        assert job["timings"][key + ".calls"] == job["windows"], key
    # 600 reads in chunks of 256: three chunks and the empty one that ends
    # the stream
    assert job["timings"]["io.reader_wait.calls"] == 4
    assert job["timings"]["io.parse.calls"] == 4
    assert job["timings"]["runner.label.calls"] == 3


def test_the_second_job_holds_its_own_values(jobs):
    first, second = jobs["stream"]["timings"], jobs["again"]["timings"]
    assert second["controller.model_build.calls"] == 1
    assert second["runner.engine_build.calls"] == 1
    assert second["runner.label.calls"] == 3
    assert second["runner.wait.calls"] == jobs["again"]["windows"]
    assert second["detection"] == 0.0 and "detection.calls" not in second
    # the arch and calibrating jobs ran between them and left nothing behind
    assert not any(k.startswith(("detect.", "calibration.", "runner.oneshot"))
                   for k in second)
    assert second["runner.label"] != first["runner.label"]


@pytest.mark.parametrize("name", ["stream", "again", "arch", "calibrate"])
def test_the_parts_of_the_label_span_fit_inside_it(jobs, name):
    t = jobs[name]["timings"]
    parts = sum(t.get(k, 0.0) for k in WINDOW + ("runner.oneshot",))
    assert 0 < parts <= t["runner.label"]
    wall = (jobs[name]["t1"] - jobs[name]["t0"]) / 1e9
    assert t["runner.label"] + t["io.reader_wait"] + t["io.writer_wait"] <= wall


def _count_ranges(monkeypatch) -> list:
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return opened


def test_no_range_opens_without_a_profiler(tmp_path, monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    opened = _count_ranges(monkeypatch)
    (tmp_path / "arch.txt").write_text(ARCH_FILE)
    job = _job(tmp_path, "arch", 9)
    assert job["timings"]["runner.wait.calls"] >= 3
    assert opened == []


def test_a_count_adds_to_its_key_alone(monkeypatch):
    monkeypatch.setattr(spans, "TIMINGS", {})
    spans.count("runner.left_running")
    spans.count("runner.left_running", 0)
    spans.count("runner.left_running", 2)
    assert spans.TIMINGS == {"runner.left_running": 3}


def test_detection_counts_the_reads_it_scored(jobs):
    from tagdust_tpu_torch.detect import NUM_QUERY

    t = jobs["arch"]["timings"]
    assert t["detect.reads"] == min(NUM_QUERY, jobs["arch"]["reads"])
    assert t["detect.read.calls"] == 1
    for name in ("stream", "again", "calibrate"):
        assert "detect.reads" not in jobs[name]["timings"], name


@pytest.mark.parametrize("candidates", [3, 1])
def test_detection_counts_no_more_than_num_query(tmp_path, monkeypatch, candidates):
    """A file longer than ``NUM_QUERY`` counts ``NUM_QUERY`` reads; an
    ``-arch`` file of one candidate scores nothing and counts none."""
    from tagdust_tpu_torch import detect

    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(detect, "NUM_QUERY", 250)
    lines = ARCH_FILE.splitlines(keepends=True)
    (tmp_path / "arch.txt").write_text("".join(lines[-candidates:]))
    t = _job(tmp_path, "arch", 13)["timings"]
    assert t["detection.calls"] == 1
    if candidates > 1:
        assert t["detect.reads"] == 250 and t["detect.read.calls"] == 1
    else:
        assert "detect.reads" not in t and "detect.read.calls" not in t


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The ``stream`` job under ``torch.profiler``: the job, the ranges
    ``record_function`` opened, and the ``tagdust.*`` host events
    (name, start, end)."""
    tmp = tmp_path_factory.mktemp("traced")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setattr(runner, "_ENGINE_CACHE", {})
        opened = _count_ranges(mp)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            job = _job(tmp, "stream", 11)
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("tagdust.")]
    return job, opened, events


def test_the_main_threads_spans_are_ranges_in_the_trace(traced):
    job, opened, events = traced
    main_thread = [k for k in STREAM + ("runner.engine_build",)
                   if k not in ("io.parse", "io.write")]
    names = [n for n, _, _ in events]
    for key in main_thread:
        assert names.count("tagdust." + key) == job["timings"][key + ".calls"], key
    assert sorted(opened) == sorted(names)


@pytest.mark.parametrize("key", [*WINDOW, "runner.engine_build"])
def test_the_window_ranges_nest_inside_the_label_range(traced, key):
    _, _, events = traced
    labels = [(a, b) for n, a, b in events if n == "tagdust.runner.label"]
    inner = [(a, b) for n, a, b in events if n == "tagdust." + key]
    assert inner
    for a, b in inner:
        assert any(la <= a and b <= lb for la, lb in labels), (key, a, b)


def test_the_ranges_are_on_the_unix_clock(traced):
    job, _, events = traced
    assert events
    for name, a, b in events:
        assert job["t0"] <= a <= b <= job["t1"], name


READERS = {
    "runner.prepare_s_per_mread": ("runner.prepare",),
    "runner.enqueue_s_per_mread": ("runner.dispatch", "runner.fetch"),
    "runner.wait_s_per_mread": ("runner.wait",),
    "runner.extract_s_per_mread": ("runner.extract",),
    "runner.engine_build_s": ("runner.engine_build",),
    "controller.model_build_s": ("controller.model_build",),
    "io.parse_s_per_mread": ("io.parse",),
    "io.reader_wait_s_per_mread": ("io.reader_wait",),
    "io.writer_wait_s_per_mread": ("io.writer_wait",),
}


@pytest.mark.parametrize("metric", list(READERS))
def test_the_benchmarks_span_readers_read_the_record(jobs, metric):
    from benchmark.run import reader

    read = reader(metric)
    run = {"jobs": [{"reads": j["reads"], "timings": j["timings"]}
                    for j in (jobs["stream"], jobs["again"])]}
    value = read(run)
    assert value is not None and value > 0
    keys = READERS[metric]
    per_job = [sum(j["timings"][k] for k in keys) for j in run["jobs"]]
    want = (sum(per_job) / 1200 * 1e6 if metric.endswith("_per_mread")
            else sum(per_job) / 2)
    assert value == pytest.approx(want)
    # a record without the key: an older program's, or a job that skipped it
    bare = {"jobs": [{"reads": j["reads"],
                      "timings": {k: v for k, v in j["timings"].items()
                                  if not k.startswith(keys)}}
                     for j in run["jobs"]]}
    assert read(bare) is None
    assert read({"jobs": [{"reads": 600, "timings": {"detection": 0.0,
                                                     "calibration": 0.5}}]}) is None
