"""``benchmark/run.py`` end to end on the CPU, through the program's plain
versions (``-engine torch``) at a tiny size.

The ``calibrated`` mix, which no cell uses yet, is not rehearsed here: each
of its jobs scores 400,000 emitted reads, which the plain versions take
many minutes for on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY = {"reads_per_file": 500, "warmup_reads": 300, "check_reads_per_job": 200,
        "max_jobs": 2}
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def metric_names(cell: str, trace: int) -> set:
    spec = run.cell_spec(cell)
    return {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["grid48.fixedq", "plate96.arch_fixedq"])
def test_a_run_prints_the_contract_line(capsys, cell, trace):
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 5), "--seconds", "1",
                   "--trace", str(trace)], rehearse=TINY)
    assert rc == 0
    res = last_line(capsys)
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    got = set(res["metrics"])
    want = metric_names(cell, trace)
    if trace:
        # no device on the CPU: the readers of the trace find nothing
        want -= {"kernels.dp_roofline", "device.idle_pct"}
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    assert got == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "grid48.fixedq", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_new_files_are_found_without_an_edit(tmp_path):
    """A throwaway configuration, mix, metric and limits added as files,
    with entries in ``BENCHMARK.json``, run in a copy of the benchmark."""
    copy = tmp_path / "tree"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(copy / "benchmark/configs/grid48x6nt.json"))
    cfg.update(name="tiny8", barcodes=cfg["barcodes"][:8],
               architecture=["B:" + ",".join(cfg["barcodes"][:8]), "R:N"])
    json.dump(cfg, open(copy / "benchmark/configs/tiny8.json", "w"))
    json.dump({"name": "q20", "flags": ["-Q", "20"], "reads_per_file": 400,
               "warmup_reads": 100, "check_reads_per_job": 50, "check_jobs": 1},
              open(copy / "benchmark/mixes/q20.json", "w"))
    json.dump({"reads_apart_pct": 5.0, "jobs_unchecked": 0},
              open(copy / "benchmark/limits/tiny8.q20.json", "w"))
    (copy / "benchmark/metrics/jobs_done.py").write_text(
        "def read(run):\n    return float(len(run['jobs']))\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny8",
                                 file="benchmark/configs/tiny8.json"))
    bench["workloads"].append({"name": "tiny8.q20", "config": "tiny8", "traffic": "q20",
                               "chips": 1, "why": "a throwaway cell"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny8.q20"]})
    json.dump(bench, open(copy / "BENCHMARK.json", "w"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from benchmark import run; "
            "sys.exit(run.main(['--workload', 'tiny8.q20', '--seed', '9', '--seconds', '1'],"
            " rehearse={'reads_per_file': 400, 'warmup_reads': 100,"
            " 'check_reads_per_job': 50, 'max_jobs': 2}))")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code, str(copy)], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"reads_per_s", "setup_s", "jobs_done"}
    assert line["metrics"]["jobs_done"]["value"] == 2.0
    assert "reference: job" in res.stderr and res.stderr.count("reference: job") == 1
