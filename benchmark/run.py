#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (``configs/<name>.json``) under a traffic mix
(``mixes/<name>.json``); its metrics are readers ``metrics/<name>.py`` and
its limits ``limits/<cell>.json``.  The harness finds each by the names in
``BENCHMARK.json``, so a cell, a configuration, a mix or a metric is added
with files and entries alone.

1. Set-up (``setup_s``): import, the card, the program's kernel library
   (built once into the checkout's ``build/``), one warm-up job with the
   cell's flags on ``warmup_reads`` reads, and the first job's input.
2. The window: jobs back to back, each a whole ``tagdust`` run
   (``program.Program.job``) on a file of its own, made from
   ``(seed, job)`` between jobs off the clock, with a fresh output prefix.
   The window is ``--seconds`` of job time; a job that starts inside it runs
   to its end and counts.  After each job the outputs of its sampled reads
   are read back (``outputs.collect``) and its files deleted.
3. With ``--trace 1`` the window runs under ``torch.profiler``, and the
   cell's per-layer metrics are read from it and the spans.
4. Once the window has closed and the peak memory is read, the program's
   state is dropped and the reference judges the jobs (``check.py``).

Inputs and outputs live in a directory that ``tempfile.mkdtemp`` makes
under ``TMPDIR``; it is removed at the end.  The last lines of standard
error, and the key ``checks`` of the result line, give each number compared
beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "tagdust_tpu")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def cell_spec(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    limits and metrics (those whose ``workloads`` name it, or that have
    none)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, cfg["file"]))
    if "candidates" in config:
        config["candidates"] = os.path.join(root, config["candidates"])
    mix = load_json(os.path.join(HERE, "mixes", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": cell, "config": config, "mix": mix, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(name: str):
    """``read(run) -> number or None`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(args, rehearse: dict = None) -> int:
    """One run of a cell.  ``rehearse`` ({"reads_per_file", "warmup_reads",
    "check_reads_per_job", "max_jobs"}) runs it on the CPU through the
    program's plain versions (``-engine torch``) at those sizes, for the
    tests; a run on the card never takes it."""
    spec = cell_spec(args.workload)
    mix, config = spec["mix"], spec["config"]
    import torch

    from benchmark.harness import Jobs, NoCard, setup

    try:
        run_on = setup(spec, rehearse)
    except NoCard as exc:
        sys.stderr.write(f"{exc}\n")
        return 2
    device = run_on["device"]
    n_reads, n_warm = run_on["reads_per_file"], run_on["warmup_reads"]

    from benchmark import check
    from benchmark.program import Program

    traced = bool(args.trace)
    program = Program(run_on["engine"], traced)
    tmp = tempfile.mkdtemp(prefix="tagdust-bench-")
    runner = Jobs(config, mix, program, tmp, run_on["check_reads_per_job"])
    try:
        runner.warm_up(args.seed, n_warm)
        path = runner.make_input(args.seed, 0, n_reads)
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0

        prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        jobs = runner.window(args.seed, n_reads, path, args.seconds, run_on["max_jobs"])
        summary = None
        if prof is not None:
            prof.__exit__(None, None, None)
            from benchmark.trace import summarize

            summary = summarize(prof)
            del prof
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        program.close()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    written = runner.written
    sys.stderr.write(
        f"bytes written: inputs {written['inputs']} (warm-up included), outputs "
        f"{written['outputs']}, in all {written['inputs'] + written['outputs']} over "
        f"{len(jobs)} jobs\n")
    for rec in jobs:
        sys.stderr.write(f"job {rec['index']}: {rec['reads']} reads in {rec['wall']:.4f} s, "
                         f"timings {rec.get('timings')}, spans {rec.get('spans')}"
                         f"{', error ' + rec['error'] if rec.get('error') else ''}\n")

    nums, work, info = check.check(jobs, config, mix, args.seed, device)
    sys.stderr.write(f"compared: {info}\n")
    checks = check.within(nums, spec["limits"])
    failed = sum(1 for r in jobs if r.get("error"))
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    runrec = {"cell": spec["cell"]["name"], "config": config, "mix": mix, "setup_s": setup_s,
              "jobs": [r for r in jobs if not r.get("error")], "trace": summary,
              "work": work}
    wanted = spec["per_layer"] if traced else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(runrec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    where = {"platform": "gpu" if device.type == "cuda" else "cpu",
             "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
             "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": where}
    if summary is not None:
        from benchmark.trace import device_op_seconds, short_name

        where.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        gaps = sorted(summary["gaps"], key=lambda g: -g[1])[:10]
        result["breakdown"] = {
            "device_ops": [[short_name(n), s] for n, s in device_op_seconds(summary)[:10]],
            "idle_gaps": [[n, s] for n, s in gaps]}
    if device.type == "cuda":
        sys.stderr.write(f"card and power limit: {power_limit()}\n")
    result["checks"] = checks

    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        sys.stderr.write(f"the run loaded {', '.join(found)}: no result\n")
        return 3
    for name, c in checks.items():
        sys.stderr.write(f"check {name}: {c['value']!r} (limit {c['limit']!r})\n")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, rehearse: dict = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return run(ap.parse_args(argv), rehearse)


if __name__ == "__main__":
    raise SystemExit(main())
