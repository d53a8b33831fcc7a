#!/usr/bin/env python3
"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --jobs 3

For each seed, one set-up, then ``--jobs`` jobs of the cell as a run makes
them; for each seed it prints one JSON line with two sets of the numbers
``check.py`` compares:

* ``program``: the program's outputs against the reference (full float32);
* ``control``: the reference computed with its products' operands in TF32
  (``reference.scan.precision``), the nearest precision below the float32
  the configuration states, put in the program's place: its architecture
  pick, its threshold and its records of the sampled reads, against the
  same full-float32 reference.

The benchmark's own runs do not run it.  On the CPU
(``benchmark/tests/test_bench_control.py``) it runs through the program's plain
versions at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_jobs(jobs: list, config: dict, mix: dict, seed: int, device) -> list:
    """The jobs as the TF32 reference would have done them."""
    from benchmark import check
    from benchmark.reference import engine as R

    ref = R.Reference(device, tf32=True)
    out = []
    for job in jobs:
        if job.get("error") or job.get("got") is None:
            out.append(job)
            continue
        r = check.reference_job(ref, config, mix, job, seed)
        out.append(dict(job, got=r["records"], threshold=r["threshold"], arch=r["arch"]))
    return out


def readings(workload: str, seeds: list, n_jobs: int, rehearse: dict = None) -> list:
    """[{"seed", "walls", "program", "control"}] for each seed."""
    from benchmark import check
    from benchmark.harness import Jobs, setup
    from benchmark.program import Program
    from benchmark.run import cell_spec

    spec = cell_spec(workload)
    config, mix = spec["config"], spec["mix"]
    run_on = setup(spec, rehearse)
    device, n_reads = run_on["device"], run_on["reads_per_file"]
    program = Program(run_on["engine"], False)
    tmp = tempfile.mkdtemp(prefix="tagdust-control-")
    runner = Jobs(config, mix, program, tmp, run_on["check_reads_per_job"])
    rows = []
    try:
        runner.warm_up(seeds[0], run_on["warmup_reads"])
        for seed in seeds:
            path = runner.make_input(seed, 0, n_reads)
            jobs = runner.window(seed, n_reads, path, max_jobs=n_jobs)
            prog, _, pinfo = check.check(jobs, config, mix, seed, device)
            ctrl, _, cinfo = check.check(control_jobs(jobs, config, mix, seed, device),
                                         config, mix, seed, device)
            row = {"seed": seed, "walls": [j["wall"] for j in jobs],
                   "program": dict(prog, info=pinfo), "control": dict(ctrl, info=cinfo)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        program.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.jobs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
