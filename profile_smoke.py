#!/usr/bin/env python3
"""Where the time goes in two main paths of tagdust_tpu_torch, on one CUDA card.

    python3 profile_smoke.py [--seed N] [--reads N] [--out DIR]

For the flagship (``-1 B:<20 x 6nt> -2 R:N``) and the ``-arch`` run over a
96-plex FASTQ (the candidates of ``chip_smoke.py``), each on a FASTQ that
``chip_smoke.write_fastq`` generates: one warm-up run (host libraries and
kernels built), two unprofiled runs (wall, detection and calibration from
``controller.TIMINGS``), then one run under ``torch.profiler``.  Prints the
device time and launches of every device op of the profiled run, the
device's busy time (the union of its op intervals) against that run's wall,
and the card's name and power limit; writes each path's
``key_averages`` table to ``DIR/<path>.txt`` (default ``build/profile``,
git-ignored).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import chip_smoke as cs


def device_key(prof) -> str:
    """The name of the self device time field (``cuda`` in older torch)."""
    ev = prof.key_averages()
    return ("self_device_time_total" if hasattr(ev[0], "self_device_time_total")
            else "self_cuda_time_total")


def device_ops(prof) -> list:
    """(name, device seconds, launches) of every op that ran on the device,
    longest first."""
    key = device_key(prof)
    rows = [(e.key, getattr(e, key) / 1e6, e.count) for e in prof.key_averages()
            if getattr(e, key) > 0]
    return sorted(rows, key=lambda r: -r[1])


def busy_seconds(prof) -> float:
    """The union of the device ops' intervals, in seconds."""
    from torch.autograd import DeviceType

    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in iv:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e6


def profile_path(name: str, args, tmp: str, out_dir: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tagdust_tpu_torch import controller

    def run(k: int) -> float:
        return cs.run_tagdust([*args, "-o", os.path.join(tmp, f"{name}_{k}"),
                               "-engine", "cuda"])

    run(0)
    for k in (1, 2):
        wall = run(k)
        print(f"[{name}] unprofiled run {k}: {wall:.2f} s wall, detection "
              f"{controller.TIMINGS['detection']:.2f} s, calibration "
              f"{controller.TIMINGS['calibration']:.2f} s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run(3)
        torch.cuda.synchronize()
    busy = busy_seconds(prof)
    print(f"[{name}] profiled run: {wall:.2f} s wall, device busy {busy:.2f} s "
          f"(idle {1 - busy / wall:.1%})", flush=True)
    for op, sec, n in device_ops(prof)[:12]:
        print(f"[{name}]   {sec:8.3f} s {n:6d} x  {op[:90]}", flush=True)
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by=device_key(prof), row_limit=60))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    sets = cs.barcode_sets()
    tmp = tempfile.mkdtemp(prefix="tagdust_profile_")
    try:
        fq = os.path.join(tmp, "flagship.fq")
        cs.write_fastq(fq, args.reads, args.seed, sets["flagship"])
        profile_path("flagship", ["-1", f"B:{','.join(sets['flagship'])}", "-2",
                                  "R:N", fq], tmp, args.out)
        os.remove(fq)
        fq = os.path.join(tmp, "plate.fq")
        cs.write_fastq(fq, args.reads, args.seed + 1, sets["plate"])
        profile_path("arch", ["-arch", cs.write_candidates(tmp, sets), fq], tmp,
                     args.out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"times above on: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"profile_smoke: {time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
