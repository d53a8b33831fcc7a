#!/usr/bin/env python3
"""Where the time goes in the main paths of tagdust_tpu_torch, on one CUDA card.

    python3 profile_smoke.py [--seed N] [--reads N] [--out DIR] [--paths P,...]

For the flagship (``-1 B:<20 x 6nt> -2 R:N``), the ``-arch`` run over a
96-plex FASTQ (the candidates of ``chip_smoke.py``) and the flagship's
``-ref`` run (``chip_smoke.py``'s contaminants, 5% of the reads planted,
``-fe 8``; it also prints the artifact filter's host and device seconds),
each on a FASTQ that ``chip_smoke.write_fastq`` generates: one warm-up run (host libraries and
kernels built), two unprofiled runs (wall, detection and calibration from
``controller.TIMINGS``), then one run under ``torch.profiler``.  Prints the
device time and launches of every device op of the profiled run, the
device's busy time (the union of its op intervals) against that run's wall,
and the card's name and power limit; writes each path's
``key_averages`` table to ``DIR/<path>.txt`` (default ``build/profile``,
git-ignored).  ``--paths train`` (not run by default) profiles one
Baum-Welch EM iteration over the flagship reads and the plate's E-step
alone the same way (its unprofiled runs print the trainer's split).
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
    from tagdust_tpu_torch import controller, spans

    def run(k: int) -> float:
        spans.reset()
        return cs.run_tagdust([*args, "-o", os.path.join(tmp, f"{name}_{k}"),
                               "-engine", "cuda"])

    def report(k: int, wall: float) -> None:
        print(f"[{name}] unprofiled run {k}: {wall:.2f} s wall, detection "
              f"{controller.TIMINGS['detection']:.2f} s, calibration "
              f"{controller.TIMINGS['calibration']:.2f} s", flush=True)
        if "-ref" in args:
            rt = spans.TIMINGS
            print(f"[{name}]   artifact filter, {rt['ref.gather.calls']} calls: host "
                  f"gather {rt['ref.gather']:.2f} s, host masks {rt['ref.masks']:.2f} s, "
                  f"device (upload, td_myers, fetch) {rt['ref.lanes']:.2f} s", flush=True)

    profile_runs(name, run, report, out_dir)


def profile_train(seed: int, n_reads: int, out_dir: str) -> None:
    """One EM iteration over ``n_reads`` generated flagship reads
    (``DistributedTrainer.expected_segment_counts``, then ``reestimate``;
    the reads of ``chip_smoke.py``'s train phase), and the plate's E-step
    alone on the kernels phase's 16,384 reads (K1's stack given)."""
    import numpy as np
    import torch

    from tagdust_tpu_torch import spans
    from tagdust_tpu_torch.engine.cuda import CudaEngine
    from tagdust_tpu_torch.engine.train import reestimate
    from tagdust_tpu_torch.parallel import mesh

    sets = cs.barcode_sets()
    seqs, lens = cs.read_codes(n_reads, seed + 5, sets["flagship"])
    eng = CudaEngine(cs.library_model(sets["flagship"]), "cuda")
    trainer = mesh.DistributedTrainer(eng)

    def em(k: int) -> float:
        spans.reset()
        t0 = time.perf_counter()
        reestimate(eng.mb, trainer.expected_segment_counts(seqs, lens))
        return time.perf_counter() - t0

    def em_report(k: int, wall: float) -> None:
        t = spans.TIMINGS
        print(f"[train] unprofiled run {k}: {wall:.2f} s wall, K1 {t['mesh.backward']:.2f} "
              f"s, E-step {t['mesh.estep']:.2f} s, host mapping {t['mesh.map']:.2f} s",
              flush=True)

    profile_runs("train", em, em_report, out_dir)
    del eng, trainer
    plate = CudaEngine(cs.library_model(sets["plate"]), "cuda")
    rng = np.random.default_rng(seed)
    B, Lp = 16384, 64
    s = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    ln = torch.from_numpy(rng.integers(40, Lp + 1, B).astype(np.int32)).cuda()
    stack = plate.scorer.backward(s, ln)
    tab = mesh.count_tables(plate.lat, "cuda")

    def estep(k: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh._expected_lattice_counts(plate, s, ln, stack=stack, tables=tab)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    profile_runs("estep-plate", estep,
                 lambda k, wall: print(f"[estep-plate] unprofiled run {k}: "
                                       f"{wall * 1e3:.1f} ms wall", flush=True), out_dir)


def profile_runs(name: str, run, report, out_dir: str) -> None:
    """One warm-up ``run(0)``, two reported unprofiled runs, then one under
    torch.profiler: its wall, the device's busy share and the device time
    and launches of its longest ops; the key_averages table goes to
    ``out_dir/<name>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(0)
    for k in (1, 2):
        report(k, run(k))
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
    ap.add_argument("--paths", default="flagship,arch,ref",
                    help="of flagship, arch, ref and train (one EM iteration, "
                    "then the plate's E-step alone)")
    args = ap.parse_args()
    paths = args.paths.split(",")

    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    sets = cs.barcode_sets()
    tmp = tempfile.mkdtemp(prefix="tagdust_profile_")
    try:
        flagship = ["-1", f"B:{','.join(sets['flagship'])}", "-2", "R:N"]
        if "flagship" in paths:
            fq = os.path.join(tmp, "flagship.fq")
            cs.write_fastq(fq, args.reads, args.seed, sets["flagship"])
            profile_path("flagship", [*flagship, fq], tmp, args.out)
            os.remove(fq)
        if "arch" in paths:
            fq = os.path.join(tmp, "plate.fq")
            cs.write_fastq(fq, args.reads, args.seed + 1, sets["plate"])
            profile_path("arch", ["-arch", cs.write_candidates(tmp, sets), fq], tmp,
                         args.out)
            os.remove(fq)
        if "ref" in paths:
            texts = cs.contaminant_texts(args.seed)
            fq = os.path.join(tmp, "ref.fq")
            cs.write_fastq(fq, args.reads, args.seed + 3, sets["flagship"], plant=texts)
            fa = cs.write_contaminants(tmp, texts)[0]
            profile_path("ref", [*flagship, fq, "-ref", fa, "-fe", str(cs.REF_FE)],
                         tmp, args.out)
        if "train" in paths:
            profile_train(args.seed, args.reads, args.out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"times above on: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"profile_smoke: {time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
