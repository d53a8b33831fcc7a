"""Kernel-pipeline throughput of the flagship: reads/s of
``CudaEngine._full`` (K1, K2, K3 and the scoring epilogue) on the card.

The counterpart of ``bench.py``.  The flagship engine
(``entry.flagship_engine``), B = 16,384 seeded reads of 64 codes, 56 of them
read, staged on the card once; each trial enqueues a pipeline of NB = 16
batches and synchronises once at the end, after a warm-up batch and 2
priming batches.  Prints one JSON line: the median of the trials' reads/s,
their spread, and the card's name and power limit.  A kernel that fails to
build or launch ends the run non-zero.

    python -m tagdust_tpu_torch.bench.kernels [--device cpu] [--batch N]
        [--len L] [--batches NB] [--trials T]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def measure(device="cuda", B: int = 16384, L: int = 64, NB: int = 16,
            trials: int = 5) -> dict:
    """The bench's JSON record: ``trials`` timed pipelines of ``NB`` batches
    of ``B`` reads padded to ``L`` (lengths L - 8)."""
    from ..entry import flagship_engine
    from . import card

    eng = flagship_engine(device)
    dev = eng.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, L)).astype(np.uint8)).to(dev)
    lens = torch.full((B,), L - 8, dtype=torch.int32, device=dev)
    eng._full(seqs, lens)  # the kernels build and load here
    sync()
    for _ in range(2):  # prime the pipeline
        eng._full(seqs, lens)
    sync()
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        outs = [eng._full(seqs, lens) for _ in range(NB)]
        sync()
        times.append(time.perf_counter() - t0)
        del outs
    rates = sorted(NB * B / t for t in times)
    rps = rates[len(rates) // 2]
    return {
        "metric": "kernel-pipeline reads/s (CudaEngine._full: K1, K2, K3 and the "
                  "epilogue; flagship 20 x 6nt + R:N)",
        "value": rps, "unit": "reads/s", "trials": trials,
        "spread_pct": 100.0 * (rates[-1] - rates[0]) / rps,
        "batch": B, "length": L, "read_length": L - 8, "batches_per_trial": NB,
        "trial_seconds": times, **card(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels on the card) or cpu "
                    "(the plain versions)")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--len", dest="length", type=int, default=64)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.device, args.batch, args.length, args.batches,
                             args.trials)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
