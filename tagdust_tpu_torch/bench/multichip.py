"""Sharded scoring throughput: reads/s of ``ShardedScorer.run`` on the
flagship at 1, 2, 4 and 8 shards, and the scaling efficiency against 1.

The counterpart of ``bench_multichip.py``.  B = 16,384 seeded reads of 48
codes, 44 of them read; each shard count is run once to warm up, then timed
over ``--reps`` runs (each fetches its results, so each waits for the
cards).  The shards are this process's cards, cycled over the shards when
there are fewer (``entry.shard_devices``): on a one-card host N shards share
the card and no scaling is claimed.  One JSON line per shard count, naming
the card and its power limit.  ``--device cpu`` runs CPU shards through the
plain versions; nothing else leaves the card.

    python -m tagdust_tpu_torch.bench.multichip [--device cpu] [--batch N]
        [--len L] [--reps R] [--shards 1,2,4,8]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def measure(device="cuda", B: int = 16384, L: int = 48, reps: int = 3,
            shards=(1, 2, 4, 8)):
    """Yield one JSON record per shard count."""
    from ..entry import describe, flagship_engine, shard_devices
    from ..parallel.mesh import ShardedScorer
    from . import card

    eng = flagship_engine(device)
    where = card(eng.device)
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L - 4, dtype=np.int32)
    base = None
    for n in shards:
        devs = shard_devices(n, device)
        scorer = ShardedScorer(eng, devs)
        scorer.run(seqs, lens)  # warm-up
        t0 = time.perf_counter()
        for _ in range(reps):
            scorer.run(seqs, lens)
        rps = B * reps / (time.perf_counter() - t0)
        if n == 1:
            base = rps
        cards = len({d for d in devs if d.type == "cuda"})
        if devs[0].type == "cpu":
            note = f"{describe(devs)}: no scaling claimed"
        elif cards < n:
            on = "one card" if cards == 1 else f"{cards} cards"
            note = f"{n} shards on {on}: no scaling claimed"
        else:
            note = f"{describe(devs)}: one shard a card"
        yield {
            "devices": n, "cards": cards, "reads_per_s": rps,
            "scaling_efficiency": rps / (base * n) if base else None,
            "note": note, **where,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: this process's cards) or cpu")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--len", dest="length", type=int, default=48)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shards", default="1,2,4,8")
    args = ap.parse_args(argv)
    shards = [int(s) for s in args.shards.split(",")]
    for rec in measure(args.device, args.batch, args.length, args.reps, shards):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
