"""Entry points: the flagship engine, one batched scoring step, and a
dry run of the multi-shard paths.

The counterpart of ``__graft_entry__.py``:

* ``flagship_engine``: the flagship model (the 20 barcodes of 6nt of
  ``data/flagship_20x6nt.txt`` + ``R:N``) as a ``CudaEngine``; it raises if
  the file holds fewer than 20 barcodes;
* ``entry``: ``(fn, (seqs, lens))``, ``fn`` one batched scoring step of the
  production path (``CudaEngine._full``: K1, K2, K3 and the epilogue);
* ``dryrun_multichip``: ``ShardedScorer`` over n shards against the plain
  versions, the streaming labelling over the shards, and one Baum-Welch
  E-step over them with its re-estimation.

Everything runs on the card unless the caller passes ``device="cpu"``, which
runs the same code through the plain versions; without a card the card's
entry points raise.  Shards on the card are this process's cards
(``mesh.local_devices``), cycled when there are fewer than the shards asked
for: on a one-card host n shards share ``cuda:0``.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

FLAGSHIP_BARCODES = 20


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available (device='cpu' runs "
            "the plain versions on the CPU)")
    return d


def flagship_model():
    """The flagship ``ModelBag``: ``B:<20 barcodes>`` + ``R:N`` with the
    sequence stats of ``__graft_entry__._flagship_engine``."""
    from .arch import build_read_structure
    from .flagship import PATH, load_barcodes
    from .logsum import p2sp
    from .model import init_model_bag
    from .stats import SequenceStats

    bcs = load_barcodes(PATH)
    if len(bcs) < FLAGSHIP_BARCODES:
        raise RuntimeError(f"{PATH} gives {len(bcs)} barcodes, the flagship "
                           f"has {FLAGSHIP_BARCODES}")
    rs = build_read_structure([f"B:{','.join(bcs)}", "R:N"])
    ssi = SequenceStats()
    ssi.average_length = 50
    ssi.max_seq_len = 64
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(rs, ssi, 0.05, 0.1)


def flagship_engine(device="cuda"):
    """The flagship model's ``CudaEngine`` on ``device``."""
    from .engine.cuda import CudaEngine

    return CudaEngine(flagship_model(), resolve_device(device))


def entry(device="cuda"):
    """``(fn, (seqs, lens))``: ``fn(seqs, lens)`` is one batched scoring step
    of the flagship (``CudaEngine._full``) -> ``(f, r, bar, labels, q)``;
    the inputs are 256 seeded reads of 48 codes, 44 of them read, on the
    engine's device (the kernels on the card, the plain versions on the
    CPU)."""
    eng = flagship_engine(device)
    B, L = 256, 48
    rng = np.random.default_rng(0)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, L)).astype(np.uint8))
    lens = torch.full((B,), 44, dtype=torch.int32)
    return eng._full, (seqs.to(eng.device), lens.to(eng.device))


def shard_devices(n: int, device="cuda") -> list:
    """n shard devices: this process's cards cycled over the shards, or n
    CPU shards for ``device="cpu"``."""
    from .parallel.mesh import local_devices

    if resolve_device(device).type == "cpu":
        return [torch.device("cpu")] * n
    cards = local_devices()
    if not cards:
        raise RuntimeError("this process has no card (parallel.multihost.card_layout)")
    return [cards[i % len(cards)] for i in range(n)]


def describe(devs: list) -> str:
    """``2 shards on cuda:0``, ``4 shards on 4 cards``, ``2 CPU shards``."""
    cards = sorted({str(d) for d in devs})
    n = f"{len(devs)} {'CPU ' if devs[0].type == 'cpu' else ''}shard" + (
        "s" if len(devs) > 1 else "")
    if devs[0].type == "cpu":
        return n
    where = cards[0] if len(cards) == 1 else f"{len(cards)} cards ({', '.join(cards)})"
    return f"{n} on {where}"


def _stream_over_shards(eng, kind: str, devs: list, rng) -> None:
    """The streaming labelling (``runner._label_streaming``) of 48 reads a
    shard over ``devs``, in 3 windows of 2 tiles of 8 reads a shard, under
    TAGDUST_TPU_STRICT=1.  The environment and ``runner.local_devices`` are
    restored afterwards."""
    from .engine import runner as R
    from .io.batch import ReadBatch
    from .io.fastq import Read

    n = len(devs)
    keys = ("TAGDUST_TPU_BT", "TAGDUST_TPU_WINDOW", "TAGDUST_TPU_STRICT")
    saved = {k: os.environ.get(k) for k in keys}
    real_devices = R.local_devices
    os.environ.update(TAGDUST_TPU_BT="8", TAGDUST_TPU_WINDOW=str(8 * n * 2),
                      TAGDUST_TPU_STRICT="1")
    R.local_devices = lambda: list(devs)
    try:
        Bs = 8 * n * 6
        reads = [Read(name=f"r{i}",
                      seq=rng.integers(0, 4, 24 + (i % 9)).astype(np.uint8),
                      qual="I" * (24 + (i % 9)))
                 for i in range(Bs)]
        batch = ReadBatch.from_reads(reads)
        param = SimpleNamespace(engine=kind, rtest=False, matchstart=-1,
                                matchend=-1, minlen=10, dust=0, num_threads=4)
        before = dict(R.STREAM_STATS)
        streamed = R._label_streaming(eng.mb, eng.mb.rs, batch, param, 10.0, kind)
        windows = R.STREAM_STATS["windows"] - before["windows"]
        failed = (R.STREAM_STATS["oneshot_after_failure"]
                  - before["oneshot_after_failure"])
        _require(streamed and not failed,
                 "the streaming labelling over the shards did not run")
        _require(windows == 3, f"{windows} streaming windows, not 3")
        _require(bool(np.isfinite(batch.mapq).all()), "a streamed Q is not finite")
        _require(batch.read_type.shape[0] == Bs, "reads lost in streaming")
    finally:
        R.local_devices = real_devices
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One scoring step, the streaming labelling and one Baum-Welch E-step of
    the flagship over ``n_devices`` shards (``shard_devices``); prints
    ``dryrun_multichip ok: ...`` or raises."""
    from .engine import runner as R
    from .engine.train import reestimate
    from .parallel.mesh import DistributedTrainer, ShardedScorer

    devs = shard_devices(n_devices, device)
    kind = "torch" if devs[0].type == "cpu" else "cuda"
    # built through the runner's cache, so that the streaming step finds it
    eng = R.get_engine(flagship_model(), kind)
    B, L = 8 * n_devices, 32
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, 28, dtype=np.int32)

    # the production scoring step, sharded
    out, counts = ShardedScorer(eng, devs).run(seqs, lens, threshold=1.0)
    _require(int(counts.sum()) == B, f"counts {counts.tolist()} do not sum to {B}")

    # the same shards through the plain versions (the scan engine on the
    # CPU) must agree; slot 0 of the labels is the pre-read slot
    host = eng.on("cpu")
    per = B // n_devices
    plain = [host.run_batch(seqs[i * per : (i + 1) * per], lens[i * per : (i + 1) * per])
             for i in range(n_devices)]
    mq = np.concatenate([p.mapq for p in plain])
    lab = np.concatenate([p.labels for p in plain])
    err = float(np.abs(out.mapq - mq).max())
    _require(err <= 1e-2, f"Q differs from the plain versions by {err}")
    _require(bool((out.labels[:, 1 : L + 1].astype(np.int32)
                   == lab[:, 1 : L + 1].astype(np.int32)).all()),
             "label paths differ from the plain versions")

    _stream_over_shards(eng, kind, devs, rng)

    # Baum-Welch over the shards, then the re-estimation
    trainer = DistributedTrainer(eng, devs)
    _, E, total = trainer.run(seqs, lens)
    _require(total == int(lens.sum()), f"{total} bases counted of {int(lens.sum())}")
    _require(abs(float(E.sum()) - total) / total < 1e-3,
             f"E.sum {float(E.sum())} is not the {total} bases scored")
    mb2 = reestimate(eng.mb, trainer.expected_segment_counts(seqs, lens))
    _require(mb2.num_models == eng.mb.num_models, "re-estimation lost segments")
    print(f"dryrun_multichip ok: {describe(devs)}, counts={counts.tolist()}, "
          f"train E.sum={float(E.sum()):.1f} (= {total} emitted bases), "
          f"reestimated {mb2.num_models} segments", flush=True)
