"""Engine choice, the calibration scorer and the streaming decided labelling.

The device half of ``tagdust_tpu/engine/runner.py``, ported to
``CudaEngine``.  The host half is imported from there unchanged: length
rungs (``_choose_rungs``), batch padding (``_pad_tpu_batch``), the exact
engine's columnar scorer and the exact ``run_get_prob``.

Engine kinds: ``cuda`` (the hand-written kernels on the card; raises without
one), ``torch`` (the same pipeline on CPU tensors through the plain
versions), ``exact`` (the shared C-parity engine) and ``auto`` (``cuda``
when a card is present, else ``exact``; ``-rtest`` pins ``exact``).
"""

from __future__ import annotations

import os
import sys
from collections import deque

import numpy as np
import torch

from tagdust_tpu.constants import EXTRACT_FAIL_LOW_COMPLEXITY, EXTRACT_SUCCESS
from tagdust_tpu.engine import runner as host_runner
from tagdust_tpu.engine.runner import _choose_rungs, _pad_tpu_batch
from tagdust_tpu.model import ModelBag

from .decided import collect_decided

DEVICE_KINDS = ("cuda", "torch")
KINDS = ("auto", "exact") + DEVICE_KINDS

_ENGINE_CACHE: dict = {}

# streaming windows labelled by the decided-mode loop since the last reset
STREAM_STATS = {"windows": 0}


def resolve_engine(param) -> str:
    """Map ``-engine {auto,exact,cuda,torch}`` to a concrete kind."""
    eng = getattr(param, "engine", "auto")
    if eng not in KINDS:
        raise ValueError(
            f"-engine {eng}: this package takes one of {', '.join(KINDS)}"
        )
    if eng == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-engine cuda: no CUDA device is available")
    if eng == "auto":
        if getattr(param, "rtest", False) or not torch.cuda.is_available():
            return "exact"
        return "cuda"
    return eng


def get_engine(mb: ModelBag, kind: str):
    """Engines are cached by model content and step-mode switch, so
    calibration and production (and back-to-back runs) share one set of
    device tables."""
    dig = getattr(mb, "_digest_cache", None)
    if dig is None:
        dig = mb._digest_cache = mb.digest()
    key = (dig, kind, os.environ.get("TAGDUST_TPU_GROUPED", "auto"))
    if key not in _ENGINE_CACHE:
        if kind in DEVICE_KINDS:
            from .cuda import CudaEngine

            _ENGINE_CACHE[key] = CudaEngine(mb, "cuda" if kind == "cuda" else "cpu")
        else:
            _ENGINE_CACHE[key] = host_runner.get_engine(mb, "exact")
    return _ENGINE_CACHE[key]


def run_get_prob(mb: ModelBag, seq_list, engine_kind: str = "exact") -> np.ndarray:
    """MODE_GET_PROB for calibration: Q per raw sequence, on the engine
    production scores with."""
    if engine_kind not in DEVICE_KINDS:
        return host_runner.run_get_prob(mb, seq_list, engine_kind="exact")
    B = len(seq_list)
    if not B:
        return np.zeros(0, dtype=np.float32)
    eng = get_engine(mb, engine_kind)
    lens = np.fromiter((s.shape[0] for s in seq_list), dtype=np.int32, count=B)
    ladder = _choose_rungs(lens)
    bucket_of = np.searchsorted(np.asarray(ladder), lens)
    mapq = np.empty(B, dtype=np.float32)
    for b, Lp in enumerate(ladder):
        idxs = np.nonzero(bucket_of == b)[0]
        if idxs.size == 0:
            continue
        sq = np.zeros((idxs.size, Lp), dtype=np.uint8)
        for bi, i in enumerate(idxs):
            s = seq_list[int(i)]
            sq[bi, : s.shape[0]] = s
        pseqs, plens = _pad_tpu_batch(sq, lens[idxs])
        res = eng.run_batch_fused(pseqs, plens, want_labels=False)
        mapq[idxs] = res.mapq[: idxs.size]
    return mapq


def _score_batch_columnar(mb, batch, matchstart, matchend, kind):
    """One-shot scoring of a columnar ReadBatch on the device engine; fills
    batch.mapq and returns the [B, Lpad+1] label matrix."""
    from tagdust_tpu.io.batch import padded_matrix

    B = batch.B
    full_lens = batch.lens
    if matchstart != -1 or matchend != -1:
        dec = np.full(B, matchend - matchstart, dtype=np.int64)
        w = np.clip(np.minimum(full_lens, matchend) - matchstart, 0, None)
        off = batch.seq_off[:-1] + matchstart
        pos = np.arange(int(dec.max(initial=1)), dtype=np.int64)[None, :]
        cap = max(batch.seq_arena.shape[0] - 1, 0)
        seqs = batch.seq_arena[np.minimum(off[:, None] + pos, cap)].copy()
        seqs[pos >= w[:, None]] = 0
        lens = dec.astype(np.int32)
    else:
        Lmax = int(full_lens.max(initial=1))
        seqs = padded_matrix(batch.seq_arena, batch.seq_off, full_lens, Lmax, 0)
        lens = full_lens.astype(np.int32)
    seqs, lens = _pad_tpu_batch(seqs, lens)
    res = get_engine(mb, kind).run_batch_fused(seqs, lens, want_labels=True)
    batch.mapq[:] = res.mapq[:B].astype(np.float64)
    return res.labels[:B]


def _label_streaming(mb, rs, batch, param, confidence_threshold, kind) -> bool:
    """Pipelined decided-mode labelling: windows of at most 16,384 reads,
    up to DEPTH in flight; the host applies window k's decisions while the
    device scores k+1..k+DEPTH.  Returns False when the decided-mode gate is
    off or the chunk fits one window (the caller labels it one-shot)."""
    from tagdust_tpu.extract import apply_device_decisions
    from tagdust_tpu.io.batch import padded_matrix

    B = batch.B
    if param.matchstart != -1 or param.matchend != -1:
        return False
    eng = get_engine(mb, kind)
    rfl = eng.required_finger_len()
    if rfl > 27:
        return False
    full_lens = batch.lens
    Lpad = max((int(full_lens.max(initial=1)) + 31) // 32 * 32, 32)
    DEPTH = max(int(os.environ.get("TAGDUST_TPU_PIPELINE_DEPTH", "3")), 1)
    BT = eng.default_batch_tile()
    W = eng.STACK_BYTES // DEPTH // eng.stack_bytes_per_read(Lpad)
    W = int(min(max(W // BT * BT, BT), 16384))
    wenv = os.environ.get("TAGDUST_TPU_WINDOW")
    if wenv:
        W = max(int(wenv) // BT * BT, BT)
    if B <= W:
        return False

    thr32 = eng.threshold_f32_ceil(confidence_threshold)
    minlen = int(param.minlen)
    on_card = eng.device.type == "cuda"
    dust_dev = np.empty((B, 2), dtype=np.float32)
    inflight: deque = deque()  # enqueued on the device
    ready: deque = deque()  # device->host copy enqueued
    consumed = [0]

    def _window(s: int, e: int):
        seqs = padded_matrix(
            batch.seq_arena, batch.seq_off[s : e + 1], full_lens[s:e], Lpad, 0
        )
        lens_w = full_lens[s:e].astype(np.int32)
        return eng._pad(seqs, lens_w, BT)

    def _fetch(rows):
        if not on_card:
            return rows, None
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _extract(s, e, host, ev):
        if ev is not None:
            ev.synchronize()
        consumed[0] += 1
        res = collect_decided(host.numpy(), e - s, Lpad)
        dust_dev[s:e] = res["dust"]
        apply_device_decisions(batch.slice(s, e), res, rfl)
        STREAM_STATS["windows"] += 1

    def _stage():
        # start the oldest window's copy, then extract the window before it,
        # whose copy has been in flight meanwhile
        s, e, rows = inflight.popleft()
        ready.append((s, e) + _fetch(rows))
        if len(ready) > 1:
            _extract(*ready.popleft())

    try:
        for s in range(0, B, W):
            e = min(s + W, B)
            seqs, lens_w = _window(s, e)
            inflight.append((s, e, eng.dispatch_decided(seqs, lens_w, thr32, minlen)))
            if len(inflight) >= DEPTH:
                _stage()
        while inflight:
            _stage()
        while ready:
            _extract(*ready.popleft())
    except Exception as exc:
        if consumed[0]:
            # extracted windows have scattered spacers into the arenas: a
            # re-score would read mutated sequences
            raise
        # nothing extracted yet: the caller re-labels the chunk one-shot on
        # the same engine and kernels (a broken kernel raises there)
        sys.stderr.write(
            f"[tagdust_tpu_torch] WARNING: streaming labelling failed before "
            f"its first window ({type(exc).__name__}: {exc}); labelling the "
            "chunk one-shot\n"
        )
        return False
    batch.dust_device = dust_dev
    return True


def run_get_label_batch(mb, rs, batch, param, confidence_threshold,
                        contaminants=None) -> None:
    """MODE_GET_LABEL over a columnar ReadBatch (the production hot path)."""
    from tagdust_tpu.extract import extract_batch_columnar
    from tagdust_tpu.filters import dust_batch_columnar, match_to_reference_columnar

    kind = resolve_engine(param)
    if kind not in DEVICE_KINDS:
        host_runner.run_get_label_batch(
            mb, rs, batch, param, confidence_threshold, contaminants
        )
        return
    batch.dust_device = None
    if not _label_streaming(mb, rs, batch, param, confidence_threshold, kind):
        labels = _score_batch_columnar(
            mb, batch, param.matchstart, param.matchend, kind
        )
        extract_batch_columnar(
            mb, rs, batch, labels, param.minlen, confidence_threshold,
            param.matchstart, param.matchend,
        )
    # the dust filter sees the extracted sequence for successes, the raw one
    # for rejects: captured before the artifact filter rewrites read_type
    was_success = batch.read_type == EXTRACT_SUCCESS
    if contaminants is not None:
        # host Myers: the device artifact filter is not ported yet
        match_to_reference_columnar(
            batch, contaminants, param.filter_error, device=False
        )
    if param.dust:
        dd = batch.dust_device
        if dd is not None:
            score = np.where(was_success, dd[:, 0], dd[:, 1])
            with np.errstate(invalid="ignore"):
                batch.read_type[score > param.dust] = EXTRACT_FAIL_LOW_COMPLEXITY
        else:
            dust_batch_columnar(batch, param.dust)
