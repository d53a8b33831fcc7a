"""Engine choice, the calibration scorer and the streaming decided labelling.

The counterpart of ``tagdust_tpu/engine/runner.py``: its device half ported
to ``CudaEngine``, and its host helpers copied (length rungs
``_choose_rungs``, batch padding ``_pad_tpu_batch``, ``thread_slices``,
``run_rna_dust_batch``, and the exact engine's scorers behind
``get_engine``, ``run_get_prob`` and the columnar labelling).

Engine kinds: ``cuda`` (the hand-written kernels on the card), ``torch``
(the same pipeline on CPU tensors through the plain versions), ``exact``
(the C-parity host engine) and ``auto``, the default: ``cuda``, and so it
raises without a card, as ``-engine cuda`` does; ``-rtest`` pins ``exact``,
the reference-parity mode.  The CPU runs only when the caller names
``torch`` or ``exact``.
"""

from __future__ import annotations

import itertools
import os
import sys
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from ..constants import EXTRACT_FAIL_LOW_COMPLEXITY, EXTRACT_SUCCESS
from ..extract import compute_q
from ..io.fastq import Read
from ..model import ModelBag
from ..parallel.mesh import local_devices
from .cuda import BatchResult
from .decided import collect_decided
from .exact import ExactEngine

DEVICE_KINDS = ("cuda", "torch")
KINDS = ("auto", "exact") + DEVICE_KINDS

_ENGINE_CACHE: dict = {}

# streaming windows labelled since the last reset, and chunks whose streaming
# failed before its first window and went to the one-shot path
STREAM_STATS = {"windows": 0, "oneshot_after_failure": 0}


def resolve_engine(param) -> str:
    """Map ``-engine {auto,exact,cuda,torch}`` to a concrete kind: ``auto``
    is ``cuda`` (``exact`` under ``-rtest``); ``cuda`` raises without a
    card."""
    eng = getattr(param, "engine", "auto")
    if eng not in KINDS:
        raise ValueError(
            f"-engine {eng}: this package takes one of {', '.join(KINDS)}"
        )
    if eng == "auto":
        eng = "exact" if getattr(param, "rtest", False) else "cuda"
    if eng == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"-engine {getattr(param, 'engine', 'auto')}: no CUDA device is "
            "available (-engine torch or exact runs on the CPU)"
        )
    return eng


def thread_slices(numseq: int, num_threads: int) -> List[tuple]:
    """barcode_hmm.c:1911-1922."""
    interval = int(float(numseq) / float(num_threads))
    slices = [(t * interval, t * interval + interval) for t in range(num_threads)]
    s, _ = slices[-1]
    slices[-1] = (s, numseq)
    return slices


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
            _ENGINE_CACHE[key] = ExactEngine(mb)
    return _ENGINE_CACHE[key]


def _mesh_scorer(eng, B: int, Lp: int, budget: int = None, packed: bool = False):
    """The cached ``ShardedScorer`` of ``eng`` over this process's devices of
    the engine's type (``local_devices``), or None: with fewer than two,
    when B reads do not give every shard a batch tile, when a shard of one
    tile would not fit its share of ``budget`` (default ``stack_budget()``) at
    Lp, or under TAGDUST_TPU_MESH=0 (the counterpart of JAX
    ``runner.py:_mesh_scorer``).  With one card nothing changes."""
    if os.environ.get("TAGDUST_TPU_MESH", "1") == "0":
        return None
    devs = [d for d in local_devices() if d.type == eng.device.type]
    BT = eng.default_batch_tile()
    if len(devs) < 2 or B < len(devs) * BT:
        return None
    cache = eng.__dict__.setdefault("_mesh_scorers", {})
    key = tuple(devs)
    if key not in cache:
        from ..parallel.mesh import ShardedScorer

        cache[key] = ShardedScorer(eng, devs)
    scorer = cache[key]
    if scorer.shard_reads(Lp, budget or eng.stack_budget(), packed) < BT:
        return None
    return scorer


def _run_sharded(scorer, seqs: np.ndarray, lens: np.ndarray, want_labels: bool):
    """One padded batch over the shards, in sub-batches whose shards stay
    inside their share of their card's ``STACK_BYTES`` (JAX
    ``runner.py:_run_sharded``: the budget times the cards)."""
    eng = scorer.engine
    B, Lp = seqs.shape
    BT = eng.default_batch_tile()
    step = scorer.shard_reads(Lp, eng.stack_budget()) // BT * BT * scorer.n
    parts = [scorer.run(seqs[s : s + step], lens[s : s + step],
                        want_labels=want_labels)[0]
             for s in range(0, B, step)]
    cat = lambda f: (  # noqa: E731
        None if getattr(parts[0], f) is None
        else np.concatenate([getattr(p, f) for p in parts]))
    return BatchResult(cat("f_score"), cat("r_score"), cat("bar_prob"),
                       cat("labels"), cat("mapq"))


def _pad_tpu_batch(seqs: np.ndarray, lens_arr: np.ndarray):
    """Pad [B, L] inputs: length bucketed to multiples of 32, batch to
    powers of two up to 32k then 32k granules.  Pad rows are copies of read
    0 (zero rows can be impossible reads -> a deliberate NaN Q)."""
    B, L = seqs.shape
    Lpad = max(((L + 31) // 32) * 32, 32)
    if B <= 32768:
        Bpad = 1 << max(8, (B - 1).bit_length())
    else:
        Bpad = ((B + 32767) // 32768) * 32768
    out = np.zeros((Bpad, Lpad), dtype=np.uint8)
    out[:B, :L] = seqs
    lens = np.ones(Bpad, dtype=np.int32)
    lens[:B] = lens_arr
    if Bpad > B:
        out[B:] = out[0]
        lens[B:] = lens[0]
    return out, lens


# padded-length ladder of the device scorer's calibration buckets
_LEN_LADDER = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
               3072, 4096)


def _choose_rungs(lens: np.ndarray) -> list:
    """Pick <= TAGDUST_TPU_LEN_BUCKETS ladder rungs covering every length,
    minimizing sum(padded length): the DP compute is linear in the padded
    length.  The rung covering the max length is always included."""
    Lmax = int(lens.max(initial=1))
    top = int(np.searchsorted(_LEN_LADDER, max(Lmax, 1)))
    if top >= len(_LEN_LADDER):
        return [((Lmax + 31) // 32) * 32]
    cands = [lp for lp in _LEN_LADDER[: top + 1] if lp >= int(lens.min())]
    # covering invariant: _LEN_LADDER[top] >= Lmax >= lens.min(), so the
    # top rung always survives the filter
    assert cands, "length ladder must cover lens.min()"
    max_b = max(1, int(os.environ.get("TAGDUST_TPU_LEN_BUCKETS", "3")))
    if len(cands) <= max_b:
        return cands
    # exact padded-base cost per candidate subset via per-rung counts
    idx = np.searchsorted(np.asarray(cands), lens)
    cnt = np.bincount(idx, minlength=len(cands)).astype(np.int64)
    best, best_cost = None, None
    last = len(cands) - 1
    for sub in itertools.combinations(range(last), max_b - 1):
        chosen = list(sub) + [last]
        cost = 0
        j = 0
        for i in range(len(cands)):
            while chosen[j] < i:
                j += 1
            cost += int(cnt[i]) * cands[chosen[j]]
        if best_cost is None or cost < best_cost:
            best, best_cost = chosen, cost
    return [cands[i] for i in best]


def _build_batches(reads: List[Read]):
    """Group read indices by length; build [B, L+1] buffers with the
    position after the read (terminator 'A'), as the backward pass reads
    it."""
    buckets: Dict[int, List[int]] = {}
    for idx, r in enumerate(reads):
        buckets.setdefault(r.len, []).append(idx)
    out = []
    for L, idxs in buckets.items():
        seqs = np.zeros((len(idxs), L + 1), dtype=np.uint8)
        for bi, idx in enumerate(idxs):
            seqs[bi, : reads[idx].len] = reads[idx].seq
        out.append((L, idxs, seqs))
    return out


def _run_get_prob_exact(mb: ModelBag, seq_list) -> np.ndarray:
    """Q per raw sequence on the exact engine, bucketed by length."""
    reads = [Read(seq=s) for s in seq_list]
    eng = get_engine(mb, "exact")
    mapq = np.empty(len(reads), dtype=np.float32)
    for L, idxs, seqs in _build_batches(reads):
        if L <= 0:
            mapq[idxs] = np.nan
            continue
        res = eng.run_batch(seqs, L)
        mapq[idxs] = compute_q(res.f_score, res.r_score, res.bar_prob)
    return mapq


def run_get_prob(mb: ModelBag, seq_list, engine_kind: str = "exact") -> np.ndarray:
    """MODE_GET_PROB for calibration: Q per raw sequence, on the engine
    production scores with."""
    if engine_kind not in DEVICE_KINDS:
        return _run_get_prob_exact(mb, seq_list)
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
        scorer = _mesh_scorer(eng, *pseqs.shape)
        res = (_run_sharded(scorer, pseqs, plens, want_labels=False) if scorer
               else eng.run_batch_fused(pseqs, plens, want_labels=False))
        mapq[idxs] = res.mapq[: idxs.size]
    return mapq


def _score_batch_exact(mb, batch, matchstart, matchend):
    """Score a columnar ReadBatch on the exact engine, in batches of one
    length gathered from the arena; fills batch.mapq and returns the
    [B, Lmax+1] label matrix."""
    B = batch.B
    full_lens = batch.lens
    sub = matchstart != -1 or matchend != -1
    eng = get_engine(mb, "exact")
    dec_lens = (
        np.full(B, matchend - matchstart, dtype=np.int64) if sub else full_lens
    )
    Lmax = int(dec_lens.max(initial=0))
    labels_out = np.zeros((B, Lmax + 1), dtype=np.int32)
    cap = max(batch.seq_arena.shape[0] - 1, 0)
    order = np.argsort(dec_lens, kind="stable")
    uls, starts = np.unique(dec_lens[order], return_index=True)
    bounds = list(starts) + [B]
    for k, L in enumerate(uls):
        idxs = order[bounds[k] : bounds[k + 1]]
        L = int(L)
        if L <= 0:
            batch.mapq[idxs] = float("nan")
            continue
        # [Bb, L+1] window incl. the position after the subsequence
        # (terminator or next char), as read by the backward pass
        base = batch.seq_off[:-1][idxs] + (matchstart if sub else 0)
        if sub:
            vlen = np.clip(
                np.minimum(full_lens[idxs], matchend + 1) - matchstart, 0, None
            )
        else:
            vlen = full_lens[idxs]
        pos = np.arange(L + 1, dtype=np.int64)[None, :]
        seqs_b = batch.seq_arena[np.minimum(base[:, None] + pos, cap)].copy()
        seqs_b[pos >= vlen[:, None]] = 0
        res = eng.run_batch(seqs_b, L)
        q = compute_q(res.f_score, res.r_score, res.bar_prob)
        batch.mapq[idxs] = q.astype(np.float64)
        labels_out[idxs, : L + 1] = res.labels
    return labels_out


def _subrange_matrix(batch, s: int, e: int, matchstart: int, matchend: int,
                     width: int) -> np.ndarray:
    """[e - s, width] uint8: positions matchstart..matchend of reads s..e
    gathered from the arena, 0 past the window or the read's end."""
    full_lens = batch.lens[s:e]
    off = batch.seq_off[s:e] + matchstart
    w = np.clip(np.minimum(full_lens, matchend) - matchstart, 0, None)
    pos = np.arange(width, dtype=np.int64)[None, :]
    cap = max(batch.seq_arena.shape[0] - 1, 0)
    seqs = batch.seq_arena[np.minimum(off[:, None] + pos, cap)].copy()
    seqs[pos >= w[:, None]] = 0
    return seqs


def _score_batch_columnar(mb, batch, matchstart, matchend, kind):
    """One-shot scoring of a columnar ReadBatch; fills batch.mapq and
    returns the [B, Lpad+1] label matrix."""
    from ..io.batch import padded_matrix

    if kind not in DEVICE_KINDS:
        return _score_batch_exact(mb, batch, matchstart, matchend)
    B = batch.B
    full_lens = batch.lens
    if matchstart != -1 or matchend != -1:
        seqs = _subrange_matrix(batch, 0, B, matchstart, matchend,
                                matchend - matchstart if B else 1)
        lens = np.full(B, matchend - matchstart, dtype=np.int32)
    else:
        Lmax = int(full_lens.max(initial=1))
        seqs = padded_matrix(batch.seq_arena, batch.seq_off, full_lens, Lmax, 0)
        lens = full_lens.astype(np.int32)
    seqs, lens = _pad_tpu_batch(seqs, lens)
    eng = get_engine(mb, kind)
    scorer = _mesh_scorer(eng, *seqs.shape)
    res = (_run_sharded(scorer, seqs, lens, want_labels=True) if scorer
           else eng.run_batch_fused(seqs, lens, want_labels=True))
    batch.mapq[:] = res.mapq[:B].astype(np.float64)
    return res.labels[:B]


def _label_streaming(mb, rs, batch, param, confidence_threshold, kind) -> bool:
    """Pipelined labelling: windows of at most 16,384 reads, up to DEPTH in
    flight; the host applies window k's results while the device scores
    k+1..k+DEPTH.  The decided mode (the extraction decisions made on the
    device, ``dispatch_decided``) where it applies; sub-range decodes
    (``-start/-end``) and fingerprints past 27nt, which the host extractor
    decides, stream through the label-carrying rows (``dispatch_packed``)
    and extract each window with ``extract_batch_columnar``; so does every
    chunk under TAGDUST_TPU_DEVICE_DECISIONS=0.  Returns False
    when the chunk fits one window, or a window of the batch granularity
    would not fit the stack budget (the caller labels it one-shot).

    With several local devices (``_mesh_scorer``) the same loop drives
    them all: a window is n shards of whole tiles, each dispatched on its
    card (``ShardedScorer``), and fetched into slices of one pinned buffer
    with one event per shard; the granularity and the cap scale by n, and
    each shard stays inside its share of its card's budget (JAX
    ``runner.py:558-575``)."""
    from ..extract import apply_device_decisions, extract_batch_columnar
    from ..io.batch import padded_matrix

    B = batch.B
    matchstart, matchend = param.matchstart, param.matchend
    sub = matchstart != -1 or matchend != -1
    eng = get_engine(mb, kind)
    rfl = eng.required_finger_len()
    # TAGDUST_TPU_DEVICE_DECISIONS=0 sends every chunk through the
    # label-carrying rows and the host extractor (JAX runner.py:622-630)
    decided = (not sub and rfl <= 27
               and os.environ.get("TAGDUST_TPU_DEVICE_DECISIONS", "1") == "1")
    full_lens = batch.lens
    Lmax = (matchend - matchstart) if sub else int(full_lens.max(initial=1))
    Lpad = max((int(Lmax) + 31) // 32 * 32, 32)
    DEPTH = max(int(os.environ.get("TAGDUST_TPU_PIPELINE_DEPTH", "3")), 1)
    BT = eng.default_batch_tile()
    budget = eng.stack_budget() // DEPTH
    scorer = _mesh_scorer(eng, B, Lpad, budget, not decided)  # None on one card
    n = scorer.n if scorer is not None else 1
    gran = BT * n  # every shard gets whole tiles
    # DEPTH windows in flight share each card's budget, and so do the shards
    # on one card; where a shard of BT reads would not fit, the one-shot path
    # sub-batches the chunk instead
    fit = (scorer.shard_reads(Lpad, budget, not decided) if scorer is not None
           else eng.reads_within(Lpad, budget, not decided)) // BT * BT
    if fit < BT:
        return False
    W = min(fit, 16384) * n
    wenv = os.environ.get("TAGDUST_TPU_WINDOW")
    if wenv:
        W = min(max(int(wenv) // gran * gran, gran), fit * n)
    if B <= W:
        return False

    thr32 = eng.threshold_f32_ceil(confidence_threshold)
    minlen = int(param.minlen)
    on_card = eng.device.type == "cuda"
    # device DUST (extracted, raw); a sub-range decode keeps the host's,
    # whose label-buffer quirks differ
    dust_dev = None if sub else np.empty((B, 2), dtype=np.float32)
    inflight: deque = deque()  # enqueued on the device
    ready: deque = deque()  # device->host copy enqueued
    consumed = [0]

    def _window(s: int, e: int):
        if sub:
            seqs = _subrange_matrix(batch, s, e, matchstart, matchend, Lpad)
            lens_w = np.full(e - s, matchend - matchstart, dtype=np.int32)
        else:
            seqs = padded_matrix(
                batch.seq_arena, batch.seq_off[s : e + 1], full_lens[s:e], Lpad, 0
            )
            lens_w = full_lens[s:e].astype(np.int32)
        return eng._pad(seqs, lens_w, gran)

    def _fetch(rows):
        # rows: one tensor, or the shards' rows in shard order
        parts = rows if isinstance(rows, list) else [rows]
        if not on_card:
            return (parts[0] if len(parts) == 1 else torch.cat(parts)), []
        host = torch.empty((sum(p.shape[0] for p in parts),) + parts[0].shape[1:],
                           dtype=parts[0].dtype, pin_memory=True)
        evs, a = [], 0
        for p in parts:
            host[a : a + p.shape[0]].copy_(p, non_blocking=True)
            a += p.shape[0]
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(p.device))
            evs.append(ev)
        return host, evs

    def _extract(s, e, host, evs):
        for ev in evs:
            ev.synchronize()
        consumed[0] += 1
        win = batch.slice(s, e)
        if decided:
            res = collect_decided(host.numpy(), e - s, Lpad)
            dust_dev[s:e] = res["dust"]
            apply_device_decisions(win, res, rfl)
        else:
            res = eng.collect_packed(host.numpy(), e - s, Lpad)
            if dust_dev is not None:
                dust_dev[s:e] = res.dust
            win.mapq[:] = res.mapq.astype(np.float64)
            extract_batch_columnar(
                mb, rs, win, res.labels, param.minlen, confidence_threshold,
                matchstart, matchend,
            )
            if win.fp_big:
                batch.fp_big.update({s + k: v for k, v in win.fp_big.items()})
                batch.fingerprint[s:e][list(win.fp_big)] = -2
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
            src = scorer if scorer is not None else eng
            rows = (src.dispatch_decided(seqs, lens_w, thr32, minlen) if decided
                    else src.dispatch_packed(seqs, lens_w))
            inflight.append((s, e, rows))
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
        STREAM_STATS["oneshot_after_failure"] += 1
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
    from ..extract import extract_batch_columnar
    from ..filters import dust_batch_columnar, match_to_reference_columnar

    kind = resolve_engine(param)
    batch.dust_device = None
    if kind not in DEVICE_KINDS or not _label_streaming(
        mb, rs, batch, param, confidence_threshold, kind
    ):
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
        match_to_reference_columnar(
            batch, contaminants, param.filter_error, device=kind
        )
    if param.dust:
        dd = batch.dust_device
        if dd is not None:
            score = np.where(was_success, dd[:, 0], dd[:, 1])
            with np.errstate(invalid="ignore"):
                batch.read_type[score > param.dust] = EXTRACT_FAIL_LOW_COMPLEXITY
        else:
            dust_batch_columnar(batch, param.dust)


def run_rna_dust_batch(batch, param, contaminants=None) -> None:
    """Pure R:N architectures over a columnar ReadBatch: no model to score,
    only the filters (Myers on the run's engine: the ``td_myers`` kernel for
    ``cuda``, its plain version for ``torch``, the host lanes for ``exact``;
    host DUST)."""
    from ..filters import dust_batch_columnar, match_to_reference_columnar

    batch.read_type[:] = EXTRACT_SUCCESS
    if contaminants is not None:
        match_to_reference_columnar(
            batch, contaminants, param.filter_error, device=resolve_engine(param)
        )
    if param.dust:
        dust_batch_columnar(batch, param.dust)
