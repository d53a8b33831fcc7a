"""Post-extraction filters: DUST low-complexity and contaminant matching.

* DUST (``dust_sequences``, ``barcode_hmm.c:2407-2467``): triplet-count score
  over the first 64 nt; above the ``-dust`` threshold (default 100) the read
  is marked LOW_COMPLEXITY.
* Artifact filter (``match_to_reference``, ``barcode_hmm.c:2478-2583``):
  Myers bit-parallel edit distance of each read (forward and
  reverse-complement) against every contaminant; <= ``-fe`` errors marks
  MATCHES_ARTIFACTS with the 1-based contaminant id encoded in the high bits
  of read_type.  The bit-parallel kernels mirror ``misc.c:581-796``
  (patterns effectively capped at 31/63 symbols).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from .constants import (
    EXTRACT_FAIL_LOW_COMPLEXITY,
    EXTRACT_FAIL_MATCHES_ARTIFACTS,
    EXTRACT_SUCCESS,
    REV_NUC_CODE,
    SPACER,
)
from .io.fastq import Read

_M64 = (1 << 64) - 1


def dust_score(seq: np.ndarray, length: int) -> float:
    """Simplified DUST on the first 64 nt (barcode_hmm.c:2424-2453)."""
    c = 0
    n = int(length)
    while c < n and seq[c] == SPACER:
        c += 1
    if c + 1 >= n:
        return 0.0
    key = ((int(seq[c]) & 0x3) << 2) | (int(seq[c + 1]) & 0x3)
    ln = min(n, 64)
    c += 2
    triplet = np.zeros(64, dtype=np.float64)
    start = c
    for j in range(start, ln):
        if seq[j] == SPACER:
            break
        key = ((key << 2) | (int(seq[j]) & 0x3)) & _M64
        triplet[key & 0x3F] += 1
        c += 1
    s = float(np.sum(triplet * (triplet - 1.0) / 2.0))
    if c == 3:
        # C evaluates 0.0/0 = NaN here (never > the dust cut)
        return float("nan")
    return s / float(c - 3) * 10.0


def dust_scores_batch(reads: List[Read]) -> np.ndarray:
    B = len(reads)
    W = 64
    arr = np.full((B, W), SPACER, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        L = min(r.len, W)
        lens[i] = r.len
        arr[i, :L] = r.seq[:L]
    return _dust_scores_core(arr, lens)


def _dust_scores_core(arr: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorised dust_score over a chunk (same quirks: the denominator
    counts the leading-spacer prefix, triplets stop at the first interior
    spacer and at 64 nt).

    ``arr`` is the [B, 64] first-window matrix (SPACER-padded), ``lens`` the
    FULL read lengths.  The pair count Σ c(c-1)/2 is computed by sorting
    each read's counted triplet keys and summing within-run prefix indices —
    small uint8/int16 buffers only (no [B*64] histogram)."""
    B, W = arr.shape
    ln = np.minimum(lens, W).astype(np.int16)
    pos = np.arange(W, dtype=np.int16)[None, :]
    is_sp = (arr == SPACER) | (pos >= ln[:, None])
    # leading spacer count (c0) within the real length
    lead = np.argmax(~is_sp, axis=1).astype(np.int16)
    none_real = ~(~is_sp).any(axis=1)
    lead = np.where(none_real, ln, lead)
    # reads with c0 + 1 >= n score 0.0 (dust_score early-out)
    degenerate = (lead.astype(np.int32) + 1) >= lens
    # triplet run: positions j >= lead+2 counted while no spacer in (lead..j]
    after_start = pos >= (lead + 2)[:, None]
    sp_after_start = is_sp & after_start
    first_sp = np.where(
        sp_after_start.any(axis=1),
        np.argmax(sp_after_start, axis=1),
        W,
    ).astype(np.int16)
    counted = after_start & (pos < first_sp[:, None])
    # rolling 2-bit keys of the last 3 bases (any bijective bit order works:
    # the pair count is invariant under key relabeling)
    b2 = arr & 0x3
    key = np.empty((B, W), dtype=np.uint8)
    key[:, 2:] = (b2[:, 2:] << 4) | (b2[:, 1:-1] << 2) | b2[:, :-2]
    key[:, :2] = 0
    # uncounted slots -> sentinel 255 so they sort to the end
    key[~counted] = 255
    key.sort(axis=1)
    eq = np.zeros((B, W), dtype=bool)
    eq[:, 1:] = (key[:, 1:] == key[:, :-1]) & (key[:, 1:] != 255)
    # within-run prefix index via column loop with a reused [B] carry
    s = np.zeros(B, dtype=np.float64)
    carry = np.zeros(B, dtype=np.int32)
    for j in range(1, W):
        carry = np.where(eq[:, j], carry + 1, 0)
        s += carry
    ntrip = counted.sum(axis=1, dtype=np.int32)
    c_final = lead.astype(np.int32) + 2 + ntrip
    denom = np.where(c_final == 3, np.nan, c_final - 3).astype(np.float64)
    out = np.where(degenerate, 0.0, s / denom * 10.0)
    return out


def dust_reads(reads: List[Read], dust_cut: int) -> None:
    scores = dust_scores_batch(reads)
    for i, r in enumerate(reads):
        if scores[i] > dust_cut:
            r.read_type = EXTRACT_FAIL_LOW_COMPLEXITY


def dust_batch_columnar(batch, dust_cut: int) -> None:
    """Columnar dust_reads: [B, 64] window gathered from the seq arena."""
    from .io.batch import padded_matrix

    lens = batch.lens
    arr = padded_matrix(batch.seq_arena, batch.seq_off, lens, 64, SPACER)
    scores = _dust_scores_core(arr, lens.astype(np.int32))
    with np.errstate(invalid="ignore"):
        batch.read_type[scores > dust_cut] = EXTRACT_FAIL_LOW_COMPLEXITY


# seconds the columnar artifact filter has spent since the last reset:
# gathering the patterns from the arena, building their masks on the host,
# and in the Myers lanes (on a device: upload, kernel and fetch)
REF_TIMINGS = {"calls": 0, "gather_s": 0.0, "masks_s": 0.0, "lanes_s": 0.0}


def match_to_reference_columnar(
    batch, contaminant_seqs: List[np.ndarray], error_cut: int,
    device=None,
) -> None:
    """Columnar match_to_reference: patterns gathered from the seq arena.
    ``device`` as in ``_reference_hits``."""
    B = batch.B
    if B == 0 or not contaminant_seqs:
        return
    t0 = time.perf_counter()
    W = 63
    full = batch.lens
    lens = np.minimum(full, W).astype(np.int32)
    arena = batch.seq_arena
    cap = max(arena.shape[0] - 1, 0)
    off = batch.seq_off[:-1]
    pos = np.arange(W, dtype=np.int64)[None, :]
    valid = pos < lens[:, None]
    fwd = arena[np.minimum(off[:, None] + pos, cap)].copy()
    fwd[~valid] = SPACER
    # reverse_complement of the FULL read, then first 63 symbols
    # (misc.c:829-853; spacers preserved)
    ridx = off[:, None] + (full[:, None] - 1 - pos)
    rv = arena[np.minimum(np.maximum(ridx, 0), cap)]
    rev = np.where(rv >= 5, SPACER, REV_NUC_CODE[np.minimum(rv, 4)]).astype(
        np.uint8
    )
    rev[~valid] = SPACER
    REF_TIMINGS["calls"] += 1
    REF_TIMINGS["gather_s"] += time.perf_counter() - t0
    hit, best_id = _reference_hits(fwd, rev, lens, contaminant_seqs,
                                   error_cut, device)
    mark = hit & (batch.read_type == EXTRACT_SUCCESS)
    batch.read_type[mark] = (
        (best_id[mark] << 8) | EXTRACT_FAIL_MATCHES_ARTIFACTS
    )


def _reference_hits(fwd, rev, lens, contaminant_seqs, error_cut, device=None):
    """Shared core: best Myers distance over contaminants x orientations.
    ``device`` ``"cuda"`` runs the lanes through the ``td_myers`` kernel on
    the card and ``"torch"`` through its plain version on CPU tensors
    (``engine/myers.py``); anything else runs the host uint64 lanes.  A
    kernel that fails to build or launch raises: nothing downgrades to the
    host lanes."""
    t0 = time.perf_counter()
    B = fwd.shape[0]
    B4f = _pattern_masks(fwd, lens)
    B4r = _pattern_masks(rev, lens)
    t1 = time.perf_counter()
    REF_TIMINGS["masks_s"] += t1 - t0
    if device in ("cuda", "torch"):
        from .engine.myers import reference_hits_device

        out = reference_hits_device(
            B4f, B4r, lens, contaminant_seqs, error_cut,
            "cuda" if device == "cuda" else "cpu",
        )
        REF_TIMINGS["lanes_s"] += time.perf_counter() - t1
        return out
    best = np.full(B, 100000, dtype=np.int64)
    best_id = np.zeros(B, dtype=np.int64)
    for j, ref in enumerate(contaminant_seqs):
        for B4 in (B4f, B4r):
            d = _bpm_batch(ref, B4, lens)
            better = d < best
            best = np.where(better, d, best)
            best_id = np.where(better, j + 1, best_id)
    REF_TIMINGS["lanes_s"] += time.perf_counter() - t1
    return (best <= error_cut) & (lens > 0), best_id


def bpm_check_error(text: np.ndarray, pattern: np.ndarray, n: int, m: int) -> int:
    """misc.c:581-640: best (substring) edit distance of pattern in text.

    Pattern symbols equal to the spacer (65) are skipped; effectively capped
    at 31 pattern symbols.
    """
    B = [0, 0, 0, 0]
    new_len = 0
    for i in range(min(m, 64)):
        if pattern[i] != SPACER:
            B[int(pattern[i]) & 0x3] |= 1 << i
            new_len += 1
    if new_len > 31:
        new_len = 31
    m = new_len
    k = new_len
    diff = new_len
    VP = _M64
    VN = 0
    m -= 1
    MASK = 1 << m
    for i in range(n):
        X = B[int(text[i]) & 0x3] | VN
        D0 = ((((VP + (X & VP)) & _M64) ^ VP) | X) & _M64
        HN = VP & D0
        HP = (VN | (~(VP | D0) & _M64)) & _M64
        X = (HP << 1) & _M64
        VN = X & D0
        VP = (((HN << 1) | (~(X | D0) & _M64))) & _M64
        diff += (HP & MASK) >> m
        diff -= (HN & MASK) >> m
        if diff < k:
            k = diff
    return int(k)


def bpm_check_error_global(text: np.ndarray, pattern: np.ndarray, n: int, m: int) -> int:
    """misc.c:653-704: global-ish edit distance, pattern capped at 63."""
    if m > 63:
        m = 63
    B = [0, 0, 0, 0]
    for i in range(m):
        B[int(pattern[i]) & 0x3] |= 1 << i
    diff = m
    VP = _M64
    VN = 0
    m -= 1
    MASK = 1 << m
    for i in range(n):
        X = B[int(text[i]) & 0x3] | VN
        D0 = ((((VP + (X & VP)) & _M64) ^ VP) | X) & _M64
        HN = VP & D0
        HP = (VN | (~(VP | D0) & _M64)) & _M64
        X = (HP << 1) & _M64
        VN = X & D0
        VP = (((HN << 1) | (~(X | D0) & _M64))) & _M64
        diff += (HP & MASK) >> m
        diff -= (HN & MASK) >> m
    return int(diff)


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    """misc.c:829-853 (spacers preserved)."""
    out = np.empty_like(seq)
    n = seq.shape[0]
    for i in range(n):
        v = seq[n - 1 - i]
        out[i] = SPACER if v == SPACER else REV_NUC_CODE[int(v)]
    return out


def _pattern_masks(pats: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """[B, 4] uint64 Myers pattern bitmasks; spacer symbols skip the mask but
    still occupy bit positions (misc.c:718-733 quirk)."""
    B, W = pats.shape
    bits = (np.uint64(1) << np.arange(W, dtype=np.uint64))[None, :]
    pos = np.arange(W, dtype=np.int32)[None, :]
    valid = (pos < lens[:, None]) & (pats != SPACER)
    out = np.zeros((B, 4), dtype=np.uint64)
    low2 = pats & 0x3
    for c in range(4):
        out[:, c] = np.where(valid & (low2 == c), bits, np.uint64(0)).sum(
            axis=1, dtype=np.uint64
        )
    return out


def _bpm_batch(text: np.ndarray, B4: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Batched _bmp_single: best substring edit distance of each pattern
    (rows of B4, lengths m<=63) in one shared text.  uint64 lanes across the
    read batch; wrap-around arithmetic matches the C kernel."""
    B = B4.shape[0]
    m64 = m.astype(np.uint64)
    mask = np.uint64(1) << (m64 - np.uint64(1))
    VP = (np.uint64(1) << m64) - np.uint64(1)
    VN = np.zeros(B, dtype=np.uint64)
    diff = m.astype(np.int64).copy()
    k = diff.copy()
    one = np.uint64(1)
    for t in text:
        X = B4[:, int(t) & 0x3] | VN
        D0 = ((VP + (X & VP)) ^ VP) | X
        HN = VP & D0
        HP = VN | ~(VP | D0)
        X = HP << one
        VN = X & D0
        VP = (HN << one) | ~(X | D0)
        diff += ((HP & mask) != 0).astype(np.int64)
        diff -= ((HN & mask) != 0).astype(np.int64)
        np.minimum(k, diff, out=k)
    return k


def match_to_reference(
    reads: List[Read],
    contaminant_seqs: List[np.ndarray],
    error_cut: int,
    device=None,
) -> None:
    """barcode_hmm.c:2478-2583 semantics: for each read take, over all
    contaminants and both orientations, the minimum distance computed by
    the (pattern = read) kernel; mark EXTRACT_SUCCESS reads whose best
    distance <= error_cut.  Runs the Myers recurrence batch-wide (one uint64
    lane per read) instead of per read; ``device`` ``"cuda"`` or ``"torch"``
    runs the same recurrence in int64 lanes on that torch device
    (engine/myers.py)."""
    B = len(reads)
    if B == 0 or not contaminant_seqs:
        return
    W = 63
    lens = np.zeros(B, dtype=np.int32)
    fwd = np.full((B, W), SPACER, dtype=np.uint8)
    rev = np.full((B, W), SPACER, dtype=np.uint8)
    for i, r in enumerate(reads):
        L = r.len
        lens[i] = min(L, W)
        fwd[i, : lens[i]] = r.seq[:W]
        # reverse_complement of the full read, then first 63 symbols
        # (misc.c:829-853; spacers preserved)
        rseq = r.seq[::-1]
        rc = np.where(
            rseq >= 5, SPACER, REV_NUC_CODE[np.minimum(rseq, 4)]
        )
        rev[i, : lens[i]] = rc[:W].astype(np.uint8)[: lens[i]]
    hit, best_id = _reference_hits(fwd, rev, lens, contaminant_seqs,
                                   error_cut, device)
    for i, r in enumerate(reads):
        if hit[i] and r.read_type == EXTRACT_SUCCESS:
            r.read_type = (int(best_id[i]) << 8) | EXTRACT_FAIL_MATCHES_ARTIFACTS


def _bmp_single(text: np.ndarray, pattern: np.ndarray, n: int, m: int) -> int:
    """misc.c:718-765 (portable Myers kernel, pattern capped at 63)."""
    if m > 63:
        m = 63
    B = [0, 0, 0, 0]
    for i in range(m):
        if pattern[i] != SPACER:
            B[int(pattern[i]) & 0x3] |= 1 << i
    diff = m
    k = m
    VP = (1 << m) - 1
    VN = 0
    m -= 1
    MASK = 1 << m
    for i in range(n):
        X = B[int(text[i]) & 0x3] | VN
        D0 = ((((VP + (X & VP)) & _M64) ^ VP) | X) & _M64
        HN = VP & D0
        HP = (VN | (~(VP | D0) & _M64)) & _M64
        X = (HP << 1) & _M64
        VN = X & D0
        VP = (((HN << 1) | (~(X | D0) & _M64))) & _M64
        diff += 1 if (HP & MASK) else 0
        diff -= 1 if (HN & MASK) else 0
        if diff < k:
            k = diff
    return int(k)
