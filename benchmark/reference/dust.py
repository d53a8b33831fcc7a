"""DUST, the low-complexity filter (the port's ``filters.py``, its DUST
half copied): ``dust_batch_columnar`` marks a read whose score over its
first 64 positions passes the cut (TagDust2 ``barcode_hmm.c:2424-2453``)."""

from __future__ import annotations

import numpy as np

from .constants import EXTRACT_FAIL_LOW_COMPLEXITY, SPACER

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


def dust_batch_columnar(batch, dust_cut: int) -> None:
    """Columnar dust_reads: [B, 64] window gathered from the seq arena."""
    from .batch import padded_matrix

    lens = batch.lens
    arr = padded_matrix(batch.seq_arena, batch.seq_off, lens, 64, SPACER)
    scores = _dust_scores_core(arr, lens.astype(np.int32))
    with np.errstate(invalid="ignore"):
        batch.read_type[scores > dust_cut] = EXTRACT_FAIL_LOW_COMPLEXITY
