"""Sequence-statistics pre-pass (background freqs, lengths, P-segment stats).

Re-implements ``get_sequence_stats`` (``io.c:52-300``): one streaming pass
over (at most ~1M of) the input reads computing

* background nucleotide frequencies with +1 pseudocounts, stored as
  float32-rounded log-probabilities (``io.c:263-270``),
* average (rounded) and maximum read length,
* for a leading/trailing ``P`` partial-linker segment: the empirical
  mean/stdev of the exact-match prefix/suffix overlap length
  (``io.c:104-173``), matching the linker *suffix* at the read start (5')
  and the linker *prefix* at the read end (3'); only overlaps > 3 nt count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .arch import ReadStructure
from .constants import NUC_CODE
from .io.fastq import SeqReader
from .logsum import p2sp


@dataclass
class SequenceStats:
    background: List[float] = field(default_factory=lambda: [0.0] * 5)
    expected_5_len: int = 0
    expected_3_len: int = 0
    mean_5_len: float = 0.0
    stdev_5_len: float = 0.0
    mean_3_len: float = 0.0
    stdev_3_len: float = 0.0
    average_length: int = 0
    max_seq_len: int = 0


_STATS_CACHE: dict = {}


def get_sequence_stats(
    path: str,
    rs: ReadStructure,
    num_query: int,
    matchstart: int = -1,
    matchend: int = -1,
    messages=None,
    sam_filter=None,
) -> SequenceStats:
    # the pre-pass result depends on the read structure ONLY through the
    # leading/trailing P-segment linkers; arch auto-detection and the
    # controller both scan (up to 1M reads of) the same file, so cache by
    # (file identity, window, linker signature) and hand out copies (callers
    # mutate max_seq_len as longer reads stream in)
    import copy as _copy
    import os as _os

    try:
        st = _os.stat(path)
        key = (
            _os.path.abspath(path), st.st_mtime_ns, st.st_size, num_query,
            matchstart, matchend, sam_filter,
            rs.seqs[0][0] if rs.types and rs.types[0] == "P" else None,
            rs.seqs[-1][0] if rs.types and rs.types[-1] == "P" else None,
        )
    except OSError:
        key = None
    if key is not None and key in _STATS_CACHE:
        return _copy.deepcopy(_STATS_CACHE[key])
    ssi = _get_sequence_stats_uncached(
        path, rs, num_query, matchstart, matchend, messages, sam_filter
    )
    if key is not None:
        _STATS_CACHE[key] = _copy.deepcopy(ssi)
    return ssi


def _get_sequence_stats_uncached(
    path: str,
    rs: ReadStructure,
    num_query: int,
    matchstart: int = -1,
    matchend: int = -1,
    messages=None,
    sam_filter=None,
) -> SequenceStats:
    ssi = SequenceStats()
    counts = np.ones(5, dtype=np.float64)  # +1 pseudocounts (io.c:79-81)
    total_read = 0
    sum_len = 0.0

    five_test = three_test = None
    five_len = three_len = 0
    f_s0 = f_s1 = f_s2 = 0.0
    t_s0 = t_s1 = t_s2 = 0.0
    if rs.types and rs.types[0] == "P":
        five_len = len(rs.seqs[0][0])
        ssi.expected_5_len = five_len
        five_test = NUC_CODE[np.frombuffer(rs.seqs[0][0].encode(), np.uint8)]
    if rs.types and rs.types[-1] == "P":
        three_len = len(rs.seqs[-1][0])
        ssi.expected_3_len = three_len
        three_test = NUC_CODE[np.frombuffer(rs.seqs[-1][0].encode(), np.uint8)]

    reader = SeqReader(path, sam_filter=sam_filter)
    try:
        while True:
            batch = reader.read_chunk_batch(num_query)
            B = batch.B
            if not B:
                break
            # one vectorised pass per chunk (accumulators are integer-valued
            # float64 sums, so chunking/vectorisation changes nothing)
            lens = batch.lens
            mx = int(lens.max(initial=0))
            if mx > ssi.max_seq_len:
                ssi.max_seq_len = mx
            sum_len += float(lens.sum())
            # slice-wise bincount: np.bincount upcasts its input to intp, so
            # one call over a whole-chunk arena materialises an 8x temporary
            # (1.6GB for a 1M-read chunk) — count in bounded slices instead
            bc = np.zeros(6, dtype=np.int64)
            arena = batch.seq_arena
            for s in range(0, arena.shape[0], 1 << 22):
                bc += np.bincount(arena[s : s + (1 << 22)], minlength=6)[:6]
            counts[:5] += bc[:5]
            counts[4] += bc[5]  # '.' counts as slot 5 ->
            # NOTE: reference indexes background[seq[j]] directly; codes are
            # 0-4 for fastq input ('.' never appears in practice).
            if five_len or three_len:
                # padded prefix/suffix matrices; 255 pads guarantee that any
                # overlap longer than the read mismatches — the defined
                # stand-in for the C code's out-of-bounds compares at
                # io.c:146/io.c:163 (see docstring note)
                arena = batch.seq_arena
                cap = max(arena.shape[0] - 1, 0)
                off = batch.seq_off[:-1]
                if five_len:
                    pos = np.arange(five_len, dtype=np.int64)[None, :]
                    idx = off[:, None] + pos
                    pref = arena[np.minimum(idx, cap)].copy()
                    pref[pos >= lens[:, None]] = 255
                if three_len:
                    pos = np.arange(three_len, dtype=np.int64)[None, :]
                    src = (lens - three_len)[:, None] + pos
                    idx = off[:, None] + np.maximum(src, 0)
                    suf = arena[np.minimum(idx, cap)].copy()
                    suf[src < 0] = 255
                if five_len:
                    # longest linker-suffix matching the read start
                    # (io.c:141-156); first (longest) match wins per read
                    rem = np.ones(B, dtype=bool)
                    for j in range(five_len):
                        m = five_len - j
                        hit = rem & (pref[:, :m] == five_test[j:]).all(axis=1)
                        if m > 3:
                            n = int(hit.sum())
                            f_s0 += n
                            f_s1 += n * m
                            f_s2 += n * m * m
                        rem &= ~hit
                if three_len:
                    rem = np.ones(B, dtype=bool)
                    for j in range(three_len):
                        m = three_len - j
                        hit = rem & (
                            suf[:, three_len - m :] == three_test[:m]
                        ).all(axis=1)
                        if m > 3:
                            n = int(hit.sum())
                            t_s0 += n
                            t_s1 += n * m
                            t_s2 += n * m * m
                        rem &= ~hit
            total_read += B
            if total_read > 1000000:
                break
    finally:
        reader.close()

    def _finish(which, s0, s1, s2, expected):
        if s0 <= 1:
            return float(expected), 1.0
        mean = s1 / s0
        var = (s0 * s2 - s1 * s1) / (s0 * (s0 - 1.0))
        # C sqrt() of a negative -> NaN, propagated as-is (io.c:202)
        stdev = math.sqrt(var) if var >= 0 else float("nan")
        if not stdev:
            stdev = 10000.0
        return mean, stdev

    if five_len:
        ssi.mean_5_len, ssi.stdev_5_len = _finish("5", f_s0, f_s1, f_s2, five_len)
    else:
        ssi.mean_5_len = ssi.stdev_5_len = -1.0
    if three_len:
        ssi.mean_3_len, ssi.stdev_3_len = _finish("3", t_s0, t_s1, t_s2, three_len)
    else:
        ssi.mean_3_len = ssi.stdev_3_len = -1.0

    if matchstart != -1 or matchend != -1:
        sum_len = (matchend - matchstart) * total_read
    ssi.average_length = int(math.floor(sum_len / total_read + 0.5))

    s = float(np.sum(counts))
    ssi.background = [float(p2sp(counts[i] / s)) for i in range(5)]
    return ssi
