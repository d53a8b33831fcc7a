"""The sequence-statistics pre-pass of the reference, for reads of codes.

The port's ``stats.py`` reads the FASTQ file; the reference is handed the
generated reads as codes instead, and computes the same numbers for an
architecture with no ``P`` segment (the only kind the benchmark runs):
background frequencies with +1 pseudocounts as float32-rounded log
probabilities over the reads the pre-pass reads, their rounded average
length and their maximum length (TagDust2 ``io.c:52-300``).

The pre-pass reads chunks of ``num_query`` reads and stops after the chunk
that takes it past 1,000,000 reads, so it sees
``min(n, num_query * (1,000,000 // num_query + 1))`` reads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

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


def reads_seen(n: int, num_query: int) -> int:
    """How many of ``n`` reads the pre-pass reads at ``num_query``."""
    return min(n, num_query * (1000000 // num_query + 1))


def sequence_stats(codes: np.ndarray, lens: np.ndarray, num_query: int) -> SequenceStats:
    """Stats of reads ``codes`` [n, L] (codes 0-4, ``lens`` valid) as the
    pre-pass at ``num_query`` computes them."""
    n = reads_seen(codes.shape[0], num_query)
    codes, lens = codes[:n], lens[:n]
    valid = np.arange(codes.shape[1])[None, :] < lens[:, None]
    counts = np.ones(5, dtype=np.float64)
    counts += np.bincount(codes[valid], minlength=5)[:5]
    ssi = SequenceStats()
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    ssi.max_seq_len = int(lens.max(initial=0))
    ssi.average_length = int(math.floor(float(lens.sum()) / n + 0.5))
    s = float(np.sum(counts))
    ssi.background = [float(p2sp(counts[i] / s)) for i in range(5)]
    return ssi
