"""Columnar read batches: the hot-path container for production runs.

The reference materialises one ``read_info`` struct per read
(``io.h:76-91``); this framework's per-read Python objects (`Read`) mirror
that for the parity paths, but at TPU throughput (>100k reads/s through the
whole CLI) per-read Python objects dominate the host cost.  ``ReadBatch``
holds an entire chunk as flat arrays:

* ``name_arena`` / ``name_off`` — raw header bytes, offsets (``[B+1]``);
* ``seq_arena`` / ``seq_off`` — 0-5 nucleotide codes, offsets (``[B+1]``);
* ``qual_arena`` / ``qual_off`` / ``qual_len`` — quality bytes
  (``qual_len == -1`` marks an absent quality line, e.g. FASTA);
* result columns (``mapq``, ``read_type``, ``barcode``, fingerprint parts)
  matching the fields of ``read_info``.

Everything downstream (stats, device upload, extraction, filters, writer)
works on these arrays; conversion to/from per-read ``Read`` objects is
provided for the non-hot consumers and for equivalence tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np



@dataclass
class Read:
    """One read of the parity paths (the port's ``io/fastq.py:Read``)."""

    name: str = ""
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint8))
    qual: Optional[str] = None
    labels: Optional[np.ndarray] = None
    mapq: float = -1.0
    bar_prob: float = 0.0
    barcode: int = -1
    fingerprint: int = -1
    read_type: int = 0

    @property
    def len(self) -> int:
        return int(self.seq.shape[0])


def gather_ranges(src: np.ndarray, off: np.ndarray, ln: np.ndarray):
    """Concatenate ``src[off[i] : off[i]+ln[i]]`` slices into one flat array.

    Returns ``(flat, new_off)`` with ``new_off`` of shape ``[B+1]``.
    """
    ln = ln.astype(np.int64)
    total = int(ln.sum())
    new_off = np.zeros(ln.shape[0] + 1, dtype=np.int64)
    np.cumsum(ln, out=new_off[1:])
    if total == 0:
        return src[:0], new_off
    idx = (
        np.arange(total, dtype=np.int64)
        - np.repeat(new_off[:-1], ln)
        + np.repeat(off.astype(np.int64), ln)
    )
    return src[idx], new_off


def padded_matrix(
    arena: np.ndarray,
    off: np.ndarray,
    lens: np.ndarray,
    width: int,
    fill: int,
    dtype=np.uint8,
) -> np.ndarray:
    """[B, width] matrix from arena slices, right-padded with ``fill``."""
    B = lens.shape[0]
    if B == 0 or width == 0:
        return np.full((B, width), fill, dtype=dtype)
    pos = np.arange(width, dtype=np.int64)[None, :]
    idx = off[:-1, None] + pos if off.shape[0] == B + 1 else off[:, None] + pos
    valid = pos < lens[:, None]
    cap = max(arena.shape[0] - 1, 0)
    out = arena[np.minimum(idx, cap)].astype(dtype, copy=True)
    out[~valid] = fill
    return out


@dataclass
class ReadBatch:
    name_arena: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint8)
    )
    name_off: np.ndarray = field(
        default_factory=lambda: np.zeros(1, dtype=np.int64)
    )
    seq_arena: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint8)
    )
    seq_off: np.ndarray = field(
        default_factory=lambda: np.zeros(1, dtype=np.int64)
    )
    qual_arena: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint8)
    )
    qual_off: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    qual_len: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )  # -1 = absent
    # result columns (read_info, io.h:76-91)
    mapq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    read_type: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    barcode: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # fingerprint = (key << 8) | len, -1 = unset; keys for UMIs <= 28 nt fit
    # an int64 exactly like the per-read path's Python ints; longer UMIs
    # overflow to fp_big (rare — kept exact)
    fingerprint: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    fp_big: Dict[int, int] = field(default_factory=dict)

    @property
    def B(self) -> int:
        return self.seq_off.shape[0] - 1

    def __len__(self) -> int:
        return self.B

    @property
    def lens(self) -> np.ndarray:
        c = getattr(self, "_lens_cache", None)
        if c is None or c.shape[0] != self.B:
            c = self._lens_cache = np.diff(self.seq_off)
        return c

    def init_results(self) -> None:
        B = self.B
        self.mapq = np.full(B, -1.0, dtype=np.float64)
        self.read_type = np.zeros(B, dtype=np.int64)
        self.barcode = np.full(B, -1, dtype=np.int64)
        self.fingerprint = np.full(B, -1, dtype=np.int64)
        self.fp_big = {}

    def name(self, i: int) -> str:
        a, b = int(self.name_off[i]), int(self.name_off[i + 1])
        return self.name_arena[a:b].tobytes().decode("ascii", "replace")

    def seq(self, i: int) -> np.ndarray:
        a, b = int(self.seq_off[i]), int(self.seq_off[i + 1])
        return self.seq_arena[a:b]

    def qual(self, i: int) -> Optional[str]:
        if self.qual_len.shape[0] == 0 or self.qual_len[i] < 0:
            return None
        a = int(self.qual_off[i])
        return (
            self.qual_arena[a : a + int(self.qual_len[i])]
            .tobytes()
            .decode("ascii", "replace")
        )

    def seq_matrix(self, width: Optional[int] = None, fill: int = 0) -> np.ndarray:
        lens = self.lens
        w = width if width is not None else int(lens.max(initial=0))
        return padded_matrix(self.seq_arena, self.seq_off, lens, w, fill)

    def qual_matrix(self, width: Optional[int] = None, fill: int = ord(".")):
        """[B, width] quality bytes; absent quals stay at ``fill`` ('.'),
        matching the writer's FASTA behaviour (io.c:966)."""
        lens = self.lens
        w = width if width is not None else int(lens.max(initial=0))
        ql = np.maximum(self.qual_len, 0)
        out = padded_matrix(self.qual_arena, self.qual_off, ql, w, fill)
        return out

    # ---------------- conversion ----------------
    @classmethod
    def from_reads(cls, reads: List[Read]) -> "ReadBatch":
        B = len(reads)
        rb = cls()
        names = [r.name.encode("latin-1", "replace") for r in reads]
        rb.name_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum([len(n) for n in names], out=rb.name_off[1:])
        rb.name_arena = (
            np.frombuffer(b"".join(names), dtype=np.uint8)
            if B
            else np.zeros(0, np.uint8)
        )
        rb.seq_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum([r.len for r in reads], out=rb.seq_off[1:])
        rb.seq_arena = (
            np.concatenate([r.seq for r in reads])
            if B
            else np.zeros(0, np.uint8)
        ).astype(np.uint8)
        quals = [
            r.qual.encode("latin-1", "replace") if r.qual is not None else None
            for r in reads
        ]
        rb.qual_len = np.array(
            [len(q) if q is not None else -1 for q in quals], dtype=np.int64
        )
        rb.qual_off = np.zeros(B, dtype=np.int64)
        np.cumsum(
            [len(q) if q is not None else 0 for q in quals[:-1]],
            out=rb.qual_off[1:] if B > 1 else np.zeros(0, np.int64),
        )
        rb.qual_arena = np.frombuffer(
            bytearray(b"".join(q for q in quals if q is not None)),
            dtype=np.uint8,
        )
        rb.init_results()
        # carry over any preset result fields (e.g. SAM mapq column)
        for i, r in enumerate(reads):
            if r.mapq != -1.0:
                rb.mapq[i] = r.mapq
            if r.read_type:
                rb.read_type[i] = r.read_type
        return rb

    def to_reads(self) -> List[Read]:
        out = []
        lens = self.lens
        for i in range(self.B):
            r = Read(
                name=self.name(i),
                seq=self.seq(i).copy(),
                qual=self.qual(i),
            )
            if self.mapq.shape[0]:
                r.mapq = float(self.mapq[i])
                r.read_type = int(self.read_type[i])
                r.barcode = int(self.barcode[i])
                r.fingerprint = self.fp_value(i)
            _ = lens
            out.append(r)
        return out

    def fp_value(self, i: int) -> int:
        if i in self.fp_big:
            return self.fp_big[i]
        return int(self.fingerprint[i])

    def slice(self, s: int, e: int) -> "ReadBatch":
        """Zero-copy window [s, e): arenas shared, offsets/result columns are
        views — writes through the window (extraction scatter, result fills)
        land in the parent.  ``fp_big`` is NOT shared; callers merge it back
        with the window offset."""
        rb = ReadBatch()
        rb.name_arena = self.name_arena
        rb.name_off = self.name_off[s : e + 1]
        rb.seq_arena = self.seq_arena
        rb.seq_off = self.seq_off[s : e + 1]
        rb.qual_arena = self.qual_arena
        rb.qual_off = self.qual_off[s:e]
        rb.qual_len = self.qual_len[s:e]
        rb.mapq = self.mapq[s:e]
        rb.read_type = self.read_type[s:e]
        rb.barcode = self.barcode[s:e]
        rb.fingerprint = self.fingerprint[s:e]
        rb.fp_big = {}
        return rb
