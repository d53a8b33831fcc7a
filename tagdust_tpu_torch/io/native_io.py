"""ctypes bindings for the native FASTQ codec (``csrc/fastq_codec.cpp`` of
this package, built at first use into ``build/tagdust_tpu_torch/``).

Opt-in fast path for the streaming reader (``TAGDUST_TPU_FAST_IO=1`` or
``SeqReader(path, fast=True)``); produces Read objects identical to the
Python line-state parser for well-formed FASTQ/FASTA (asserted by tests).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

from ..engine.build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "csrc", "fastq_codec.cpp")
_SO = os.path.join(BUILD_DIR, "_fastq_codec.so")

_lib = None


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
        )
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(_SO)
    lib.td_parse_fastq2.restype = ctypes.c_long
    lib.td_emit_runs.restype = ctypes.c_long
    lib.td_skip_fastq.restype = ctypes.c_long
    _lib = lib
    return lib


class FastParser:
    """Streaming chunked parser over a byte stream (already decompressed)."""

    def __init__(self, stream, is_fasta: bool = False, bufsize: int = 8 << 20):
        self.stream = stream
        self.is_fasta = is_fasta
        self.bufsize = bufsize
        self.tail = b""
        self.eof = False
        self.lib = get_lib()

    def read_batch(self, max_records: int):
        """Columnar chunk read: returns a ReadBatch (no per-read objects).

        Names/seq-codes/quals are copied straight into flat arenas by the
        native codec (td_parse_fastq2); the Python side only concatenates
        per-window arrays."""
        from .batch import ReadBatch

        lib = self.lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        # chunk-level arenas: the codec appends each window's output at the
        # current write position (no per-window buffers, no final concat);
        # ownership transfers to the returned ReadBatch
        cap = self.bufsize + (1 << 20)
        name_a = np.empty(cap, dtype=np.uint8)
        seq_a = np.empty(cap, dtype=np.uint8)
        qual_a = np.empty(cap, dtype=np.uint8)
        na = sa = qa = 0
        nlens: list = []
        slens: list = []
        qlens: list = []
        total = 0
        while total < max_records:
            if not self.tail and self.eof:
                break
            while (not self.eof) and len(self.tail) < self.bufsize:
                chunk = self.stream.read(self.bufsize)
                if not chunk:
                    self.eof = True
                    break
                self.tail += chunk
            buf = self.tail
            if not buf:
                break
            n = len(buf)
            # every arena needs >= n bytes headroom for this window
            need = max(na, sa, qa) + n
            if need > name_a.shape[0]:
                newcap = max(need, 2 * name_a.shape[0])
                grown = {}
                for nm, old, used in (
                    ("name_a", name_a, na),
                    ("seq_a", seq_a, sa),
                    ("qual_a", qual_a, qa),
                ):
                    g = np.empty(newcap, dtype=np.uint8)
                    g[:used] = old[:used]
                    grown[nm] = g
                name_a, seq_a, qual_a = (
                    grown["name_a"], grown["seq_a"], grown["qual_a"]
                )
            want = min(max_records - total, n // 4 + 1)
            name_off = np.empty(want, dtype=np.int64)
            name_len = np.empty(want, dtype=np.int32)
            seq_off = np.empty(want, dtype=np.int64)
            seq_len = np.empty(want, dtype=np.int32)
            qual_off = np.empty(want, dtype=np.int64)
            qual_len = np.empty(want, dtype=np.int32)
            consumed = ctypes.c_long(0)
            rec = lib.td_parse_fastq2(
                buf,
                ctypes.c_long(n),
                ctypes.c_long(want),
                ctypes.c_int(1 if self.eof else 0),
                ctypes.cast(name_a.ctypes.data + na, u8p),
                name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                ctypes.cast(seq_a.ctypes.data + sa, u8p),
                ctypes.c_long(n),
                seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                seq_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                ctypes.cast(qual_a.ctypes.data + qa, u8p),
                qual_off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                qual_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                ctypes.byref(consumed),
            )
            if rec < 0:
                raise SystemExit(
                    "ERROR: Length of sequence and base qualities differ!."
                )
            if consumed.value == 0 and rec == 0:
                if self.eof:
                    break
                self.bufsize *= 2  # buffer too small for one record: grow
                continue
            self.tail = buf[consumed.value :]
            if rec == 0:
                if self.eof:
                    break
                continue
            nl = name_len[:rec].astype(np.int64)
            ql = qual_len[:rec].astype(np.int64)
            na += int(nl.sum())
            sa += int(seq_off[rec - 1] + seq_len[rec - 1])
            qa += int(np.maximum(ql, 0).sum())
            nlens.append(nl)
            slens.append(seq_len[:rec].astype(np.int64))
            qlens.append(ql)
            total += rec
        rb = ReadBatch()
        B = total
        cat = lambda ps, dt: (  # noqa: E731
            ps[0] if len(ps) == 1
            else np.concatenate(ps) if ps else np.zeros(0, dtype=dt)
        )
        rb.name_arena = name_a[:na]
        rb.name_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(cat(nlens, np.int64), out=rb.name_off[1:])
        rb.seq_arena = seq_a[:sa]
        rb.seq_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(cat(slens, np.int64), out=rb.seq_off[1:])
        rb.qual_arena = qual_a[:qa]
        rb.qual_len = cat(qlens, np.int64)
        qsz = np.maximum(rb.qual_len, 0)
        rb.qual_off = np.zeros(B, dtype=np.int64)
        if B > 1:
            np.cumsum(qsz[:-1], out=rb.qual_off[1:])
        rb.init_results()
        return rb

    def read_records(self, max_records: int) -> List:
        """Per-read-object view of the columnar parse (non-hot consumers)."""
        return self.read_batch(max_records).to_reads()

    def skip_records(self, max_records: int) -> int:
        """Skip up to max_records records, paying only record-boundary-scan
        cost (no arena copies / nuc encoding).  Multi-host input sharding:
        a process calls this for chunks another host owns.  Returns the
        number of records actually skipped (0 at EOF)."""
        lib = self.lib
        total = 0
        while total < max_records:
            if not self.tail and self.eof:
                break
            while (not self.eof) and len(self.tail) < self.bufsize:
                chunk = self.stream.read(self.bufsize)
                if not chunk:
                    self.eof = True
                    break
                self.tail += chunk
            buf = self.tail
            if not buf:
                break
            consumed = ctypes.c_long(0)
            rec = lib.td_skip_fastq(
                buf,
                ctypes.c_long(len(buf)),
                ctypes.c_long(max_records - total),
                ctypes.c_int(1 if self.eof else 0),
                ctypes.byref(consumed),
            )
            if rec < 0:
                # same abort as read_batch: a skipping host must die on the
                # same malformed input the owning host dies on, or a
                # multi-host run hangs at the next collective (ADVICE r3)
                raise SystemExit(
                    "ERROR: Length of sequence and base qualities differ!."
                )
            if consumed.value == 0 and rec == 0:
                if self.eof:
                    break
                self.bufsize *= 2
                continue
            self.tail = buf[consumed.value :]
            total += rec
            if rec == 0 and self.eof:
                break
        return total
