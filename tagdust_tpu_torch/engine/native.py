"""ctypes bindings + on-demand build of the native exact DP engine.

The C++ engine (``tagdust_tpu_torch/csrc/exact_engine.cpp``, built at
first use into ``build/tagdust_tpu_torch/``) reproduces the reference's float32
table-logsum arithmetic bit-for-bit; it must therefore be compiled with
strict IEEE semantics: no fast-math, no fp contraction.  OpenMP parallelises
over the (embarrassingly parallel) read batch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

from ..model import ModelBag
from .build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "csrc", "exact_engine.cpp")
_SO = os.path.join(BUILD_DIR, "_exact_native.so")

_lib = None


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++",
        "-O2",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-fopenmp",
        "-ffp-contract=off",
        "-fno-fast-math",
        "-o",
        tmp,
        _SRC,
    ]
    subprocess.run(cmd, check=True)
    os.replace(tmp, _SO)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.td_score_batch.restype = None
    lib.td_emit_random.restype = ctypes.c_uint32
    lib.td_emit_read.restype = ctypes.c_uint32
    lib.td_emit_random_batch.restype = ctypes.c_uint32
    lib.td_emit_read_batch.restype = ctypes.c_uint32
    _lib = lib
    return lib


class FlatModel:
    """Flattened parameter tensors for the native engine."""

    def __init__(self, mb: ModelBag):
        self.mb = mb
        nm = mb.num_models
        self.nm = nm
        self.H = np.array([m.num_hmms for m in mb.models], dtype=np.int32)
        self.C = np.array([m.num_cols for m in mb.models], dtype=np.int32)
        self.skip = np.array([m.skip for m in mb.models], dtype=np.float32)
        self.trans = np.concatenate([m.trans.ravel() for m in mb.models]).astype(
            np.float32
        )
        self.me = np.concatenate([m.m_emit.ravel() for m in mb.models]).astype(
            np.float32
        )
        self.ie = np.concatenate([m.i_emit.ravel() for m in mb.models]).astype(
            np.float32
        )
        self.s2M = np.concatenate([m.silent_to_M.ravel() for m in mb.models]).astype(
            np.float32
        )
        self.s2I = np.concatenate([m.silent_to_I.ravel() for m in mb.models]).astype(
            np.float32
        )
        self.label = np.ascontiguousarray(mb.label, dtype=np.int64)
        self.tmatrix = np.ascontiguousarray(mb.tmatrix, dtype=np.float32)
        self.Htot = mb.total_hmm_num
        self.avg_len = mb.average_raw_length
        self.background = np.ascontiguousarray(
            mb.models[0].background, dtype=np.float32
        )

    def _ptr(self, a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    def score_batch(self, seqs: np.ndarray, L: int, mode: int = 0, nthreads: int = 0):
        lib = get_lib()
        B = seqs.shape[0]
        seqs = np.ascontiguousarray(seqs, dtype=np.uint8)
        f_score = np.zeros(B, dtype=np.float32)
        b_score = np.zeros(B, dtype=np.float32)
        r_score = np.zeros(B, dtype=np.float32)
        bar_prob = np.zeros(B, dtype=np.float32)
        labels = np.zeros((B, L + 1), dtype=np.int32)
        lib.td_score_batch(
            ctypes.c_int(self.nm),
            self._ptr(self.H, ctypes.c_int),
            self._ptr(self.C, ctypes.c_int),
            self._ptr(self.skip, ctypes.c_float),
            self._ptr(self.trans, ctypes.c_float),
            self._ptr(self.me, ctypes.c_float),
            self._ptr(self.ie, ctypes.c_float),
            self._ptr(self.s2M, ctypes.c_float),
            self._ptr(self.s2I, ctypes.c_float),
            self._ptr(self.label, ctypes.c_int64),
            self._ptr(self.tmatrix, ctypes.c_float),
            ctypes.c_int(self.Htot),
            ctypes.c_int(self.avg_len),
            self._ptr(self.background, ctypes.c_float),
            self._ptr(seqs, ctypes.c_uint8),
            ctypes.c_int(B),
            ctypes.c_int(L),
            ctypes.c_int(mode),
            self._ptr(f_score, ctypes.c_float),
            self._ptr(b_score, ctypes.c_float),
            self._ptr(r_score, ctypes.c_float),
            self._ptr(bar_prob, ctypes.c_float),
            self._ptr(labels, ctypes.c_int32),
            ctypes.c_int(nthreads),
        )
        return f_score, b_score, r_score, bar_prob, labels

    def emit_read(self, state: int, avg_len: int):
        lib = get_lib()
        cap = 1 << 20
        out = np.zeros(cap, dtype=np.uint8)
        out_len = ctypes.c_int(0)
        new_state = lib.td_emit_read(
            ctypes.c_int(self.nm),
            self._ptr(self.H, ctypes.c_int),
            self._ptr(self.C, ctypes.c_int),
            self._ptr(self.skip, ctypes.c_float),
            self._ptr(self.trans, ctypes.c_float),
            self._ptr(self.me, ctypes.c_float),
            self._ptr(self.ie, ctypes.c_float),
            self._ptr(self.s2M, ctypes.c_float),
            self._ptr(self.s2I, ctypes.c_float),
            ctypes.c_uint32(state),
            ctypes.c_int(avg_len),
            self._ptr(out, ctypes.c_uint8),
            ctypes.c_int(cap),
            ctypes.byref(out_len),
        )
        return int(new_state), out[: out_len.value].copy()

    def emit_random(self, state: int, avg_len: int):
        lib = get_lib()
        cap = 1 << 20
        out = np.zeros(cap, dtype=np.uint8)
        out_len = ctypes.c_int(0)
        new_state = lib.td_emit_random(
            self._ptr(self.background, ctypes.c_float),
            ctypes.c_uint32(state),
            ctypes.c_int(avg_len),
            self._ptr(out, ctypes.c_uint8),
            ctypes.c_int(cap),
            ctypes.byref(out_len),
        )
        return int(new_state), out[: out_len.value].copy()

    # ---- batched emission (calibration's 400k-read default) ----
    # One native call per slab instead of one per read: the per-call ctypes
    # marshalling (~60us x 400k = ~24s) used to dominate every default-flag
    # run's calibration stage.  The C side records each read's rng ENTRY
    # state, so the rare read longer than the slab row (geometric R-segment
    # tail) is re-emitted alone through the single-read path without
    # perturbing the draw-for-draw LCG parity of the rest.
    _SLAB = 32768

    def _emit_batch(self, call_one, call_slab, state: int, avg_len: int,
                    n: int):
        cap = 4 * max(avg_len, 16) + 64
        seqs = []
        done = 0
        while done < n:
            m = min(self._SLAB, n - done)
            out = np.zeros((m, cap), dtype=np.uint8)
            lens = np.zeros(m, dtype=np.int32)
            entry = np.zeros(m, dtype=np.uint32)
            state = int(call_slab(state, avg_len, m, out, cap, lens, entry))
            for k in range(m):
                L = int(lens[k])
                if L > cap:  # truncated outlier: redo from its entry state
                    _, s = call_one(int(entry[k]), avg_len)
                    seqs.append(s)
                else:
                    # own copy: a view would pin the whole ~10-20MB slab
                    # alive per surviving read (~100-300MB of dead slab
                    # memory over a 400k-read calibration)
                    seqs.append(out[k, :L].copy())
            done += m
        return state, seqs

    def emit_read_batch(self, state: int, avg_len: int, n: int):
        lib = get_lib()

        def slab(st, al, m, out, cap, lens, entry):
            return lib.td_emit_read_batch(
                ctypes.c_int(self.nm),
                self._ptr(self.H, ctypes.c_int),
                self._ptr(self.C, ctypes.c_int),
                self._ptr(self.skip, ctypes.c_float),
                self._ptr(self.trans, ctypes.c_float),
                self._ptr(self.me, ctypes.c_float),
                self._ptr(self.ie, ctypes.c_float),
                self._ptr(self.s2M, ctypes.c_float),
                self._ptr(self.s2I, ctypes.c_float),
                ctypes.c_uint32(st),
                ctypes.c_int(al),
                ctypes.c_int(m),
                self._ptr(out, ctypes.c_uint8),
                ctypes.c_int(cap),
                self._ptr(lens, ctypes.c_int32),
                self._ptr(entry, ctypes.c_uint32),
            )

        return self._emit_batch(self.emit_read, slab, state, avg_len, n)

    def emit_random_batch(self, state: int, avg_len: int, n: int):
        lib = get_lib()

        def slab(st, al, m, out, cap, lens, entry):
            return lib.td_emit_random_batch(
                self._ptr(self.background, ctypes.c_float),
                ctypes.c_uint32(st),
                ctypes.c_int(al),
                ctypes.c_int(m),
                self._ptr(out, ctypes.c_uint8),
                ctypes.c_int(cap),
                self._ptr(lens, ctypes.c_int32),
                self._ptr(entry, ctypes.c_uint32),
            )

        return self._emit_batch(self.emit_random, slab, state, avg_len, n)
