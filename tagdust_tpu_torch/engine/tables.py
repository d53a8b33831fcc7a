"""Device tables of the port, built from the shared closure lattice.

Two entry points return the same dict of numpy arrays:

* ``tables_from_lattice(mb, lat)`` starts from the model bag and the shared
  ``tagdust_tpu.engine.lattice.compile_lattice`` output and builds the arrays
  ``TpuEngine.__init__`` builds (Lmap, ent_state, ent_sel, Afwd, Abwd, ...);
* ``tables_from_numpy(dev)`` starts from those arrays (the JAX engine's
  ``_dev`` dict, converted to numpy) and derives the kernel layouts.

So both packages provably start from identical parameters.  Kernel layouts:

* ``Ab`` [5, Sr, S]: ``Ab[c, t, s] = A[c][s, t]`` (the backward step reads
  ``b[t]`` and writes state ``s``; for a fixed ``t`` neighbouring threads
  read neighbouring ``s``);
* ``Af`` [5, Sr, S+K]: ``Af[c, s, t] = (A | Aent)[c][s, t]``;
* ``lab_ptr`` [H+1] / ``lab_idx``: the states of each label (CSR), which
  replaces the one-hot ``Lmap`` product by a per-label sum;
* ``Sr`` is S rounded up to 4; the pad rows are zero so the kernels can read
  the carry four states at a time.

The dense backward step (K1, K4) walks only the non-zero entries of ``Ab``,
listed per base and output state by ``sparse_tables``.  The grouped
(block-banded) step mode has its own tables, built from the shared
``lattice.grouped_step_decomposition`` by ``grouped_tables``.
"""

from __future__ import annotations

import numpy as np

from tagdust_tpu.engine.lattice import (
    Lattice,
    compile_lattice,
    grouped_step_decomposition,
)
from tagdust_tpu.model import ModelBag

# the JAX kernel packs one silent-exit column per segment into one 128-lane
# tile (pallas_kernel.py:128-148); the port keeps the same bound
MAX_SEGMENTS = 128
# an output of the sparse backward step with more inputs than this under
# some base goes to a warp of its own (sparse_tables)
HEAVY_INPUTS = 32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def tables_from_lattice(mb: ModelBag, lat: Lattice = None) -> dict:
    """The device tables of ``mb``; mirrors ``TpuEngine.__init__``."""
    lat = lat or compile_lattice(mb)
    S = lat.S
    K = lat.Aent.shape[2]
    ent_state = np.zeros(K, dtype=np.int32)
    k = 0
    si = 0
    for m in mb.models:
        for _ in range(m.num_hmms):
            if m.num_hmms > 1:
                ent_state[k] = si  # M(j,f,0)
                ent_state[k + 1] = si + 1  # I(j,f,0)
                k += 2
            si += 2 * m.num_cols
    Lmap = np.zeros((S, lat.num_labels + 1), dtype=np.float32)
    Lmap[np.arange(S), lat.state_label[:S]] = 1.0
    ent_sel = np.zeros((S, K), dtype=np.float32)
    ent_sel[ent_state, np.arange(K)] = 1.0
    # Afwd[(c,s), t] = (A | Aent)[c][s, t];  Abwd[(c,t), s] = A[c][s, t]
    Afwd = np.concatenate([lat.A, lat.Aent], axis=2).reshape(5 * S, S + K)
    Abwd = np.swapaxes(lat.A, 1, 2).reshape(5 * S, S)
    dev = {
        "Afwd": Afwd,
        "Abwd": Abwd,
        "end": lat.end,
        "Lmap": Lmap,
        "ent_state": ent_state,
        "ent_sel": ent_sel,
        "tmat": lat.tmatrix,
        "bg": lat.background,
        "avg_len": np.float32(lat.avg_len),
        "begin": lat.begin,
        "S": S,
        "K": K,
    }
    out = tables_from_numpy(dev)
    out["bar_segments"] = np.asarray(
        [(h, j) for (_, h, j) in lat.bar_segments], dtype=np.int64
    ).reshape(-1, 2)
    return out


def tables_from_numpy(dev: dict) -> dict:
    """Kernel and epilogue tables from the JAX engine's ``_dev`` arrays."""
    S = int(dev["S"])
    K = int(dev["K"])
    f32 = lambda x: np.ascontiguousarray(np.asarray(x, dtype=np.float32))  # noqa: E731
    Afwd = f32(dev["Afwd"])
    Abwd = f32(dev["Abwd"])
    Lmap = f32(dev["Lmap"])
    tmat = f32(dev["tmat"])
    H = tmat.shape[0]
    Sr = _round_up(S, 4)
    Af = np.zeros((5, Sr, S + K), dtype=np.float32)
    Af[:, :S, :] = Afwd.reshape(5, S, S + K)
    Ab = np.zeros((5, Sr, S), dtype=np.float32)
    Ab[:, :S, :] = Abwd.reshape(5, S, S)
    state_label = np.argmax(Lmap, axis=1).astype(np.int32)
    order = np.argsort(state_label, kind="stable")
    lab_idx = order[state_label[order] < H].astype(np.int32)
    lab_ptr = np.searchsorted(
        state_label[lab_idx], np.arange(H + 1)
    ).astype(np.int32)
    return {
        "Afwd": Afwd,
        "Abwd": Abwd,
        "Af": Af,
        "Ab": Ab,
        "end": f32(dev["end"]),
        "Lmap": Lmap,
        "state_label": state_label,
        "lab_ptr": lab_ptr,
        "lab_idx": lab_idx,
        "ent_state": np.asarray(dev["ent_state"], dtype=np.int32),
        "ent_sel": f32(dev["ent_sel"]),
        "tmat": tmat,
        "bg": f32(dev["bg"]),
        "avg_len": np.asarray(dev["avg_len"], dtype=np.float32),
        "begin": np.asarray(int(dev["begin"]), dtype=np.int64),
        "S": np.asarray(S, dtype=np.int64),
        "K": np.asarray(K, dtype=np.int64),
    }


def sparse_tables(Ab: np.ndarray) -> dict:
    """The non-zero entries of the dense backward step ``Ab`` [5, Sr, S]
    (``Ab[c, t, s] = A[c][s, t]``: input ``t``, output ``s``), per base and
    output state:

    * ``nz_ptr`` [5, S+1] int32: the inputs of output ``s`` under base ``c``
      are entries ``nz_ptr[c, s]`` to ``nz_ptr[c, s+1]`` of the two arrays
      below, which all bases share;
    * ``nz_idx`` [nnz] int32: the input states, ascending within an output;
    * ``nz_val`` [nnz] f32: ``Ab[c, t, s]``, copied;
    * ``nz_out`` [S] int32: the outputs, ascending, those with more than
      ``HEAVY_INPUTS`` inputs under some base (the silent states that fan
      out to every barcode) moved to the end;
    * ``nz_heavy``: the number of those heavy outputs.

    The kernel walks an output's inputs in ascending order, the order of
    the dense product's fmaf chain, and skips only exact zeros, so its sums
    equal the dense ones bit for bit.  A thread takes a light output for 8
    reads at a time; a warp takes a heavy one, a lane per read."""
    Ab = np.asarray(Ab, dtype=np.float32)
    S = Ab.shape[2]
    # C order of [c, s, t]: by base, then output, then ascending input
    c, s, t = np.nonzero(np.swapaxes(Ab, 1, 2))
    if c.size >= 2**31:
        raise ValueError(f"{c.size} non-zero step entries overflow int32")
    counts = np.bincount(c * S + s, minlength=5 * S).reshape(5, S)
    ptr = np.zeros((5, S + 1), dtype=np.int64)
    ptr[:, 1:] = np.cumsum(counts, axis=1)
    ptr += np.concatenate([[0], np.cumsum(counts.sum(axis=1))[:-1]])[:, None]
    heavy = counts.max(axis=0) > HEAVY_INPUTS
    return {
        "nz_ptr": ptr.astype(np.int32),
        "nz_idx": t.astype(np.int32),
        "nz_val": np.ascontiguousarray(Ab[c, t, s]),
        "nz_out": np.concatenate([np.nonzero(~heavy)[0],
                                  np.nonzero(heavy)[0]]).astype(np.int32),
        "nz_heavy": int(heavy.sum()),
    }


def grouped_tables(dec: dict, lat: Lattice) -> dict:
    """Kernel tables of the grouped step mode from the JAX package's
    decomposition dict (``grouped_step_decomposition``, numpy):

        A[c][s, t] = D[c][s, t] (s, t in one span)
                   + Uexit[s, seg[t]] * wvec[c, t]

    The spans are contiguous ranges of the original states, so the port
    keeps the original state order (no 128-lane ``gpos`` padding):

    * ``span`` [G, 3] int32: first state, width w, offset of the span's
      tiles in ``tile_f`` / ``tile_b``;
    * ``tile_f`` [5 * sum w^2]: span-major, then base, then [src][dst]
      (``D[c][s0:s1, s0:s1]``); ``tile_b`` holds each tile transposed;
    * ``span_of`` [S] int32: the span of each state;
    * ``uexit`` [nm, S]: the silent-exit rows, ``Uexit`` transposed;
    * ``wvec`` [5, S], ``seg`` [S] int32: the entry weight of each state and
      the segment it enters (``pallas_kernel.py:227-229``: a state with no
      entry weight falls in segment 0 with weight 0);
    * ``urows`` [NU] int32, ``uent`` [NU, K], ``eent`` [5, K]: the non-zero
      rows of ``Uent`` and the entry emissions, ``Aent = Uent * Eent``.
    """
    spans = [(int(a), int(b)) for a, b in dec["spans"]]
    D = np.asarray(dec["D"], dtype=np.float32)
    Went = np.asarray(dec["Went"], dtype=np.float32)
    S = lat.S
    span = np.zeros((len(spans), 3), dtype=np.int32)
    span_of = np.zeros(S, dtype=np.int32)
    tiles_f, tiles_b = [], []
    off = 0
    for g, (s0, s1) in enumerate(spans):
        blk = D[:, s0:s1, s0:s1]
        span[g] = (s0, s1 - s0, off)
        span_of[s0:s1] = g
        tiles_f.append(blk.reshape(-1))
        tiles_b.append(np.swapaxes(blk, 1, 2).reshape(-1))
        off += blk.size
    seg = Went.any(axis=0).argmax(axis=0).astype(np.int32)
    urows = np.nonzero((lat.Uent != 0).any(axis=1))[0].astype(np.int32)
    c32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)  # noqa: E731
    return {
        "span": span,
        "tile_f": c32(np.concatenate(tiles_f)),
        "tile_b": c32(np.concatenate(tiles_b)),
        "span_of": span_of,
        "uexit": c32(np.asarray(dec["Uexit"]).T),
        "wvec": c32(Went[:, seg, np.arange(S)]),
        "seg": seg,
        "urows": urows,
        "uent": c32(lat.Uent[urows]),
        "eent": c32(lat.Eent),
    }


def grouped_tables_from_lattice(mb: ModelBag, lat: Lattice = None):
    """``grouped_tables`` of ``mb``, or None where the lattice has no
    grouped form: a chain wider than a 128-state span, or more than
    ``MAX_SEGMENTS`` segments."""
    lat = lat or compile_lattice(mb)
    dec = grouped_step_decomposition(mb, lat)
    if dec is None or dec["Uexit"].shape[1] > MAX_SEGMENTS:
        return None
    return grouped_tables(dec, lat)
