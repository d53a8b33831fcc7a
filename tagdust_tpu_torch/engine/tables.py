"""Device tables of the port, built from the closure lattice.

Two entry points return the same dict of numpy arrays:

* ``tables_from_lattice(mb, lat)`` starts from the model bag and the
  ``engine.lattice.compile_lattice`` output (this package's copy of the
  JAX package's closure compiler) and builds the arrays
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

The dense step of every kernel walks only the non-zero entries of its step
matrix (``Ab`` for K1 and K4, ``Af`` for K2), listed per base and output
state by ``sparse_tables``; K2's label DP walks the non-zero entries of each
column of ``tmat`` (``label_tables``).  ``staged_tables`` packs the tables a
kernel copies into shared memory into one blob.  The grouped (block-banded)
step mode has its own tables, built from
``lattice.grouped_step_decomposition`` by ``grouped_tables``.
"""

from __future__ import annotations

import numpy as np

from ..model import ModelBag
from .lattice import Lattice, compile_lattice, grouped_step_decomposition

# the JAX kernel packs one silent-exit column per segment into one 128-lane
# tile (pallas_kernel.py:128-148); the port keeps the same bound
MAX_SEGMENTS = 128
# an output of the sparse step with more inputs than this under some base
# goes to a warp of its own (sparse_tables)
HEAVY_INPUTS = 32
# the tables a kernel stages in shared memory, in the order of the word
# offsets of ``staged_tables`` (struct Staged of csrc/fused_dp.cu): K2's
# label-DP part, then the sparse step's part
LABEL_TABLES = ("tm_ptr", "tm_src", "tm_val", "tm_diag", "lab_ptr", "lab_idx",
                "ent_state")
STEP_TABLES = ("nz_ptr", "nz_idx", "nz_val", "nz_out")


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
    """The non-zero entries of a dense step matrix [5, Sr, S]: input, then
    output (``Ab[c, t, s] = A[c][s, t]`` of K1 and K4, with S outputs;
    ``Af`` of K2, with S + K outputs, the states then the barcode entry
    columns), per base and output:

    * ``nz_ptr`` [5, S+1] int32: the inputs of output ``s`` under base ``c``
      are entries ``nz_ptr[c, s]`` to ``nz_ptr[c, s+1]`` of the two arrays
      below, which all bases share;
    * ``nz_idx`` [nnz] int32: the input states, ascending within an output;
    * ``nz_val`` [nnz] f32: ``Ab[c, t, s]``, copied;
    * ``nz_out`` [S] int32: the outputs, ascending, those with more than
      ``HEAVY_INPUTS`` inputs under some base (K1: the silent states that
      fan out to every barcode; K2: the states that collect from every
      barcode) moved to the end;
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


def label_tables(tmat: np.ndarray) -> dict:
    """The non-zero entries of each column of the label transition matrix
    ``tmat`` [H, H], K2's label DP ``ndp[j] = plab[j] + max_c dp[c] *
    tmat[c, j]``:

    * ``tm_ptr`` [H+1] int32: the sources of label ``j`` are entries
      ``tm_ptr[j]`` to ``tm_ptr[j+1]`` of the two arrays below;
    * ``tm_src`` [nnz] int32: the sources ``c``, ascending within a label;
    * ``tm_val`` [nnz] f32: ``tmat[c, j]``, copied;
    * ``tm_diag`` [H] f32: the diagonal, for the DP's diagonal override.

    A source left out has ``tmat[c, j] == 0``: with dp finite and >= 0 its
    candidate is exactly 0, which the full loop's first source (c = 0)
    already offers, so the DP takes (0, source 0) when no listed candidate
    is above 0.  That needs every candidate >= 0: ``tmat`` must be finite
    and non-negative (a 0/1 matrix from the lattice)."""
    tmat = np.asarray(tmat, dtype=np.float32)
    if not (np.isfinite(tmat).all() and (tmat >= 0).all()):
        raise ValueError("the label DP needs a finite, non-negative tmatrix")
    H = tmat.shape[0]
    # C order of [j, c]: by label, then ascending source
    j, c = np.nonzero(tmat.T)
    ptr = np.zeros(H + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(j, minlength=H))
    return {
        "tm_ptr": ptr,
        "tm_src": c.astype(np.int32),
        "tm_val": np.ascontiguousarray(tmat[c, j]),
        "tm_diag": np.ascontiguousarray(np.diagonal(tmat)),
    }


def staged_tables(label: dict = None, step: dict = None):
    """(blob, tab): the tables a kernel copies into shared memory, packed
    into one int32 blob (f32 tables by their bits), and ``tab``, int32: the
    word offset of each table of ``LABEL_TABLES`` then ``STEP_TABLES`` in
    the blob (0 where absent), the number of heavy outputs of the step,
    and the words of the label part and of the step part.  Every table
    starts on 16 bytes and each part is a multiple of 16 bytes, so one bulk
    copy moves the label part, or both parts, into shared memory."""
    words, tab, sizes = [], [], []
    n = 0
    for names, part in ((LABEL_TABLES, label), (STEP_TABLES, step)):
        start = n
        for name in names:
            if part is None:
                tab.append(0)
                continue
            a = np.ascontiguousarray(part[name]).reshape(-1)
            a = a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int32)
            pad = -a.size % 4
            tab.append(n)
            words.append(np.concatenate([a, np.zeros(pad, np.int32)]))
            n += a.size + pad
        sizes.append(n - start)
    nh = int(step["nz_heavy"]) if step is not None else 0
    blob = np.concatenate(words) if words else np.zeros(0, np.int32)
    return blob, np.asarray(tab + [nh] + sizes, dtype=np.int32)


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
