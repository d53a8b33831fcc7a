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

The dense step of every kernel walks, per output, only the inputs with a
non-zero entry in its step matrix (``Ab`` for K1 and K4, ``Af`` for K2)
under some base, as ``sliced_tables`` lays them out (heavy outputs apart,
light outputs in slices of a warp's width, columns swizzled); K2's label DP
walks the non-zero entries of each column of ``tmat`` (``label_tables``).
``staged_tables`` packs a kernel's tables into one blob, of which the
kernel copies a prefix into shared memory.  The grouped (block-banded)
step mode has its own tables, built from
``lattice.grouped_step_decomposition`` by ``grouped_tables``.  The
Baum-Welch E-step kernel (``td_estep``) reads the non-zero entries of each
base's step matrix grouped by destination (``estep_tables``), split over
the blocks of a thread block cluster by destination state
(``estep_slices``).
"""

from __future__ import annotations

import numpy as np

from ..model import ModelBag
from .lattice import Lattice, compile_lattice, grouped_step_decomposition

# the JAX kernel packs one silent-exit column per segment into one 128-lane
# tile (pallas_kernel.py:128-148); the port keeps the same bound
MAX_SEGMENTS = 128
# an output of the dense step with more inputs than this goes to a warp of
# its own (sliced_tables)
HEAVY_INPUTS = 32
# an item of td_estep's entry table with more entries than this goes to a
# warp of its own, a lane a read (estep_slices)
HEAVY_ENTRIES = 32
# the tables a kernel reads from its blob, in the order of the word offsets
# of ``staged_tables`` (struct Staged of csrc/fused_dp.cu): K2's label-DP
# part, then the dense step's heavy part and light part; a kernel stages
# a prefix of the three parts in shared memory
LABEL_TABLES = ("tm_ptr", "tm_src", "tm_val", "tm_diag", "lab_ptr", "lab_idx",
                "ent_state")
HEAVY_TABLES = ("hv_ptr", "hv_out", "hv_ent")
LIGHT_TABLES = ("sl_ptr", "sl_out", "sl_idx", "sl_val")


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


def swizzle(s):
    """The place of column ``s`` in a dense kernel's carry row: ``s`` with
    its low five bits xor-ed by the next five, a permutation inside each
    block of 32 columns.  The light outputs' inputs are states a barcode's
    length apart (16 at 8nt), which would fall in a few of shared
    memory's 32 banks; swizzled, one load of a warp's 32 inputs meets
    about 1.2-1.7 of them (the step's x loads)."""
    return s ^ ((s >> 5) & 31)


def row_stride(n: int, lanes: int = 32) -> int:
    """Floats per carry row of ``n`` swizzled columns in the dense kernels
    whose per-read phases give each read ``lanes`` lanes: whole blocks of
    32, plus ``lanes + 1`` modulo 32, which is odd, so that the rows of a
    warp's 32 reads start in distinct banks (the heavy outputs' loads) and
    the rows of its lane groups ``lanes + 1`` banks apart."""
    return _round_up(n, 32) + (lanes + 1) % 32


def sliced_tables(M: np.ndarray, S: int) -> dict:
    """The dense step ``x -> x @ M[c]`` of a kernel (``Ab`` of K1 and K4,
    ``Af`` of K2; [5, Sr, nout]) as the dense kernels walk it.  Each output
    lists its inputs once for all bases, ascending: the union over the
    bases of its non-zero entries (one list on the barcode lattices, where
    the bases share the pattern), a base without an entry carrying 0.  A
    chain over that list is the dense chain: every term it adds beyond
    the non-zero ones is ``fmaf(x, 0, acc) == acc`` for the finite carries
    >= 0.

    * the heavy outputs, more than ``HEAVY_INPUTS`` inputs, longest first:
      ``hv_ptr`` [nh+1] int32, their entry rows; ``hv_out`` [nh] int32,
      the swizzled output column; ``hv_ent`` [rows, 5, 2] int32, per input
      and base the swizzled input and the value's bits (a warp walks one
      output, a lane per read, each lane its own base);
    * the light outputs, ascending by their count of inputs and cut into
      slices of 32 (a warp's lanes): ``sl_ptr`` [nsl+1] int32, the entry
      rows of each slice (its width is the most inputs of its outputs);
      ``sl_out`` [nsl, 32] int32, the swizzled output column of each lane
      (-1 past the last output); ``sl_idx`` [rows, 32] uint16, per row and
      lane the swizzled input (one for all bases), and ``sl_val`` [rows, 5,
      32] f32 its value under each base, padded past an output's inputs
      with input 0 and value 0.  At 96 x 8nt the light tables stream from
      L2 every position, so they are kept small: 2 + 4 bytes per entry and
      base present, against 8 for an (input, value) pair per base.

    Swizzled columns: ``swizzle``; the carries' rows are ``row_stride``
    floats apart."""
    M = np.asarray(M, dtype=np.float32)
    nout = M.shape[2]
    nz = (M[:, :S, :] != 0).any(axis=0)  # [S, nout]
    fan = nz.sum(axis=0)
    lists = [np.nonzero(nz[:, o])[0] for o in range(nout)]
    heavy = np.nonzero(fan > HEAVY_INPUTS)[0]
    heavy = heavy[np.argsort(-fan[heavy], kind="stable")]
    light = np.nonzero(fan <= HEAVY_INPUTS)[0]
    light = light[np.argsort(fan[light], kind="stable")]
    vals = np.ascontiguousarray(M.view(np.int32))

    def entries(o, width):
        """[width, 5, 2]: (swizzled input, value bits) of output o."""
        t = np.zeros(width, dtype=np.int64)
        t[: fan[o]] = lists[o]
        e = np.zeros((width, 5, 2), dtype=np.int32)
        e[:, :, 0] = swizzle(t)[:, None]
        e[: fan[o], :, 1] = vals[:, lists[o], o].T
        return e

    hv_ptr = np.concatenate([[0], np.cumsum(fan[heavy])]).astype(np.int32)
    hv_ent = (np.concatenate([entries(o, fan[o]) for o in heavy])
              if heavy.size else np.zeros((0, 5, 2), np.int32))
    nsl = -(-light.size // 32)
    widths = [int(fan[light[32 * i : 32 * i + 32]].max()) for i in range(nsl)]
    sl_ptr = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    sl_out = np.full((nsl, 32), -1, dtype=np.int32)
    sl_idx = np.zeros((int(sl_ptr[-1]), 32), dtype=np.uint16)
    sl_val = np.zeros((int(sl_ptr[-1]), 5, 32), dtype=np.float32)
    if -(-max(S, nout) // 32) * 32 > 1 << 16:
        raise ValueError(f"{nout} columns overflow the step tables' uint16 inputs")
    for i in range(nsl):
        outs = light[32 * i : 32 * i + 32]
        sl_out[i, : outs.size] = swizzle(outs)
        rows = slice(sl_ptr[i], sl_ptr[i + 1])
        for lane, o in enumerate(outs):
            e = entries(o, widths[i])
            sl_idx[rows, lane] = e[:, 0, 0]
            sl_val[rows, :, lane] = e[:, :, 1].view(np.float32)
    return {"hv_ptr": hv_ptr, "hv_out": swizzle(heavy).astype(np.int32),
            "hv_ent": hv_ent, "sl_ptr": sl_ptr, "sl_out": sl_out, "sl_idx": sl_idx,
            "sl_val": sl_val}


def estep_tables(A: np.ndarray) -> dict:
    """The entry table of the E-step kernel ``td_estep`` (csrc/estep.cu):
    the non-zero entries ``(c, s, t)`` of the step matrices ``A`` [5, S, S]
    (as float32), per base grouped by destination ``t``, so that the thread
    that computes ``vn[t]`` for a base's reads owns every entry into ``t``.

    * ``dst_ptr`` [6] int32: base c's destinations are items
      ``dst_ptr[c]:dst_ptr[c+1]``;
    * ``dst`` [items] int32: each item's destination, ascending per base;
    * ``ent_ptr`` [items+1] int32: item i's entries are
      ``ent_ptr[i]:ent_ptr[i+1]``;
    * ``src`` [nnz] int32 and ``val`` [nnz] f32: each entry's source,
      ascending per item, and ``A[c][s, t]``;
    * ``flat`` [nnz] int32: each entry's index in the flat transition mass
      of ``parallel.mesh.count_tables`` (per base in ``np.nonzero``'s
      row-major order, the bases end to end), where the kernel writes it."""
    A = np.asarray(A, dtype=np.float32)
    dst_ptr, dst, ent_ptr, src, val, flat = [0], [], [[0]], [], [], []
    base = 0
    for c in range(5):
        s, t = np.nonzero(A[c])  # row-major: count_tables' order
        order = np.lexsort((s, t))  # by destination, then source
        ts, ss = t[order], s[order]
        items, starts = np.unique(ts, return_index=True)
        dst.append(items)
        ent_ptr.append(base + np.append(starts[1:], ts.size)[: items.size])
        dst_ptr.append(dst_ptr[-1] + items.size)
        src.append(ss)
        val.append(A[c, ss, ts])
        flat.append(base + order)
        base += ts.size
    i32 = lambda parts: np.concatenate(parts).astype(np.int32)  # noqa: E731
    return {"dst_ptr": np.asarray(dst_ptr, np.int32), "dst": i32(dst),
            "ent_ptr": i32(ent_ptr), "src": i32(src),
            "val": np.concatenate(val).astype(np.float32), "flat": i32(flat)}


def slice_bounds(weight: np.ndarray, C: int) -> np.ndarray:
    """[C+1] int32: C contiguous ranges ``[t_j, t_{j+1})`` of the states
    balanced by ``weight`` [S] (the shared bytes of each state): each bound
    the state whose cumulative weight is nearest ``j sum / C``, at least one
    state past the last, so that each range's weight lies within the
    largest weight of one state of ``sum / C``."""
    S = weight.size
    cum = np.concatenate([[0.0], np.cumsum(weight, dtype=np.float64)])
    bounds = [0]
    for j in range(1, C):
        target = j * cum[-1] / C
        t = int(np.searchsorted(cum, target))
        if t > 0 and target - cum[t - 1] <= cum[t] - target:
            t -= 1
        bounds.append(min(max(t, bounds[-1] + 1), S - (C - j)))
    return np.asarray(bounds + [S], np.int32)


def carry_offset(row, P: int):
    """The word offset of carry row ``row`` in ``td_estep``'s shared
    memory: rows of P floats (a read each), and one padding word after each
    32 rows, so that rows a barcode apart fall in distinct banks
    (csrc/estep.cu:cofs)."""
    return row * P + (row >> 5)


def estep_slices(et: dict, S: int, t0: np.ndarray, P: int) -> dict:
    """``estep_tables`` ``et`` split over the blocks of a thread block
    cluster of ``td_estep`` (csrc/estep.cu), rows of P floats: block j owns
    the states ``t0[j]:t0[j+1]``, their carries, and every item ``(c, t)``
    with t in that range.  Per block, per base, one item for every state of
    the range (an empty one where A[c] has no entry into it, so that the
    step writes every cell of the next carry), by entry count descending
    (ascending state among equals), so the lanes of a warp take items of
    about one length; the items of more than ``HEAVY_ENTRIES`` entries,
    a warp's each, come first.  A block's carry has a row for each of its
    states, then a halo row for each state of another block that one of its
    entries reads; the owner of that state pushes its value there after
    each rescale, so the step reads only its own shared memory.

    * ``t0`` [C+1];
    * ``ent_off`` / ``item_off`` [C+1]: block j's entries and items;
    * ``ibase`` [C, 6]: base c's items of block j are ``ibase[j, c]`` to
      ``ibase[j, c+1]``, counted from ``item_off[j]``; ``nheavy`` [C, 5]:
      the heavy ones among them;
    * ``ient`` [items + C]: block j's ``ni_j + 1`` entry offsets, counted
      from ``ent_off[j]``; ``idst`` [items]: each item's state, counted from
      ``t0[j]``;
    * ``ekey`` [nnz]: each entry's source row (``carry_offset``, its own
      row or its halo row in the entry's block, < 2^16), ``eval`` [nnz]
      f32: ``A[c][s, t]``; ``eidx`` [nnz]: the entry's index in ``et``;
    * ``halo_off`` [C+1] / ``halo`` [rows]: block j's halo rows, each a
      state of another block, ascending;
    * ``push_off`` [C+1] / ``push`` [pushes, 2] int32: block j's pushes,
      (the word offset of its row of the state, ``(rank << 24) |`` the word
      offset of the halo row in block ``rank``).

    Within an item the entries keep ``et``'s ascending source."""
    t0 = np.asarray(t0, np.int32)
    C = t0.size - 1
    width = np.diff(t0)
    rank = np.repeat(np.arange(C), width)  # [S] the block of each state
    cnt = np.diff(et["ent_ptr"])
    dst_of = np.repeat(et["dst"], cnt)
    halos = [np.unique(et["src"][(rank[dst_of] == j) & (rank[et["src"]] != j)])
             for j in range(C)]
    eidx, ient, idst, ibase, nheavy, rows = [], [], [], [], [], []
    for j in range(C):
        a, b = int(t0[j]), int(t0[j + 1])
        row = np.full(S, -1, np.int64)  # the row of each state block j reads
        row[a:b] = np.arange(b - a)
        row[halos[j]] = b - a + np.arange(halos[j].size)
        ib, starts, first_entry = [0], [0], len(eidx)
        for c in range(5):
            # every state of the range an item, with et's entries into it
            items = np.arange(et["dst_ptr"][c], et["dst_ptr"][c + 1])
            items = items[(et["dst"][items] >= a) & (et["dst"][items] < b)]
            n = np.zeros(b - a, np.int64)
            first = np.zeros(b - a, np.int64)
            n[et["dst"][items] - a] = cnt[items]
            first[et["dst"][items] - a] = et["ent_ptr"][items]
            order = np.lexsort((np.arange(b - a), -n))
            idst.append(order)
            eidx += [np.arange(first[t], first[t] + n[t]) for t in order]
            starts += list(starts[-1] + np.cumsum(n[order]))
            ib.append(ib[-1] + b - a)
            nheavy.append(int((n > HEAVY_ENTRIES).sum()))
        e = (np.concatenate(eidx[first_entry:]) if len(eidx) > first_entry
             else np.zeros(0, np.int64))
        rows.append(row[et["src"][e]])
        ient.append(starts)
        ibase.append(ib)
    push = [[] for _ in range(C)]
    for q in range(C):
        for h, st in enumerate(halos[q]):
            j = int(rank[st])
            push[j].append((carry_offset(int(st - t0[j]), P),
                            (q << 24) | carry_offset(int(width[q]) + h, P)))
    eidx = np.concatenate(eidx).astype(np.int32)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    cum = lambda n: i32(np.concatenate([[0], np.cumsum(n)]))  # noqa: E731
    return {"t0": t0, "ent_off": cum([s[-1] for s in ient]),
            "item_off": cum(width * 5), "ibase": i32(ibase),
            "nheavy": i32(nheavy).reshape(C, 5), "ient": i32(np.concatenate(ient)),
            "idst": i32(np.concatenate(idst)),
            "ekey": i32(carry_offset(np.concatenate(rows), P)), "eval": et["val"][eidx],
            "eidx": eidx, "halo_off": cum([h.size for h in halos]),
            "halo": i32(np.concatenate(halos)),
            "push_off": cum([len(x) for x in push]),
            "push": i32([x for xs in push for x in xs]).reshape(-1, 2)}


def estep_state_bytes(et: dict, S: int, P: int) -> np.ndarray:
    """[S] the shared bytes that each state costs the block of ``td_estep``
    that owns it at rows of P floats: its two carry rows, its five items (a
    16-bit entry offset and state each) and the entries into it (an f64
    sum, an f32 value and a 16-bit source row each).  A block adds its halo
    rows, pushes and padding (``estep_block_bytes``)."""
    n = np.bincount(et["dst"], weights=np.diff(et["ent_ptr"]), minlength=S)
    return 8 * P + 20 + 14 * n.astype(np.int64)


def estep_block_bytes(et: dict, S: int, t0: np.ndarray, P: int) -> np.ndarray:
    """[C] the dynamic shared bytes of each block of ``td_estep`` for the
    split ``t0`` of ``estep_tables`` ``et`` at rows of P floats, as
    csrc/estep.cu lays out ``estep_slices``: the carry (its rows and halo
    rows) and the next carry (its rows), each with its padding words,
    rounded up to 8 bytes; per entry its f64 sum, its f32 value and its
    16-bit source row; per push 8
    bytes; per item (5 a state) a 16-bit entry offset and a 16-bit state,
    and one offset more."""
    t0 = np.asarray(t0)
    width = np.diff(t0)
    rank = np.repeat(np.arange(width.size), width)
    dst_of = np.repeat(et["dst"], np.diff(et["ent_ptr"]))
    src = et["src"]
    ne = np.bincount(rank[dst_of], minlength=width.size)
    # (reader, state) pairs of the halos, each a halo row and a push
    far = np.unique(rank[dst_of] * S + src)
    far = far[rank[far % S] != far // S]
    nh = np.bincount(far // S, minlength=width.size)
    npush = np.bincount(rank[far % S], minlength=width.size)
    words = carry_offset(width + nh - 1, P) + carry_offset(width - 1, P) + 2 * P
    return 8 * ((words + 1) // 2) + 14 * ne + 8 * npush + 20 * width + 2


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
    """(blob, tab): the tables a kernel reads, packed into one int32 blob
    (f32 tables by their bits, uint16 ones two to a word), and ``tab``,
    int32: the word offset of each
    table of ``LABEL_TABLES``, ``HEAVY_TABLES`` and ``LIGHT_TABLES`` in the
    blob (0 where absent), the heavy outputs and light slices of the step
    (``sliced_tables``), and the words of the label, heavy and light parts.
    Every table starts on 16 bytes and each part is a multiple of 16
    bytes, so one bulk copy moves a prefix of the parts into shared
    memory."""
    words, tab, sizes = [], [], []
    n = 0
    parts = ((LABEL_TABLES, label), (HEAVY_TABLES, step), (LIGHT_TABLES, step))
    for names, part in parts:
        start = n
        for name in names:
            if part is None:
                tab.append(0)
                continue
            a = np.ascontiguousarray(part[name]).reshape(-1)
            if a.dtype == np.uint16:  # two to a word
                a = np.concatenate([a, np.zeros(a.size % 2, np.uint16)]).view(np.int32)
            a = a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int32)
            pad = -a.size % 4
            tab.append(n)
            words.append(np.concatenate([a, np.zeros(pad, np.int32)]))
            n += a.size + pad
        sizes.append(n - start)
    counts = ([step["hv_out"].size, step["sl_out"].shape[0]] if step is not None
              else [0, 0])
    blob = np.concatenate(words) if words else np.zeros(0, np.int32)
    return blob, np.asarray(tab + counts + sizes, dtype=np.int32)


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
