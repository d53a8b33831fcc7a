"""The tables of the dense backward step (K1, K4).

``tables.sliced_tables`` lays out, per output state, the inputs with a
non-zero entry of ``Ab`` under some base: the heavy outputs apart, the
light ones in slices of 32, columns swizzled; the dense ``td_bwd`` /
``td_bwd_score`` kernels walk those.  The kernels run only on a card, so
these tests hold the tables to what the kernel relies on: they rebuild
``Ab`` bit for bit, list the inputs of each output strictly ascending (the
order of the dense fmaf chain) with zero values only where a base lacks an
entry or past an output's inputs, and a plain step over them (one chain per
(read, output), as the kernels run it) equals the chain over every input,
zeros included, bit for bit, and ``x @ A[c]^T`` of the JAX package's
lattice within f32 rounding.  A whole backward recurrence over the tables
is held against the JAX scan engine's ``_backward_scores``.
"""

import functools

import numpy as np
import pytest
import torch

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.engine.lattice import compile_lattice
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats

from tagdust_tpu_torch.engine import scan
from tagdust_tpu_torch.engine.fused_kernel import FusedScorer
from tagdust_tpu_torch.engine.tables import (
    HEAVY_INPUTS,
    grouped_tables_from_lattice,
    sliced_tables,
    staged_tables,
    swizzle,
    tables_from_lattice,
)
from tagdust_tpu_torch.flagship import PLATE_PATH, generate_barcodes, load_barcodes

# the libraries of the sizes the dense step meets: 8 x 6nt (the 8-plex main
# path), the flagship, 48 x 8nt, the 96 x 8nt plate, a fingerprint + spacer
# grammar, and a 68nt spacer with no grouped form
LIBS = {
    "8x6nt": [f"B:{','.join(generate_barcodes(8, 6, 3))}", "R:N"],
    "flagship": [f"B:{','.join(load_barcodes())}", "R:N"],
    "48x8nt": [f"B:{','.join(generate_barcodes(48, 8, 3))}", "R:N"],
    "plate": [f"B:{','.join(load_barcodes(PLATE_PATH))}", "R:N"],
    "F+B+S+R": ["F:NN", "B:ACGTAC,TGCATG,CCAAGG", "S:TA", "R:N"],
    "S68+R": ["S:" + "ACGT" * 17, "R:N"],
}


def _model(segs):
    """``segs`` with the sequence stats of chip_smoke.library_model."""
    ssi = SequenceStats()
    ssi.average_length = 50
    ssi.max_seq_len = 64
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(build_read_structure(segs), ssi, 0.05, 0.1)


@functools.lru_cache(maxsize=None)
def _lib(name):
    """(model, lattice, tables, step tables of Ab) of one library."""
    mb = _model(LIBS[name])
    lat = compile_lattice(mb)
    t = tables_from_lattice(mb, lat)
    return mb, lat, t, sliced_tables(t["Ab"], lat.S)


def unsliced(sl, nout):
    """[(output, inputs [n], values [n, 5])] of every output of the step
    tables ``sl`` (``sliced_tables``), columns unswizzled (swizzle is its
    own inverse), the padding past each output's inputs dropped."""
    out = []
    hp = sl["hv_ptr"]
    for h, o in enumerate(sl["hv_out"]):
        e = sl["hv_ent"][hp[h] : hp[h + 1]]
        out.append((int(swizzle(o)), swizzle(e[:, 0, 0]), e[:, :, 1].view(np.float32)))
    sp = sl["sl_ptr"]
    for i in range(sl["sl_out"].shape[0]):
        ix = sl["sl_idx"][sp[i] : sp[i + 1]].astype(np.int64)  # [W, 32]
        vl = sl["sl_val"][sp[i] : sp[i + 1]]  # [W, 5, 32]
        for lane, o in enumerate(sl["sl_out"][i]):
            if o < 0:
                continue
            idx = swizzle(ix[:, lane])
            val = vl[:, :, lane]
            n = max([k + 1 for k in range(len(idx)) if val[k].any()], default=0)
            out.append((int(swizzle(o)), idx[:n], val[:n]))
    assert sorted(o for o, _, _ in out) == list(range(nout))
    return out


def chain(x, oh, M):
    """The dense step as one chain per (read, output) over every input in
    ascending order, zeros included: the order of the kernels' chains."""
    out = torch.zeros((x.shape[0], M.shape[2]))
    for c in range(5):
        rows = oh[:, c] > 0
        acc = torch.zeros((int(rows.sum()), M.shape[2]))
        for s in range(x.shape[1]):
            acc = acc + x[rows, s : s + 1] * M[c, s]
        out[rows] = acc
    return out


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_tables_rebuild_Ab_bit_for_bit(name):
    """Every non-zero entry of ``Ab`` is listed once, at its input and
    base, and nothing else is non-zero."""
    _, lat, t, sl = _lib(name)
    Ab = t["Ab"]
    S = lat.S
    back = np.zeros_like(Ab)
    for o, idx, val in unsliced(sl, S):
        back[:, idx, o] = val.T
    assert np.array_equal(back.view(np.uint32), Ab.view(np.uint32))


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_tables_ascending_without_zeros(name):
    """Each output's inputs are strictly ascending real states, each with a
    non-zero value under some base; the padding of a light slice past an
    output's inputs is input 0 with value 0; a slice is as wide as its
    widest output."""
    _, lat, t, sl = _lib(name)
    S = lat.S
    for o, idx, val in unsliced(sl, S):
        assert (np.diff(idx) > 0).all() and (idx >= 0).all() and (idx < S).all()
        assert val.any(axis=1).all()
        assert np.array_equal(val != 0, (t["Ab"][:, idx, o] != 0).T)
    sp = sl["sl_ptr"]
    for i in range(sl["sl_out"].shape[0]):
        ix, vl = sl["sl_idx"][sp[i] : sp[i + 1]], sl["sl_val"][sp[i] : sp[i + 1]]
        fans = [int(np.count_nonzero((t["Ab"][:, :, swizzle(o)] != 0).any(axis=0)))
                for o in sl["sl_out"][i] if o >= 0]
        assert ix.shape[0] == max(fans, default=0)
        for lane, f in enumerate(fans):
            assert (ix[f:, lane] == 0).all() and (vl[f:, :, lane] == 0).all()
    for k in ("hv_ptr", "hv_out", "hv_ent", "sl_ptr", "sl_out"):
        assert sl[k].dtype == np.int32
    assert sl["sl_idx"].dtype == np.uint16 and sl["sl_val"].dtype == np.float32


# heavy outputs per library (more than HEAVY_INPUTS inputs): the silent
# state that fans out to the barcode entries (45 inputs at 8 x 6nt, 105 on
# the flagship, 679 on the plate), and the 68nt spacer's delete-chain
# closure (51)
HEAVY = {"8x6nt": 1, "flagship": 1, "48x8nt": 1, "plate": 1, "F+B+S+R": 0, "S68+R": 1}


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_tables_put_heavy_outputs_last(name):
    """The heavy outputs, those with more than HEAVY_INPUTS inputs, are
    apart, longest first; the light ones fill slices of 32 in ascending
    order of their inputs' count, -1 past the last; every output once."""
    _, lat, t, sl = _lib(name)
    fan = (t["Ab"][:, : lat.S] != 0).any(axis=0).sum(axis=0)
    hv = swizzle(sl["hv_out"])
    assert hv.size == HEAVY[name] and (fan[hv] > HEAVY_INPUTS).all()
    assert (np.diff(fan[hv]) <= 0).all()
    assert np.array_equal(np.diff(sl["hv_ptr"]), fan[hv])
    lo = sl["sl_out"].reshape(-1)
    assert (lo[: (lo >= 0).sum()] >= 0).all()
    light = swizzle(lo[lo >= 0])
    assert (fan[light] <= HEAVY_INPUTS).all() and (np.diff(fan[light]) >= 0).all()
    np.testing.assert_array_equal(np.sort(np.concatenate([hv, light])), np.arange(lat.S))


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_step_equals_the_dense_step(name):
    """On random carries >= 0 with exact zeros and random bases (code 5:
    the zero step), the plain step over the tables equals the chain over
    all of Ab bit for bit, the plain dense step and the lattice's A[c]^T
    within f32 rounding of another sum order (atol 1e-6, rtol 1e-5)."""
    _, lat, t, sl = _lib(name)
    S = lat.S
    rng = np.random.default_rng(7)
    B = 24
    xv = rng.random((B, S)).astype(np.float32)
    xv[rng.random((B, S)) < 0.3] = 0.0
    x = torch.from_numpy(xv)
    codes = torch.from_numpy(rng.integers(0, 6, B).astype(np.uint8))
    oh = scan._onehot(codes[:, None])[:, 0]
    got = scan.sliced_step(x, oh, sl, S)
    assert torch.equal(got, chain(x, oh, torch.from_numpy(t["Ab"][:, :S])))
    dense = scan._dense_step(torch.from_numpy(t["Abwd"]))(x, oh)
    torch.testing.assert_close(got, dense, atol=1e-6, rtol=1e-5)
    ref = np.zeros((B, S))
    for r in range(B):
        if codes[r] < 5:
            ref[r] = lat.A[codes[r]].astype(np.float64) @ x[r].double().numpy()
    torch.testing.assert_close(got.double(), torch.from_numpy(ref), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["8x6nt", "F+B+S+R", "S68+R"])
def test_sparse_recurrence_matches_jax_backward_scores(name):
    """The rescaled backward recurrence over the tables (the plain K4 with
    its step taken from the tables) against the JAX scan engine's
    ``_backward_scores`` on the same reads (atol 1e-5 as in
    test_backward_scores_match_k1_and_jax, and rtol 1e-6: logP_b reaches
    -200 here, where one f32 step is 1.5e-5), all long enough to pass the
    68nt spacer: a read the model cannot emit has logP_b -inf in the scan
    engine and log(1e-38) + its scales in the kernels."""
    import jax
    import jax.numpy as jnp

    from tagdust_tpu.engine.tpu import TpuEngine, _backward_scores

    mb, lat, t, sp = _lib(name)
    rng = np.random.default_rng(5)
    B, L = 16, 96
    seqs = rng.integers(0, 5, (B, L)).astype(np.uint8)
    lens = rng.integers(72, L + 1, B).astype(np.int32)
    got = scan._backward(torch.from_numpy(seqs), torch.from_numpy(lens),
                         lambda x, oh: scan.sliced_step(x, oh, sp, lat.S), torch.from_numpy(t["end"]),
                         int(t["begin"]), spill=False)[2]
    jx = TpuEngine(mb)
    ref = np.asarray(jax.jit(functools.partial(_backward_scores, jx._dev))(
        jnp.asarray(seqs.astype(np.int32)), jnp.asarray(lens)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_sparse_tables_of_the_pallas_step_matrix():
    """The tables built from the dense backward matrix that the JAX
    package's ``make_fused_scorer`` builds for its kernel (read from the
    call's closure) equal the port's."""
    import inspect

    from tagdust_tpu.engine import pallas_kernel as PK
    from tagdust_tpu.engine.tpu import TpuEngine

    mb = _model(LIBS["F+B+S+R"])
    eng = TpuEngine(mb)
    lat = eng.lat
    call, Sp, _, _ = PK.make_fused_scorer(
        lat.A, lat.Uent, lat.Eent, lat.end, np.asarray(eng._dev["Lmap"]),
        np.asarray(eng._dev["ent_sel"]), lat.begin, 16, 8, interpret=True,
        tmatrix=np.asarray(eng._dev["tmat"]),
    )
    abwd = np.asarray(inspect.getclosurevars(call).nonlocals["Abwd_j"])
    S = lat.S
    theirs = sliced_tables(abwd.reshape(5, Sp, -1)[:, :, :S], S)
    ours = sliced_tables(tables_from_lattice(mb, lat)["Ab"], S)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_fused_scorer_holds_the_tables_in_dense_mode():
    """Dense: K1/K4's blob holds the step tables of ``Ab`` (a buffer beside
    ``Ab``) and they get its pointer and the address of its word offsets
    (and no step matrix); grouped: an empty blob, K1/K4 get the span
    tiles, and K2 the forward ones beside its label-DP blob."""
    mb, lat, t, sl = _lib("flagship")
    dense = FusedScorer(t)
    blob, tab = staged_tables(None, sl)
    np.testing.assert_array_equal(dense.blob_bwd.numpy(), blob)
    np.testing.assert_array_equal(dense.tabs["bwd"], tab)
    for i, k in enumerate(("hv_ptr", "hv_out", "hv_ent", "sl_ptr", "sl_out", "sl_idx",
                           "sl_val")):
        want = sl[k].reshape(-1)
        got = blob[tab[7 + i] :].view(want.dtype)[: want.size]
        np.testing.assert_array_equal(got, want)
    assert tab[14] == sl["hv_out"].size == 1 and tab[15] == sl["sl_out"].shape[0] == 8
    assert {"Abwd", "blob_bwd", "blob_fwd"} <= {n for n, _ in dense.named_buffers()}
    args = dense._step_args("bwd")
    assert len(args) == 8 and args[:6] == [None] * 6
    assert args[6:] == [dense.blob_bwd.data_ptr(), dense.tabs["bwd"].ctypes.data]
    g = grouped_tables_from_lattice(mb, lat)
    grouped = FusedScorer(t, g)
    assert grouped.blob_bwd.numel() == 0 and not grouped.tabs["bwd"].any()
    args = grouped._step_args("bwd")
    assert len(args) == 8 and args[0] == grouped.g_tile_b.data_ptr() and args[6] is None
    args = grouped._step_args("fwd")
    assert args[0] == grouped.g_tile_f.data_ptr()
    assert args[6] == grouped.blob_fwd.data_ptr() and grouped.tabs["fwd"][16] > 0
    assert grouped._key("bwd") == "bwd_grouped" and grouped._key("fwd") == "fwd_grouped"


@pytest.mark.parametrize("n", [1, 31, 255, 1555, 2313])
def test_swizzle_permutes_each_block_of_32(n):
    """``swizzle`` maps each block of 32 columns onto itself (so a row of n
    columns fits ``row_stride(n)`` floats, which is odd), is its own
    inverse, and spreads columns 32 apart over distinct banks."""
    from tagdust_tpu_torch.engine.tables import row_stride

    s = np.arange(-(-n // 32) * 32)
    p = swizzle(s)
    assert np.array_equal(np.sort(p.reshape(-1, 32), axis=1), s.reshape(-1, 32))
    assert np.array_equal(swizzle(p), s)
    for lanes in (4, 8, 16, 32):
        assert row_stride(n, lanes) % 2 == 1 and row_stride(n, lanes) > p[:n].max()
    for j in range(min(32, n)):
        col = p[j::32][:32]
        assert np.unique(col % 32).size == col.size
