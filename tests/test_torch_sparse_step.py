"""The non-zero tables of the dense backward step (K1, K4).

``tables.sparse_tables`` lists, per base and output state, the non-zero
entries of ``Ab``; the dense ``td_bwd`` / ``td_bwd_score`` kernels walk only
those.  The kernels run only on a card, so these tests hold the tables to
what the kernel relies on: they rebuild ``Ab`` bit for bit, list the inputs
of each output strictly ascending (the order of the dense fmaf chain) and
store no zero, and a step computed from them (a gather and ``index_add_``)
equals the plain dense step ``scan._dense_step(Abwd)`` and ``x @ A[c]^T`` of
the JAX package's lattice; a transposed table (``Ab`` against ``A``) fails
the last two.  A whole backward recurrence over the tables is held against
the JAX scan engine's ``_backward_scores``.
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
    sparse_tables,
    staged_tables,
    tables_from_lattice,
)
from tagdust_tpu_torch.flagship import generate_barcodes, load_barcodes

# the libraries of the sizes the dense step meets: 8 x 6nt (the dense main
# path), the flagship, 48 x 8nt, a fingerprint + spacer grammar, and a 68nt
# spacer with no grouped form
LIBS = {
    "8x6nt": [f"B:{','.join(generate_barcodes(8, 6, 3))}", "R:N"],
    "flagship": [f"B:{','.join(load_barcodes())}", "R:N"],
    "48x8nt": [f"B:{','.join(generate_barcodes(48, 8, 3))}", "R:N"],
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
    """(model, lattice, tables, sparse tables) of one library."""
    mb = _model(LIBS[name])
    lat = compile_lattice(mb)
    t = tables_from_lattice(mb, lat)
    return mb, lat, t, sparse_tables(t["Ab"])


def _sparse_step(sp, S):
    """One backward step ``x -> x @ A[base]^T`` from the tables: per base, a
    gather of the inputs times the values, summed into the outputs with
    ``index_add_`` (another order than the kernel's chains)."""
    ptr = torch.from_numpy(sp["nz_ptr"]).long()
    idx = torch.from_numpy(sp["nz_idx"]).long()
    val = torch.from_numpy(sp["nz_val"])

    def step(x, oh):
        out = torch.zeros_like(x)
        for c in range(5):
            rows = torch.nonzero(oh[:, c] > 0)[:, 0]
            e0, e1 = int(ptr[c, 0]), int(ptr[c, S])
            dst = torch.repeat_interleave(torch.arange(S), ptr[c, 1:] - ptr[c, :-1])
            terms = x[rows][:, idx[e0:e1]] * val[e0:e1]
            out[rows] = torch.zeros((rows.numel(), S)).index_add_(1, dst, terms)
        return out

    return step


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_tables_rebuild_Ab_bit_for_bit(name):
    _, lat, t, sp = _lib(name)
    Ab = t["Ab"]
    S = lat.S
    ptr = sp["nz_ptr"]
    back = np.zeros_like(Ab)
    for c in range(5):
        e0, e1 = ptr[c, 0], ptr[c, S]
        dst = np.repeat(np.arange(S), np.diff(ptr[c]))
        back[c, sp["nz_idx"][e0:e1], dst] = sp["nz_val"][e0:e1]
    assert np.array_equal(back.view(np.uint32), Ab.view(np.uint32))


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_tables_ascending_without_zeros(name):
    _, lat, t, sp = _lib(name)
    S = lat.S
    ptr, idx, val = sp["nz_ptr"], sp["nz_idx"], sp["nz_val"]
    assert ptr.dtype == idx.dtype == np.int32 and val.dtype == np.float32
    assert ptr.shape == (5, S + 1) and idx.shape == val.shape
    # the bases' runs follow each other in one pair of arrays
    assert ptr[0, 0] == 0 and ptr[4, S] == idx.size
    assert (ptr[1:, 0] == ptr[:-1, S]).all() and (np.diff(ptr, axis=1) >= 0).all()
    for c in range(5):
        assert ptr[c, S] - ptr[c, 0] == np.count_nonzero(t["Ab"][c])
    # strictly ascending inputs within each (base, output), all real states
    out = np.repeat(np.arange(5 * S), np.diff(ptr, axis=1).ravel())
    same = out[1:] == out[:-1]
    assert (np.diff(idx)[same] > 0).all()
    assert (idx >= 0).all() and (idx < S).all()
    assert (val != 0).all()


# heavy outputs per library: the silent state that fans out to the barcode
# entries (45 inputs at 8 x 6nt, 105 on the flagship), and the 68nt spacer's
# delete-chain closure (51)
HEAVY = {"8x6nt": 1, "flagship": 1, "48x8nt": 1, "F+B+S+R": 0, "S68+R": 1}


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_tables_put_heavy_outputs_last(name):
    """``nz_out`` lists every output once: the light ones ascending, then
    the ``nz_heavy`` outputs with more than HEAVY_INPUTS inputs under some
    base, ascending; the kernel gives each of those a warp."""
    _, lat, _, sp = _lib(name)
    S = lat.S
    out, nh = sp["nz_out"], sp["nz_heavy"]
    assert out.dtype == np.int32 and nh == HEAVY[name]
    np.testing.assert_array_equal(np.sort(out), np.arange(S))
    heavy = np.diff(sp["nz_ptr"], axis=1).max(axis=0) > HEAVY_INPUTS
    np.testing.assert_array_equal(out[S - nh:], np.nonzero(heavy)[0])
    np.testing.assert_array_equal(out[: S - nh], np.nonzero(~heavy)[0])


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_step_equals_the_dense_step(name):
    """On random carries and bases (code 5: the zero step), the step from
    the tables equals the plain dense step and the lattice's A[c]^T; f32
    sums in another order: atol 1e-6, rtol 1e-5."""
    _, lat, t, sp = _lib(name)
    S = lat.S
    rng = np.random.default_rng(7)
    B = 24
    x = torch.from_numpy(rng.random((B, S)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 6, B).astype(np.uint8))
    oh = scan._onehot(codes[:, None])[:, 0]
    got = _sparse_step(sp, S)(x, oh)
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
                         _sparse_step(sp, lat.S), torch.from_numpy(t["end"]),
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
    theirs = sparse_tables(abwd.reshape(5, Sp, -1)[:, :, :S])
    ours = sparse_tables(tables_from_lattice(mb, lat)["Ab"])
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_fused_scorer_holds_the_tables_in_dense_mode():
    """Dense: K1/K4's blob holds the tables of ``Ab`` (a buffer beside
    ``Ab``) and they get its pointer and the address of its word offsets
    (and no step matrix); grouped: an empty blob, K1/K4 get the span
    tiles, and K2 the forward ones beside its label-DP blob."""
    mb, lat, t, sp = _lib("flagship")
    dense = FusedScorer(t)
    blob, tab = staged_tables(None, sp)
    np.testing.assert_array_equal(dense.blob_bwd.numpy(), blob)
    np.testing.assert_array_equal(dense.tabs["bwd"], tab)
    for i, k in enumerate(("nz_ptr", "nz_idx", "nz_val", "nz_out")):
        want = sp[k].reshape(-1)
        got = blob[tab[7 + i] : tab[7 + i] + want.size]
        np.testing.assert_array_equal(got.view(want.dtype), want)
    assert tab[11] == sp["nz_heavy"] == 1
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
    assert args[6] == grouped.blob_fwd.data_ptr() and grouped.tabs["fwd"][12] > 0
    assert grouped._key("bwd") == "bwd_grouped" and grouped._key("fwd") == "fwd_grouped"
