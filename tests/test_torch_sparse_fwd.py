"""The step tables and the non-zero label DP of the dense forward kernel
(K2, ``td_fwd``).

``td_fwd`` walks the step tables of ``Af`` (``tables.sliced_tables``, the
S state columns and the K barcode-entry columns) and, in its label DP,
only the sources of each label with a non-zero transition
(``tables.label_tables``).  The kernel runs only on a card, so these tests
hold the tables and the plain versions of both (``scan.sliced_step``,
``scan.sparse_label_dp``) to the dense forms: the tables rebuild ``Af``
bit for bit; the step from the tables, one chain per (read, output) in
ascending input order, equals the chain over every input, zeros included,
bit for bit (and ``scan._dense_step`` within f32 rounding); the non-zero
label DP equals the full loop of ``scan.forward_decode`` bit for bit.  A
plain forward decode with both swapped in is held against the JAX
package's Pallas K2 in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.arch import build_read_structure
from tagdust_tpu_torch.engine import scan
from tagdust_tpu_torch.engine.fused_kernel import FusedScorer
from tagdust_tpu_torch.engine.lattice import compile_lattice
from tagdust_tpu_torch.engine.tables import (
    label_tables,
    sliced_tables,
    staged_tables,
    swizzle,
    tables_from_lattice,
)
from tagdust_tpu_torch.flagship import (
    PLATE_PATH,
    generate_barcodes,
    load_barcodes,
    spacer,
)
from tagdust_tpu_torch.logsum import p2sp
from tagdust_tpu_torch.model import init_model_bag
from tagdust_tpu_torch.stats import SequenceStats

PLATE = load_barcodes(PLATE_PATH)
# the four libraries of the gate table in PERF.md, a fingerprint + spacer
# grammar, and the plate with a 140nt spacer (no grouped form)
LIBS = {
    "8x6nt": [f"B:{','.join(generate_barcodes(8, 6, 3))}", "R:N"],
    "flagship": [f"B:{','.join(load_barcodes())}", "R:N"],
    "48x8nt": [f"B:{','.join(generate_barcodes(48, 8, 3))}", "R:N"],
    "plate": [f"B:{','.join(PLATE)}", "R:N"],
    "F+B+S+R": ["F:NN", "B:ACGTAC,TGCATG,CCAAGG", "S:TA", "R:N"],
    "plate+spacer": [f"B:{','.join(PLATE)}", f"S:{spacer()}", "R:N"],
}
# (S, K, H, non-zeros of Af over the five bases, heavy outputs, tmat
# non-zeros): counted from the tables
SIZES = {"8x6nt": (111, 18, 10, 1760, 0, 19), "flagship": (255, 42, 22, 4100, 0, 43),
         "48x8nt": (787, 98, 50, 16420, 1, 99), "plate": (1555, 194, 98, 32500, 1, 195)}


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
    """(model, lattice, tables, step tables of Af) of one library."""
    mb = _model(LIBS[name])
    lat = compile_lattice(mb)
    t = tables_from_lattice(mb, lat)
    return mb, lat, t, sliced_tables(t["Af"], lat.S)


@pytest.mark.parametrize("name", list(LIBS))
def test_sparse_tables_rebuild_Af_bit_for_bit(name):
    """``sliced_tables(Af)`` lists every non-zero entry of the S state and K
    entry columns once, each output's inputs ascending real states with a
    non-zero value under some base, and rebuilds ``Af``."""
    from test_torch_sparse_step import unsliced

    _, lat, t, sl = _lib(name)
    Af = t["Af"]
    nout = lat.S + int(t["K"])
    back = np.zeros_like(Af)
    nnz = 0
    for o, idx, val in unsliced(sl, nout):
        back[:, idx, o] = val.T
        assert (np.diff(idx) > 0).all() and (idx < lat.S).all() and val.any(axis=1).all()
        nnz += int(np.count_nonzero(val))
    assert np.array_equal(back.view(np.uint32), Af.view(np.uint32))
    if name in SIZES:
        S, K, H, nz, heavy, tnz = SIZES[name]
        assert (lat.S, int(t["K"]), t["tmat"].shape[0]) == (S, K, H)
        assert nnz == nz and sl["hv_out"].size == heavy
        assert label_tables(t["tmat"])["tm_src"].size == tnz


def _chain(x, oh, M):
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


@pytest.mark.parametrize("name", ["8x6nt", "flagship", "F+B+S+R", "plate"])
def test_forward_step_from_the_tables_equals_the_dense_step(name):
    """On random carries >= 0 with exact zeros and random bases (code 5:
    the zero step), the plain step over the tables (swizzled carries, as
    the kernel runs it) equals the chain over all of Af bit for bit, and
    the plain dense step ``x @ Af`` within f32 rounding of another sum
    order (atol 1e-6, rtol 1e-5)."""
    _, lat, t, sl = _lib(name)
    rng = np.random.default_rng(11)
    B = 12
    S = lat.S
    xv = rng.random((B, S)).astype(np.float32)
    xv[rng.random((B, S)) < 0.3] = 0.0
    x = torch.from_numpy(xv)
    codes = torch.from_numpy(rng.integers(0, 6, B).astype(np.uint8))
    oh = scan._onehot(codes[:, None])[:, 0]
    got = scan.sliced_step(x, oh, sl, S + int(t["K"]))
    assert torch.equal(got, _chain(x, oh, torch.from_numpy(t["Af"][:, :S])))
    dense = scan._dense_step(torch.from_numpy(t["Afwd"]))(x, oh)
    torch.testing.assert_close(got, dense, atol=1e-6, rtol=1e-5)


def _random_dp(rng, B, H):
    """dp >= 0 from a few levels (ties), a third of it exact zeros, one row
    of zeros and one constant row."""
    dp = rng.choice(np.float32([0.5, 1.25, 3.0]), (B, H))
    dp[rng.random((B, H)) < 0.35] = 0.0
    dp[0] = 0.0
    dp[1] = 2.0
    return torch.from_numpy(dp.astype(np.float32))


def _hold_to_full_loop(dp, tmat):
    tm = torch.from_numpy(tmat)
    lt = {k: torch.from_numpy(v) for k, v in label_tables(tmat).items()}
    mx, mv = scan.sparse_label_dp(dp, lt["tm_ptr"], lt["tm_src"], lt["tm_val"],
                                  lt["tm_diag"])
    rmx, rmv = scan.label_dp(dp, tm)
    assert torch.equal(mx, rmx) and torch.equal(mv, rmv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_label_dp_equals_the_full_loop(seed):
    """Random binary and non-binary tmatrices with empty columns, a zero
    diagonal somewhere and columns whose only sources sit past label 0, on
    dp with exact zeros and ties: the same maximum and source as the full
    H-loop (torch.equal)."""
    rng = np.random.default_rng(seed)
    H, B = 9, 40
    tmat = (rng.random((H, H)) < 0.3).astype(np.float32)
    if seed == 2:
        tmat *= rng.choice(np.float32([0.5, 1.0, 2.0]), (H, H))
    tmat[:, 3] = 0.0  # a label no source reaches
    tmat[4, 4] = 0.0
    tmat[:, 5] = 0.0
    tmat[7, 5] = 1.0  # one source, past 0
    dp = _random_dp(rng, B, H)
    _hold_to_full_loop(dp, tmat)
    _hold_to_full_loop(torch.zeros((3, H)), tmat)


@pytest.mark.parametrize("name", list(SIZES))
def test_sparse_label_dp_on_the_library_tables(name):
    _, _, t, _ = _lib(name)
    H = t["tmat"].shape[0]
    rng = np.random.default_rng(5)
    _hold_to_full_loop(_random_dp(rng, 24, H), t["tmat"])


def test_label_tables_need_a_non_negative_tmatrix():
    with pytest.raises(ValueError, match="non-negative"):
        label_tables(np.float32([[1, -1], [0, 1]]))
    with pytest.raises(ValueError):
        label_tables(np.float32([[1, np.inf], [0, 1]]))


def test_staged_blob_unpacks_to_the_tables():
    """``staged_tables``: every table at its word offset, 16-byte aligned,
    f32 by its bits; each part a multiple of 16 bytes; the scorer's K2 blob
    holds the label part (``lab_idx`` swizzled, as the dense kernels keep
    their columns) then the heavy and light step tables of Af, K1's only
    those of Ab."""
    mb, lat, t, sl = _lib("flagship")
    label = dict(label_tables(t["tmat"]),
                 **{k: t[k] for k in ("lab_ptr", "lab_idx", "ent_state")})
    label["lab_idx"] = swizzle(label["lab_idx"])
    blob, tab = staged_tables(label, sl)
    names = ("tm_ptr", "tm_src", "tm_val", "tm_diag", "lab_ptr", "lab_idx",
             "ent_state", "hv_ptr", "hv_out", "hv_ent", "sl_ptr", "sl_out", "sl_idx",
             "sl_val")
    assert tab.dtype == np.int32 and tab.shape == (len(names) + 5,)
    assert tab[len(names)] == sl["hv_out"].size
    assert tab[len(names) + 1] == sl["sl_out"].shape[0]
    w_label, w_heavy, w_light = tab[-3:]
    assert w_label % 4 == 0 and w_heavy % 4 == 0 and w_light % 4 == 0
    assert blob.size == w_label + w_heavy + w_light
    for i, name in enumerate(names):
        want = np.ascontiguousarray(label[name] if i < 7 else sl[name]).reshape(-1)
        assert tab[i] % 4 == 0
        got = blob[tab[i] :].view(want.dtype)[: want.size]
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the heavy part follows the label part, the light part the heavy one
    assert tab[7] == w_label and tab[10] == w_label + w_heavy
    sc = FusedScorer(t)
    np.testing.assert_array_equal(sc.blob_fwd.numpy(), blob)
    np.testing.assert_array_equal(sc.tabs["fwd"], tab)
    bwd_blob, bwd_tab = staged_tables(None, sliced_tables(t["Ab"], lat.S))
    np.testing.assert_array_equal(sc.blob_bwd.numpy(), bwd_blob)
    assert bwd_tab[-3] == 0 and (bwd_tab[:7] == 0).all()


def test_plain_dense_mode_as_the_kernel_runs_it_matches_pallas_interpret(monkeypatch):
    """K1 and K2 in the kernel's dense form (the steps from the non-zero
    tables, the non-zero label DP) against the JAX package's Pallas kernels
    in interpret mode, on the fingerprint + spacer grammar of
    tests/test_torch_fused_kernel.py (its tolerances)."""
    import jax.numpy as jnp

    from tagdust_tpu.arch import build_read_structure as jax_rs
    from tagdust_tpu.engine import pallas_kernel as PK
    from tagdust_tpu.engine.tpu import TpuEngine
    from tagdust_tpu.model import init_model_bag as jax_mb
    from tagdust_tpu.stats import SequenceStats as JaxStats

    segs = LIBS["F+B+S+R"]
    ssi = JaxStats()
    ssi.average_length, ssi.max_seq_len = 26, 40
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = ssi.mean_3_len = ssi.stdev_3_len = -1.0
    jmb = jax_mb(jax_rs(segs), ssi, 0.05, 0.1)
    eng = TpuEngine(jmb)
    lat = eng.lat
    Lp, BT, B = 24, 8, 16
    call, *_ = PK.make_fused_scorer(
        lat.A, lat.Uent, lat.Eent, lat.end, np.asarray(eng._dev["Lmap"]),
        np.asarray(eng._dev["ent_sel"]), lat.begin, Lp, BT, interpret=True,
        tmatrix=np.asarray(eng._dev["tmat"]),
    )
    rng = np.random.default_rng(9)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    lens = rng.integers(12, 24, B).astype(np.int32)
    f_ref, lp_ref, lab_ref, _ = (np.asarray(x) for x in call(
        jnp.asarray(seqs.astype(np.int32)), jnp.asarray(lens)))

    t = tables_from_lattice(jmb, lat)
    sc = FusedScorer(t)
    S = lat.S
    steps = {id(sc.Afwd): (sliced_tables(t["Af"], S), S + int(t["K"])),
             id(sc.Abwd): (sliced_tables(t["Ab"], S), S)}
    lt = {k: torch.from_numpy(v) for k, v in label_tables(t["tmat"]).items()}
    dense_step = scan._dense_step
    monkeypatch.setattr(scan, "_dense_step", lambda M: (
        lambda x, oh: scan.sliced_step(x, oh, *steps[id(M)])
        if id(M) in steps else dense_step(M)(x, oh)))
    monkeypatch.setattr(scan, "label_dp", lambda dp, tmat: scan.sparse_label_dp(
        dp, lt["tm_ptr"], lt["tm_src"], lt["tm_val"], lt["tm_diag"]))
    f_log, logpb, labels, _ = (x.numpy() for x in sc(torch.from_numpy(seqs),
                                                     torch.from_numpy(lens)))
    np.testing.assert_allclose(logpb, lp_ref, atol=1e-5)
    np.testing.assert_allclose(f_log, f_ref, atol=1e-5)
    for b in range(B):
        n = int(lens[b])
        np.testing.assert_array_equal(labels[b, 1 : n + 1], lab_ref[b, 1 : n + 1])
