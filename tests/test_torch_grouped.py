"""The grouped (block-banded) step mode and the score-only backward (K4) of
the port, against the JAX package on the CPU.

On CPU tensors ``FusedScorer`` runs the plain versions; they are held
against ``TpuEngine.run_batch_pallas`` with ``TAGDUST_TPU_GROUPED=1`` (the
Pallas kernels in interpret mode) and the JAX scan engine ``run_batch``,
with the tolerances of ``tests/test_pallas_kernel.py:180-204``: labels
identical on 1..len, f_log within rtol 1e-4, Q within atol 1e-2 (grouped and
dense sum in another order).  K4 must equal the port's own K1 logP_b bit
for bit (the same recurrence without the stack), and agree with the JAX
score-only kernel and scan within atol 1e-5 (``test_pallas_kernel.py:232``).
The tests marked ``cuda`` hold the CUDA kernels against the plain versions
on a card and skip elsewhere.
"""

import inspect
import itertools

import numpy as np
import pytest
import torch

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.engine.lattice import compile_lattice, grouped_step_decomposition
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats

from tagdust_tpu_torch.engine import fused_kernel, scan
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.engine.fused_kernel import FusedScorer
from tagdust_tpu_torch.engine.tables import (
    grouped_tables,
    grouped_tables_from_lattice,
    tables_from_lattice,
)
from tagdust_tpu_torch.flagship import (
    PLATE_PATH,
    SETS,
    file_text,
    generate_barcodes,
    load_barcodes,
)


def _mk_model(segs, avg=50, mx=64, p_stats=False):
    ssi = SequenceStats()
    ssi.average_length = avg
    ssi.max_seq_len = mx
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    if p_stats:
        ssi.mean_5_len, ssi.stdev_5_len = 6.0, 1.5
        ssi.mean_3_len, ssi.stdev_3_len = 6.0, 1.5
        ssi.expected_5_len = ssi.expected_3_len = 7
    return init_model_bag(build_read_structure(segs), ssi, 0.05, 0.1)


def _barcodes(n):
    return ["".join(p) for p in itertools.product("ACGT", repeat=6)][7::83][:n]


# the grammars of tests/test_pallas_kernel.py:160-164: a 48-barcode library,
# four segments with a delete-chain entry under 5'/3' stats, and F+B+S+R
GRAMMARS = [
    ([f"B:{','.join(_barcodes(48))}", "R:N"], False),
    (["P:GGGGGGG", f"B:{','.join(_barcodes(8))}", "R:N", "P:TTTTTTT"], True),
    (["F:NN", "B:ACGTAC,TGCATG,CCAAGG", "S:TA", "R:N"], False),
]
GRAMMAR_IDS = ["48B+R", "P+8B+R+P", "F+B+S+R"]


@pytest.mark.parametrize("segs,p", GRAMMARS, ids=GRAMMAR_IDS)
def test_grouped_tables_reconstruct_A(segs, p):
    """blockdiag(tiles) + Uexit[:, seg] * wvec[c] == A[c], to the bound of
    test_grouped_decomposition_reconstructs_A."""
    mb = _mk_model(segs, p_stats=p)
    lat = compile_lattice(mb)
    g = grouped_tables_from_lattice(mb, lat)
    assert g is not None
    S = lat.S
    A2 = np.zeros((5, S, S), dtype=np.float32)
    for s0, w, off in g["span"]:
        tf = g["tile_f"][off : off + 5 * w * w].reshape(5, w, w)
        tb = g["tile_b"][off : off + 5 * w * w].reshape(5, w, w)
        np.testing.assert_array_equal(tb, np.swapaxes(tf, 1, 2))
        A2[:, s0 : s0 + w, s0 : s0 + w] = tf
        assert (g["span_of"][s0 : s0 + w] == list(g["span"][:, 0]).index(s0)).all()
    A2 += (g["uexit"].T[:, g["seg"]][None, :, :] * g["wvec"][:, None, :])
    err = np.abs(A2 - lat.A).max()
    assert err <= 1e-8 * max(np.abs(lat.A).max(), 1.0) + 1e-12, err
    # spans tile the states in order, each at most 128 wide
    assert g["span"][0, 0] == 0 and g["span"][-1, :2].sum() == S
    assert (g["span"][1:, 0] == g["span"][:-1, :2].sum(axis=1)).all()
    assert (g["span"][:, 1] <= 128).all()
    # the entry columns factor through the non-zero rows of Uent
    ent = np.einsum("uk,ck->cuk", g["uent"], g["eent"])
    np.testing.assert_allclose(ent, lat.Aent[:, g["urows"], :], rtol=1e-6, atol=0)
    assert not np.delete(lat.Uent, g["urows"], axis=0).any()


@pytest.mark.parametrize("segs,p", GRAMMARS[:2], ids=GRAMMAR_IDS[:2])
def test_grouped_tables_equal_the_pallas_layout(segs, p):
    """The port's tables against the grouped tables ``make_fused_scorer``
    builds (read from the call's closure), through its ``gpos`` layout."""
    from tagdust_tpu.engine import pallas_kernel as PK
    from tagdust_tpu.engine.tpu import TpuEngine

    mb = _mk_model(segs, p_stats=p)
    eng = TpuEngine(mb)
    lat = eng.lat
    dec = grouped_step_decomposition(mb, lat)
    call, Sp, Kp, Hp = PK.make_fused_scorer(
        lat.A, lat.Uent, lat.Eent, lat.end, np.asarray(eng._dev["Lmap"]),
        np.asarray(eng._dev["ent_sel"]), lat.begin, 16, 8, interpret=True,
        tmatrix=np.asarray(eng._dev["tmat"]), grouped=dec,
    )
    pk = {k: np.asarray(v) for k, v in inspect.getclosurevars(call).nonlocals.items()
          if k.endswith("_j")}
    g = grouped_tables(dec, lat)
    G = len(dec["spans"])
    gpos = np.concatenate([gi * 128 + np.arange(w) for gi, (_, w, _) in
                           enumerate(g["span"])])
    nm = g["uexit"].shape[0]
    for gi, (s0, w, off) in enumerate(g["span"]):
        tf = g["tile_f"][off : off + 5 * w * w].reshape(5, w, w)
        tb = g["tile_b"][off : off + 5 * w * w].reshape(5, w, w)
        for c in range(5):
            r = (c * G + gi) * 128
            np.testing.assert_array_equal(tf[c], pk["Afwd_j"][r : r + w, :w])
            np.testing.assert_array_equal(tb[c], pk["Abwd_j"][r : r + w, :w])
    np.testing.assert_array_equal(g["wvec"], pk["wvec_j"][:5, gpos])
    np.testing.assert_array_equal(g["uexit"].T, pk["uexitF_j"][gpos, :nm])
    np.testing.assert_array_equal(np.argmax(pk["msegB_j"][gpos], axis=1), g["seg"])
    K = lat.Uent.shape[1]
    np.testing.assert_array_equal(g["uent"], pk["uentp_j"][gpos][g["urows"], :K])
    np.testing.assert_array_equal(g["eent"], pk["eentp_j"][:5, :K])


def test_grouped_plain_matches_pallas_and_scan_48_barcodes(monkeypatch):
    """The port's grouped plain K1-K3 + epilogue against the JAX grouped
    Pallas kernels (interpret) and the XLA scan engine: 591 states, 5
    spans, B = 8, L = 32."""
    from tagdust_tpu.engine.tpu import TpuEngine

    mb = _mk_model([f"B:{','.join(_barcodes(48))}", "R:N"])
    monkeypatch.setenv("TAGDUST_TPU_GROUPED", "1")
    port = CudaEngine(mb, "cpu")
    assert port.grouped is not None and len(port.grouped["span"]) == 5
    assert port.scorer.grouped and port.lat.S == 591
    jx = TpuEngine(mb)
    rng = np.random.default_rng(1)
    B, L = 8, 32
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, 30, np.int32)
    lens[::3] = 24
    before = dict(fused_kernel.LAUNCHES)
    got = port.run_batch_fused(seqs, lens)
    assert fused_kernel.LAUNCHES == before  # CPU tensors launch no kernel
    for ref in (jx.run_batch_pallas(seqs, lens), jx.run_batch(seqs, lens)):
        for i in range(B):
            n = int(lens[i])
            np.testing.assert_array_equal(
                got.labels[i, 1 : n + 1].astype(np.int32),
                ref.labels[i, 1 : n + 1].astype(np.int32),
            )
        np.testing.assert_allclose(got.f_score, ref.f_score, rtol=1e-4)
        np.testing.assert_allclose(got.mapq, ref.mapq, atol=1e-2)


def test_grouped_gate(monkeypatch):
    """Auto mode: every kernel dense (the non-zero step) for 48, 20 and 8
    barcodes and R:N, libraries on which the H100 ran K1, K2 and K4 faster
    dense than grouped; TAGDUST_TPU_GROUPED=0 keeps them dense and =1 forces
    every kernel grouped (the counterpart of test_grouped_gate)."""
    monkeypatch.delenv("TAGDUST_TPU_GROUPED", raising=False)
    big = _mk_model([f"B:{','.join(_barcodes(48))}", "R:N"])
    small = _mk_model([f"B:{','.join(_barcodes(8))}", "R:N"])
    flagship = _mk_model([f"B:{','.join(load_barcodes())}", "R:N"])
    for mb in (big, flagship, small, _mk_model(["R:N"])):
        eng = CudaEngine(mb, "cpu")
        assert eng.grouped is None and not eng.scorer.grouped
        assert [eng.scorer._key(k) for k in ("bwd", "fwd", "score")] == [
            "bwd", "fwd", "score"]
    monkeypatch.setenv("TAGDUST_TPU_GROUPED", "0")
    assert CudaEngine(big, "cpu").grouped is None
    assert not CudaEngine(big, "cpu").scorer.grouped
    monkeypatch.setenv("TAGDUST_TPU_GROUPED", "1")
    for mb in (big, small):
        eng = CudaEngine(mb, "cpu")
        assert eng.grouped is not None and eng.scorer.grouped
        assert [eng.scorer._key(k) for k in ("bwd", "fwd", "score")] == [
            "bwd_grouped", "fwd_grouped", "score_grouped"]


def test_no_grouped_form_falls_back_loudly(monkeypatch, capsys):
    """A chain wider than 128 states has no grouped form: the engine takes
    the dense mode with a warning, and raises under TAGDUST_TPU_STRICT=1."""
    from tagdust_tpu_torch import strict

    mb = _mk_model(["S:" + "ACGT" * 17, "R:N"], avg=90, mx=96)
    assert grouped_step_decomposition(mb, compile_lattice(mb)) is None
    monkeypatch.setenv("TAGDUST_TPU_GROUPED", "1")
    monkeypatch.setattr(strict, "_warned", set())
    monkeypatch.delenv("TAGDUST_TPU_STRICT", raising=False)
    assert CudaEngine(mb, "cpu").grouped is None
    assert "grouped-step-kernel" in capsys.readouterr().err
    monkeypatch.setenv("TAGDUST_TPU_STRICT", "1")
    with pytest.raises(ValueError, match="block-banded"):
        CudaEngine(mb, "cpu")


@pytest.mark.parametrize("grouped", ["0", "1"], ids=["dense", "grouped"])
@pytest.mark.parametrize("segs", [
    ["P:GGG", "B:ACGTAC,TGCATG", "R:N"],
    [f"B:{','.join(_barcodes(20))}", "R:N"],
], ids=["P+B+R", "20B+R"])
def test_backward_scores_match_k1_and_jax(monkeypatch, segs, grouped):
    import functools

    import jax
    import jax.numpy as jnp

    from tagdust_tpu.engine.tpu import TpuEngine, _backward_scores

    monkeypatch.setenv("TAGDUST_TPU_GROUPED", grouped)
    mb = _mk_model(segs, avg=20, mx=32)
    port = CudaEngine(mb, "cpu")
    assert port.scorer.grouped == (grouped == "1")
    rng = np.random.default_rng(3)
    B, L = 16, 16
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(8, 17, B).astype(np.int32)
    # K4 plain == K1 plain, bit for bit, on the batch the engine pads to
    ps, pl = (torch.from_numpy(x) for x in
              port._pad(seqs, lens, port.default_batch_tile()))
    k4 = port.scorer.score(ps, pl)
    _, _, k1 = port.scorer.backward(ps, pl)
    assert torch.equal(k4, k1)
    via_engine = port.backward_scores(seqs, lens)
    np.testing.assert_array_equal(via_engine, k4[:B].numpy())
    jx = TpuEngine(mb)
    ref_pallas = jx.backward_scores(seqs, lens)
    ref_scan = np.asarray(jax.jit(functools.partial(_backward_scores, jx._dev))(
        jnp.asarray(seqs.astype(np.int32)), jnp.asarray(lens)))
    np.testing.assert_allclose(via_engine, ref_pallas, atol=1e-5)
    np.testing.assert_allclose(via_engine, ref_scan, atol=1e-5)


def test_plate_barcodes_file():
    """The 96 x 8nt plate set equals the generator's output; its lattice has
    1555 states, 194 entry columns, 98 labels and 13 spans."""
    _, n, k, title = SETS[1]
    bcs = load_barcodes(PLATE_PATH)
    assert bcs == generate_barcodes(96, 8, 3)
    with open(PLATE_PATH) as fh:
        assert fh.read() == file_text(bcs, title)
    assert len(set(bcs)) == n == 96 and all(len(b) == k == 8 for b in bcs)
    mb = _mk_model([f"B:{','.join(bcs)}", "R:N"])
    lat = compile_lattice(mb)
    t = tables_from_lattice(mb, lat)
    assert int(t["S"]) == 1555 and int(t["K"]) == 194 and t["tmat"].shape == (98, 98)
    g = grouped_tables_from_lattice(mb, lat)
    assert len(g["span"]) == 13 and list(g["span"][:, 1]).count(128) == 12
    assert g["span"][-1, 1] == 19 and len(g["urows"]) == 1


# -------------------------------------------------------------- on a card
CUDA_GROUPED = [
    ([f"B:{','.join(load_barcodes())}", "R:N"], False),
    ([f"B:{','.join(_barcodes(48))}", "R:N"], False),
    (["P:GGGGGGG", f"B:{','.join(_barcodes(8))}", "R:N", "P:TTTTTTT"], True),
    ([f"B:{','.join(generate_barcodes(96, 8, 3))}", "R:N"], False),
]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("segs,p", CUDA_GROUPED,
                         ids=["20B", "48B", "P+8B+R+P", "96B"])
def test_cuda_grouped_kernels_match_plain(segs, p):
    """Grouped K1-K4 on the card against the plain versions (tolerances of
    chip_smoke.py); K4 equals K1's logP_b bit for bit."""
    _cuda_or_skip()
    mb = _mk_model(segs, p_stats=p)
    sc = FusedScorer(tables_from_lattice(mb), grouped_tables_from_lattice(mb)).cuda()
    gt = sc.grouped_tables()
    rng = np.random.default_rng(0)
    B, Lp = 1000, 64
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(20, Lp + 1, B).astype(np.int32)).cuda()
    before = dict(fused_kernel.LAUNCHES)
    f_log, logpb, labels, tp = sc(seqs, lens)
    k4 = sc.score(seqs, lens)
    torch.cuda.synchronize()
    for k in ("bwd_grouped", "fwd_grouped", "tb", "score_grouped"):
        assert fused_kernel.LAUNCHES[k] == before[k] + 1, k
    assert torch.equal(k4, logpb)
    bst, blst, plogpb = scan.backward_pass(seqs, lens, sc.Abwd, sc.end, sc.begin,
                                           grouped=gt)
    path, dp, pf, ptp = scan.forward_decode(
        seqs, lens, sc.Afwd, sc.end, sc.Lmap, sc.ent_state, sc.tmat, sc.begin,
        bst, blst, plogpb, grouped=gt)
    plab = scan.traceback(path, dp)
    for a, b in ((logpb, plogpb), (f_log, pf)):
        assert ((a - b).abs() <= 1e-4 + 1e-5 * b.abs()).all()
    torch.testing.assert_close(tp, ptp, rtol=1e-4, atol=1e-6)
    valid = torch.arange(Lp + 1, device="cuda")[None, :] <= lens[:, None]
    assert int(((labels != plab) & valid).any(dim=1).sum()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", ["0", "1"], ids=["dense", "grouped"])
def test_cuda_kernel_failure_raises(monkeypatch, grouped):
    """A kernel made to fail (a block of 33 reads, over the kernels' 32)
    raises through every entry point: nothing continues on the plain
    version, on the other step mode or on the exact engine."""
    _cuda_or_skip()
    monkeypatch.setenv("TAGDUST_TPU_GROUPED", grouped)
    eng = CudaEngine(_mk_model([f"B:{','.join(load_barcodes())}", "R:N"]), "cuda")
    assert eng.scorer.grouped == (grouped == "1")
    eng.scorer._rt = {"bwd": 33, "fwd": 33}
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 4, (512, 64)).astype(np.uint8)
    lens = np.full(512, 60, np.int32)
    plain = scan.PLAIN_CUDA_CALLS["count"]
    with pytest.raises(RuntimeError, match="td_bwd_score"):
        eng.backward_scores(seqs, lens)
    with pytest.raises(RuntimeError, match="td_bwd"):
        eng.run_batch_fused(seqs, lens)
    eng.scorer._rt = {"fwd": 33}  # K1 launches, K2 fails
    with pytest.raises(RuntimeError, match="td_fwd"):
        eng.run_batch_fused(seqs, lens)
    assert scan.PLAIN_CUDA_CALLS["count"] == plain
