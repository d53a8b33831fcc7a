"""``FusedScorer`` against the JAX package's Pallas kernels.

On CPU tensors the scorer runs the plain versions of K1-K3; they are held
against ``make_fused_scorer(..., interpret=True)``, the JAX package's own
interpret-mode route, on the cases of tests/test_pallas_kernel.py.  The
hand-written CUDA kernels run only on a card: ``test_cuda_kernels_match_plain``
holds them against the plain versions there and skips elsewhere.
"""

import numpy as np
import pytest
import torch

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats

from tagdust_tpu_torch.engine import fused_kernel, scan
from tagdust_tpu_torch.engine.fused_kernel import FusedScorer
from tagdust_tpu_torch.engine.tables import tables_from_lattice
from tagdust_tpu_torch.flagship import PLATE_PATH, load_barcodes, spacer

# (segments, average length, max length, Lp, BT, B, read-length range,
#  f_log tolerance (rtol, atol))
CASES = [
    (["B:ACGTAC,TGCATG", "R:N"], 20, 32, 16, 8, 16, (10, 15), (0.0, 1e-5)),
    # Lp > 127: the multi-bank traceback of the Pallas kernel
    (["B:ACGT,TGCA", "R:N"], 120, 160, 150, 8, 8, (100, 150), (2e-4, 1e-3)),
    # a tmatrix where the Pallas fast and slow label DP agree
    (["F:NN", "B:ACGTAC,TGCATG,CCAAGG", "S:TA", "R:N"], 26, 40, 24, 8, 16,
     (12, 24), (0.0, 1e-5)),
]


def model(specs, avg, mx):
    ssi = SequenceStats()
    ssi.average_length = avg
    ssi.max_seq_len = mx
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(build_read_structure(specs), ssi, 0.05, 0.1)


@pytest.mark.parametrize(
    "specs,avg,mx,Lp,BT,B,lr,ftol", CASES, ids=["+".join(c[0]) for c in CASES]
)
def test_plain_versions_match_pallas_interpret(specs, avg, mx, Lp, BT, B, lr, ftol):
    import jax.numpy as jnp

    from tagdust_tpu.engine import pallas_kernel as PK
    from tagdust_tpu.engine.tpu import TpuEngine

    mb = model(specs, avg, mx)
    eng = TpuEngine(mb)
    lat = eng.lat
    call, *_ = PK.make_fused_scorer(
        lat.A, lat.Uent, lat.Eent, lat.end, np.asarray(eng._dev["Lmap"]),
        np.asarray(eng._dev["ent_sel"]), lat.begin, Lp, BT, interpret=True,
        tmatrix=np.asarray(eng._dev["tmat"]),
    )
    rng = np.random.default_rng(9)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    lens = rng.integers(lr[0], lr[1], B).astype(np.int32)
    f_ref, lp_ref, lab_ref, tp_ref = (
        np.asarray(x) for x in call(jnp.asarray(seqs.astype(np.int32)),
                                    jnp.asarray(lens))
    )
    before = dict(fused_kernel.LAUNCHES)
    sc = FusedScorer(tables_from_lattice(mb, lat))
    f_log, logpb, labels, tp = (
        x.numpy() for x in sc(torch.from_numpy(seqs), torch.from_numpy(lens))
    )
    assert fused_kernel.LAUNCHES == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(logpb, lp_ref, rtol=ftol[0], atol=ftol[1])
    np.testing.assert_allclose(f_log, f_ref, rtol=ftol[0], atol=ftol[1])
    # entry posteriors: Pallas factors Aent = Uent * Eent[c], the port keeps
    # the product; both are f32 sums of the same terms
    np.testing.assert_allclose(tp, tp_ref, rtol=1e-4, atol=1e-6)
    assert labels.shape == lab_ref.shape == (B, Lp + 1)
    np.testing.assert_array_equal(labels[:, 0], lab_ref[:, 0])
    for b in range(B):
        n = int(lens[b])
        np.testing.assert_array_equal(labels[b, 1 : n + 1], lab_ref[b, 1 : n + 1])


def test_label_dp_ties_follow_the_pallas_rule():
    """Constant posteriors make every DP step a tie: the first maximal
    source wins, then the diagonal override, as in the Pallas slow path."""
    H = 4
    tmat = torch.tensor([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1], [1, 0, 0, 1]],
                        dtype=torch.float32)
    B, Lp, S = 3, 5, 4
    seqs = torch.zeros((B, Lp), dtype=torch.uint8)
    lens = torch.tensor([5, 3, 0], dtype=torch.int32)
    A = torch.eye(S).repeat(5, 1)  # identity step for every base
    Lmap = torch.cat([torch.eye(S), torch.zeros(S, 1)], dim=1)
    bst = torch.ones((Lp + 1, B, S))
    blst = torch.zeros((Lp + 1, B))
    logpb = torch.zeros(B)
    end = torch.ones(S)
    ent = torch.zeros(0, dtype=torch.int32)
    path, dp, _, _ = scan.forward_decode(seqs, lens, A, end, Lmap, ent, tmat, 0,
                                         bst, blst, logpb)
    # reference: the unrolled strict-> loop of pallas_kernel.py:499-508; the
    # identity step keeps all mass in state 0, so plab = e_0 at every step
    dpr = np.zeros((B, H), np.float32)
    plab = np.eye(H, dtype=np.float32)[0]
    for k in range(Lp):
        for b in range(B):
            if k >= int(lens[b]):
                np.testing.assert_array_equal(path[k, b].numpy(), np.arange(H))
                continue
            mx = np.full(H, -1.0, np.float32)
            mv = np.full(H, -1)
            for c in range(H):
                cand = dpr[b, c] * tmat[c].numpy()
                gt = cand > mx
                mv[gt] = c
                mx[gt] = cand[gt]
            diag = dpr[b] * np.diagonal(tmat.numpy())
            mv[diag == mx] = np.arange(H)[diag == mx]
            np.testing.assert_array_equal(path[k, b].numpy(), mv)
            dpr[b] = plab + mx
    np.testing.assert_array_equal(dp.numpy(), dpr)


def test_engine_cuda_raises_without_card(monkeypatch):
    """``-engine cuda`` and the default ``auto`` need the card; ``-rtest``
    pins the exact engine; ``torch`` and ``exact`` run on the CPU."""
    from tagdust_tpu_torch.config import parse_args
    from tagdust_tpu_torch.engine.runner import resolve_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (["-engine", "cuda"], [], ["-engine", "auto"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_engine(parse_args(["-1", "R:N", *args]))
    assert resolve_engine(parse_args(["-1", "R:N", "-rtest"])) == "exact"
    assert resolve_engine(parse_args(["-1", "R:N", "-engine", "exact"])) == "exact"
    assert resolve_engine(parse_args(["-1", "R:N", "-engine", "torch"])) == "torch"
    with pytest.raises(ValueError):
        resolve_engine(parse_args(["-1", "R:N", "-engine", "tpu"]))


def _barcodes(n):
    import itertools

    return ["".join(p) for p in itertools.product("ACGT", repeat=6)][7::83][:n]


# (segments, average length, Lp): a small lattice, the 20-barcode flagship
# size, a 591-state lattice (more than one state per thread of a 256-thread
# block), a fingerprint + spacer grammar, long reads, and the 96-well plate
# + a 140nt spacer (2115 states, no grouped form: three passes of 705
# outputs, one of them with 679 inputs)
CUDA_CASES = [
    (["B:ACGTAC,TGCATG,CCAAGG", "R:N"], 30, 64),
    ([f"B:{','.join(_barcodes(20))}", "R:N"], 50, 64),
    ([f"B:{','.join(_barcodes(48))}", "R:N"], 50, 64),
    (["F:NN", "B:ACGTAC,TGCATG,CCAAGG", "S:TA", "R:N"], 26, 32),
    (["B:ACGT,TGCA", "R:N"], 120, 160),
    ([f"B:{','.join(load_barcodes(PLATE_PATH))}", f"S:{spacer()}", "R:N"], 50, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("specs,avg,Lp", CUDA_CASES,
                         ids=[f"{len(c[0][0])}-{c[2]}" for c in CUDA_CASES])
def test_cuda_kernels_match_plain(specs, avg, Lp):
    """K1-K3 on the card against the plain versions (tolerances of
    chip_smoke.py: f32 sums in another order over Lp rescaled steps); K4
    equals K1's logP_b bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    mb = model(specs, avg, Lp + 16)
    sc = FusedScorer(tables_from_lattice(mb)).cuda()
    rng = np.random.default_rng(0)
    B = 1000
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(Lp // 3, Lp + 1, B).astype(np.int32)).cuda()
    before = dict(fused_kernel.LAUNCHES)
    f_log, logpb, labels, tp = sc(seqs, lens)
    torch.cuda.synchronize()
    assert all(fused_kernel.LAUNCHES[k] == before[k] + 1
               for k in ("bwd", "fwd", "tb"))
    assert torch.equal(sc.score(seqs, lens), logpb)
    bst, blst, plogpb = scan.backward_pass(seqs, lens, sc.Abwd, sc.end, sc.begin)
    path, dp, pf, ptp = scan.forward_decode(
        seqs, lens, sc.Afwd, sc.end, sc.Lmap, sc.ent_state, sc.tmat, sc.begin,
        bst, blst, plogpb)
    plab = scan.traceback(path, dp)
    for a, b in ((logpb, plogpb), (f_log, pf)):
        assert ((a - b).abs() <= 1e-4 + 1e-5 * b.abs()).all()
    torch.testing.assert_close(tp, ptp, rtol=1e-4, atol=1e-6)
    valid = torch.arange(Lp + 1, device="cuda")[None, :] <= lens[:, None]
    assert int(((labels != plab) & valid).any(dim=1).sum()) <= 1
    # K3 on identical inputs is exact
    assert torch.equal(sc.traceback(path, dp), plab)
    with pytest.raises(TypeError):
        sc.backward(seqs.int(), lens)
    with pytest.raises(ValueError):
        sc.backward(seqs.cpu().cuda()[:, ::2], lens)


# (segments, B, Lp): the flagship at 4224 (past the JAX package's 4096nt
# bound), and the plate at 5440, whose K1 stack of 5441 x 256 x 1555
# entries passes 2^31, so a 32-bit index into it (or into K2's reads of it)
# would wrap
LONG_CASES = [
    ([f"B:{','.join(load_barcodes())}", "R:N"], 1024, 4224),
    ([f"B:{','.join(load_barcodes(PLATE_PATH))}", "R:N"], 256, 5440),
]


@pytest.mark.cuda
@pytest.mark.parametrize("specs,B,Lp", LONG_CASES, ids=["flagship-4224", "plate-5440"])
def test_cuda_kernels_long_reads(specs, B, Lp):
    """K1 and K2 on long reads against the plain versions (K2 on the
    kernel's stack), and K3 exact on K2's path and dpfin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    mb = model(specs, 50, Lp + 16)
    sc = FusedScorer(tables_from_lattice(mb)).cuda()
    rng = np.random.default_rng(1)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(Lp - 300, Lp + 1, B).astype(np.int32)).cuda()
    bst, blst, logpb = sc.backward(seqs, lens)
    torch.cuda.synchronize()
    # slot Lp holds the end vector for every read, past 2^31 entries on the plate
    assert torch.equal(bst[Lp], sc.end[None, :].expand(B, sc.S))
    _, _, plogpb = scan.backward_pass(seqs, lens, sc.Abwd, sc.end, sc.begin)
    assert ((logpb - plogpb).abs() <= 1e-4 + 1e-5 * plogpb.abs()).all()
    path, dp, f_log, tp = sc.forward_decode(seqs, lens, bst, blst, logpb)
    _, pdp, pf, ptp = scan.forward_decode(
        seqs, lens, sc.Afwd, sc.end, sc.Lmap, sc.ent_state, sc.tmat, sc.begin,
        bst, blst, logpb)
    del bst, blst
    assert ((f_log - pf).abs() <= 1e-4 + 1e-5 * pf.abs()).all()
    torch.testing.assert_close(tp, ptp, rtol=1e-4, atol=1e-6)
    # dpfin sums Lp max-plus steps: over thousands of them a near tie can
    # take another source (2 of 22,528 entries 2.6e-4 apart at 4224)
    torch.testing.assert_close(dp, pdp, rtol=1e-3, atol=1e-6)
    assert torch.equal(sc.traceback(path, dp), scan.traceback(path, dp))
