"""The port's Baum-Welch training (``tagdust_tpu_torch.parallel.mesh``,
``tagdust_tpu_torch.engine.train``) against the JAX package's, on the CPU.

* the E-step's lattice counts, on a ``CudaEngine(mb, "cpu")`` (K1's plain
  version), against the JAX ``DistributedTrainer`` on one CPU device, over
  lattices of ``tests/test_torch_scan.py`` with ragged lengths and N bases:
  CT and E within rtol 1e-5 / atol 1e-6 (the tolerance of
  ``tests/test_tpu_engine.py:113-114``), n equal;
* the invariants E.sum == CT.sum == sum(lens), within rtol 1e-4;
* 1 and 8 shards of the port's trainer and 8 CPU devices of the JAX
  trainer, equal within the same tolerance;
* counts over sub-batches cut by a small budget equal one batch's;
* the mapped counts against the host ``expected_counts`` at the
  tolerances of ``tests/test_train.py:66-117``;
* the copied ``engine/train.py`` gives every count and re-estimated
  parameter of the JAX package's, exactly;
* a trainer over an engine built for the card raises without one, and
  runs nothing on the CPU;
* the Kahan sum keeps the increments a plain f32 sum drops;
* ``chip_smoke.py``'s train phase rehearses on the CPU at a tiny size.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.engine import scan
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.parallel import mesh
from tagdust_tpu_torch.parallel.mesh import DistributedTrainer, Kahan, estep_bytes

from test_torch_scan import CASES, model

RTOL, ATOL = 1e-5, 1e-6
# the lattices held against the JAX trainer: barcodes, a fingerprint, a
# spacer, a prefix, and reads of 100-150nt
TRAIN_CASES = [CASES[i] for i in (0, 1, 2, 5, 6)]
IDS = ["+".join(c[0]) for c in TRAIN_CASES]


def _reads(Lp, lr, B=32, seed=3):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    seqs[: B // 2, :6] = np.frombuffer(b"\x00\x01\x02\x03\x00\x01", np.uint8)
    seqs[rng.random((B, Lp)) < 0.02] = 4  # N
    lens = rng.integers(lr[0], lr[1], B).astype(np.int32)
    return seqs, lens


@functools.lru_cache(maxsize=None)
def _case(i):
    """(model, reads, lens, the JAX trainer's counts) of TRAIN_CASES[i]."""
    import jax

    from tagdust_tpu.engine.tpu import TpuEngine
    from tagdust_tpu.parallel.mesh import DistributedTrainer as JaxTrainer
    from tagdust_tpu.parallel.mesh import make_mesh

    specs, avg, mx, Lp, lr = TRAIN_CASES[i]
    mb = model(specs, avg, mx)
    seqs, lens = _reads(Lp, lr)
    ref = JaxTrainer(TpuEngine(mb), make_mesh(jax.devices()[:1])).run(seqs, lens)
    return mb, seqs, lens, ref


def _port_counts(mb, seqs, lens):
    eng = CudaEngine(mb, "cpu")
    CT, E, n = mesh._expected_lattice_counts(
        eng, torch.from_numpy(seqs), torch.from_numpy(lens))
    return CT.numpy(), E.numpy(), int(n)


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=IDS)
def test_lattice_counts_match_the_jax_trainer(i):
    mb, seqs, lens, (CTj, Ej, nj) = _case(i)
    CT, E, n = _port_counts(mb, seqs, lens)
    assert CT.shape == CTj.shape and E.shape == Ej.shape
    assert CT.dtype == E.dtype == np.float32
    assert n == nj == int(lens.sum())
    np.testing.assert_allclose(CT, CTj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E, Ej, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("i", range(len(TRAIN_CASES)), ids=IDS)
def test_every_base_carries_mass_one(i):
    mb, seqs, lens, _ = _case(i)
    CT, E, n = _port_counts(mb, seqs, lens)
    np.testing.assert_allclose(E.sum(), float(n), rtol=1e-4)
    np.testing.assert_allclose(CT.sum(), float(n), rtol=1e-4)
    # mass only on the entries of A[c]
    lat = CudaEngine(mb, "cpu").lat
    assert not CT[lat.A == 0].any()


@pytest.mark.parametrize("B", [16, 13])
def test_shard_count_invariance(B):
    """1 and 8 shards of the port's trainer (zero-length reads pad 13 to
    16) and the JAX trainer on 8 CPU devices
    (test_distributed_trainer_device_count_invariance)."""
    import jax

    from tagdust_tpu.engine.tpu import TpuEngine
    from tagdust_tpu.parallel.mesh import DistributedTrainer as JaxTrainer
    from tagdust_tpu.parallel.mesh import make_mesh

    mb = model(["B:ACGTAC,TGCATG,CCAAGG", "R:N"], 30, 48)
    rng = np.random.default_rng(5)
    L = 24
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(10, L, B).astype(np.int32)
    eng = CudaEngine(mb, "cpu")
    CT1, E1, n1 = DistributedTrainer(eng).run(seqs, lens)
    CT8, E8, n8 = DistributedTrainer(eng, ["cpu"] * 8).run(seqs, lens)
    CTj, Ej, nj = JaxTrainer(TpuEngine(mb), make_mesh(jax.devices()[:8])).run(
        seqs, lens)
    assert n1 == n8 == nj == int(lens.sum())
    for CT, E in ((CT8, E8), (CTj, Ej)):
        np.testing.assert_allclose(E, E1, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(CT, CT1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E1.sum(), float(n1), rtol=1e-4)
    np.testing.assert_allclose(CT1.sum(), float(n1), rtol=1e-4)


def test_sub_batches_give_one_batch_counts():
    """A budget of 3 reads a sub-batch: 11 K1 calls over 32 reads, and the
    counts of one batch."""
    mb, seqs, lens, _ = _case(0)
    one = _port_counts(mb, seqs, lens)
    eng = CudaEngine(mb, "cpu")
    eng.STACK_BYTES = estep_bytes(eng, 3, seqs.shape[1]) + 1
    calls = []
    backward = eng.scorer.backward
    eng.scorer.backward = lambda s, ln: calls.append(s.shape[0]) or backward(s, ln)
    CT, E, n = DistributedTrainer(eng).run(seqs, lens)
    assert calls == [3] * 10 + [2]
    assert n == one[2]
    np.testing.assert_allclose(CT, one[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E, one[1], rtol=RTOL, atol=ATOL)


def test_a_read_over_the_budget_is_refused():
    mb, seqs, lens, _ = _case(0)
    eng = CudaEngine(mb, "cpu")
    eng.STACK_BYTES = estep_bytes(eng, 1, seqs.shape[1]) - 1
    with pytest.raises(RuntimeError, match="STACK_BYTES"):
        DistributedTrainer(eng).run(seqs, lens)


def test_counts_from_a_given_stack():
    """The E-step fed K1's stack computed apart (as chip_smoke.py feeds the
    host the card's) gives the counts of the E-step that runs K1."""
    mb, seqs, lens, _ = _case(4)
    eng = CudaEngine(mb, "cpu")
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lens)
    sc = eng.scorer
    stack = scan.backward_pass(s, ln, sc.Abwd, sc.end, sc.begin)
    got = mesh._expected_lattice_counts(eng, s, ln, stack=stack)
    want = mesh._expected_lattice_counts(eng, s, ln)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _train_mb(pkg):
    import importlib

    arch = importlib.import_module(f"{pkg}.arch")
    logsum = importlib.import_module(f"{pkg}.logsum")
    mdl = importlib.import_module(f"{pkg}.model")
    stats = importlib.import_module(f"{pkg}.stats")
    ssi = stats.SequenceStats()
    ssi.average_length = 24
    ssi.max_seq_len = 40
    ssi.background = [float(logsum.p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return mdl.init_model_bag(arch.build_read_structure(["B:ACGTAC,TGCATG", "R:N"]),
                              ssi, 0.05, 0.1)


def test_mapped_counts_match_the_host_expected_counts():
    """The port's trainer counts mapped back with ``lattice_counts_to_counts``
    against the port's host ``expected_counts`` (the
    forward_extract_posteriors replica), at test_train.py's tolerances."""
    from tagdust_tpu_torch.engine.train import expected_counts

    mb = _train_mb("tagdust_tpu_torch")
    rng = np.random.default_rng(12)
    B, L = 12, 16
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, dtype=np.int32)
    term = np.zeros((B, L + 1), dtype=np.uint8)
    term[:, :L] = seqs
    host = expected_counts(mb, term, L)
    mapped = DistributedTrainer(CudaEngine(mb, "cpu"), ["cpu"] * 2
                                ).expected_segment_counts(seqs, lens)
    for j in range(mb.num_models):
        for name in ("m_emit", "i_emit", "s2M", "s2I"):
            np.testing.assert_allclose(getattr(mapped, name)[j], getattr(host, name)[j],
                                       rtol=2e-3, atol=2e-3, err_msg=name)
        for tr in (0, 1, 3, 4, 6):  # MM, MI, II, IM, DM
            np.testing.assert_allclose(mapped.trans[j][..., tr], host.trans[j][..., tr],
                                       rtol=5e-3, atol=5e-3,
                                       err_msg=f"segment {j} trans {tr}")


def _model_arrays(mb):
    return [(name, np.asarray(getattr(m, name))) for m in mb.models
            for name, x in sorted(vars(m).items()) if isinstance(x, np.ndarray)]


def test_train_copy_equals_the_jax_module():
    """``expected_counts``, ``lattice_counts_to_counts`` and ``reestimate`` of
    each package on the same inputs: every count array and every
    re-estimated parameter array equal."""
    import tagdust_tpu.engine.train as jt
    import tagdust_tpu_torch.engine.train as pt

    rng = np.random.default_rng(1)
    B, L = 12, 24
    seqs = np.zeros((B, L + 1), dtype=np.uint8)
    seqs[:, :L] = rng.integers(0, 4, (B, L))
    seqs[: B // 2, :6] = np.array([0, 1, 2, 3, 0, 1], dtype=np.uint8)
    jmb, pmb = _train_mb("tagdust_tpu"), _train_mb("tagdust_tpu_torch")
    S = CudaEngine(pmb, "cpu").lat.S
    CT = rng.random((5, S, S)).astype(np.float32)
    E = rng.random((5, S)).astype(np.float32)
    for jc, pc in ((jt.expected_counts(jmb, seqs, L), pt.expected_counts(pmb, seqs, L)),
                   (jt.lattice_counts_to_counts(jmb, CT, E),
                    pt.lattice_counts_to_counts(pmb, CT, E))):
        for name in ("trans", "m_emit", "i_emit", "s2M", "s2I"):
            for a, b in zip(getattr(jc, name), getattr(pc, name)):
                np.testing.assert_array_equal(a, b, err_msg=name)
        ja, pa = jt.reestimate(jmb, jc), pt.reestimate(pmb, pc)
        arrays = list(zip(_model_arrays(ja), _model_arrays(pa)))
        assert len(arrays) >= 3 * len(pa.models)
        for (na, a), (nb, b) in arrays:
            assert na == nb
            np.testing.assert_array_equal(a, b, err_msg=na)


def test_train_copy_is_the_jax_source():
    """The copy keeps the JAX module's source: its imports are relative."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = [open(os.path.join(repo, pkg, "engine", "train.py")).read()
           for pkg in ("tagdust_tpu", "tagdust_tpu_torch")]
    assert src[0] == src[1]


def test_a_card_engine_does_not_train_on_the_cpu(monkeypatch):
    """No fallback: without a card an engine built for ``cuda`` cannot be
    built, a trainer over one (here a CPU engine relabelled) raises before
    any read is scored, and a card engine's trainer takes no CPU shard."""
    mb, seqs, lens, _ = _case(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            CudaEngine(mb, "cuda")
    plain = []
    monkeypatch.setattr(scan, "backward_pass", lambda *a, **k: plain.append(1))
    eng = CudaEngine(mb, "cpu")
    with pytest.raises(ValueError, match="shard on cpu"):
        eng.device = torch.device("cuda")
        DistributedTrainer(eng, ["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistributedTrainer(eng).run(seqs, lens)
    assert not plain


def test_kahan_keeps_what_a_plain_f32_sum_drops():
    big = np.float32(2 ** 24)
    plain = torch.tensor([big])
    k = Kahan((1,), "cpu")
    k.add(torch.tensor([big]))
    for _ in range(1000):
        plain = plain + 1.0
        k.add(torch.ones(1))
    assert float(plain[0]) == float(big)  # every increment dropped
    assert float(k.sum[0]) == float(big) + 1000.0


def test_chip_smoke_train_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s train phase at a tiny size on CPU tensors: every
    check it makes on the card passes on the host (untimed)."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "TRAIN_HOST_READS", 16)
    sets = cs.barcode_sets()
    out = cs.phase_train({"flagship": sets["8"], "plate": sets["flagship"]}, 0,
                         n_reads=600, device="cpu", B=48, Lp=48)
    em = out["em"]
    assert em["reads"] == 600 and em["row_err"] < 1e-3
    # sum logP is reported, not gated: finite on both sides of the iteration
    assert np.isfinite([em["logP_before"], em["logP_after"]]).all()
    assert em["k1_stack_err"] == em["k1_log_err"] == 0.0
    for name in ("flagship", "plate"):
        r = out[name]
        assert r["host_err"] == r["plain_err"] == 0.0
        assert r["k1_stack_err"] == r["k1_log_err"] == 0.0
        assert max(r["e_mass"], r["ct_mass"]) < 1e-4
    assert "[train em] K1 against its plain version at (600, 60)" in (
        capsys.readouterr().out)


def test_chip_smoke_k1_check_fails_on_a_wrong_stack(capsys):
    """The train phase's K1 check holds the stack itself, not only logP: a
    stack off by more than its tolerance in one slot fails the run."""
    import chip_smoke as cs

    mb, seqs, lens, _ = _case(0)
    sc = CudaEngine(mb, "cpu").scorer
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lens)
    bstack, blstack, logpb = sc.backward(s, ln)
    assert cs.k1_against_plain("t", sc, s, ln, (bstack, blstack, logpb))["bstack"] == 0
    bad = bstack.clone()
    bad[5, 3] += 1e-3
    with pytest.raises(SystemExit):
        cs.k1_against_plain("t", sc, s, ln, (bad, blstack, logpb))
