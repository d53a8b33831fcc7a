"""The E-step kernel's host side (``tagdust_tpu_torch/engine/estep.py``,
``tables.estep_tables``, ``parallel/mesh.py``) on the CPU, at the size of the
8-barcode library (8 x 6nt + R:N, S = 111), a few hundred seeded reads,
Lp <= 64:

* the kernel's entry table is ``count_tables``' entries regrouped by
  destination: its ``flat`` permutation gives ``count_tables``' CT exactly,
  and a walk of the table as ``td_estep`` walks it (a destination's entries
  into ``vn[t]`` and their mass, E summed from the entries) gives the plain
  version's CT and E (rtol 1e-5 / atol 1e-6: f64 sums against the plain
  version's f32 ones);
* ``estep_bytes`` counts each route's own buffers, and the kernel's route
  fits more reads in a budget;
* ``_expected_lattice_counts`` on CPU tensors runs the plain version, which
  still equals the JAX trainer (rtol 1e-5 / atol 1e-6, as
  ``tests/test_torch_train.py``);
* CUDA tensors with the kernel library unloadable raise, and never reach
  the plain version;
* a card-only case holds ``td_estep`` to its plain version (rtol 1e-4 /
  atol 1e-6) and two launches to each other, bit for bit.
"""

import functools
import types

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.engine import build, estep, fused_kernel
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.parallel import mesh

from test_torch_scan import model

RTOL, ATOL = 1e-5, 1e-6
B, LP = 300, 64


@functools.lru_cache(maxsize=None)
def _library():
    import chip_smoke as cs

    return model(["B:" + ",".join(cs.barcode_sets()["8"]), "R:N"], 52, 64)


def _reads(seed=7, b=B, lp=LP):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (b, lp)).astype(np.uint8)
    seqs[rng.random((b, lp)) < 0.02] = 4  # N
    seqs[rng.random((b, lp)) < 0.005] = 9  # a code above 4: a zero step
    lens = rng.integers(20, lp + 1, b).astype(np.int32)
    lens[:3] = 0  # the zero-length pads of DistributedTrainer.run
    return seqs, lens


@pytest.fixture(scope="module")
def engine():
    return CudaEngine(_library(), "cpu")


def test_entry_table_permutation_gives_count_tables_ct(engine):
    tab = mesh.count_tables(engine.lat, "cpu")
    et = {k: v.numpy() for k, v in tab["estep"].items()}
    nnz = tab["off"][-1]
    assert np.array_equal(np.sort(et["flat"]), np.arange(nnz))
    # any mass in the kernel's entry order, written to its flat index
    mass = np.random.default_rng(1).random(nnz).astype(np.float32)
    flat = np.zeros(nnz, np.float32)
    flat[et["flat"]] = mass
    CT = mesh._dense(tab, torch.from_numpy(flat)).numpy()
    want = np.zeros_like(CT)
    A = np.asarray(engine.lat.A, np.float32)
    for c in range(5):
        items = range(et["dst_ptr"][c], et["dst_ptr"][c + 1])
        assert np.all(np.diff(et["dst"][items.start : items.stop]) > 0)
        for i in items:
            t, ents = et["dst"][i], slice(et["ent_ptr"][i], et["ent_ptr"][i + 1])
            assert np.all(np.diff(et["src"][ents]) > 0)
            np.testing.assert_array_equal(et["val"][ents], A[c, et["src"][ents], t])
            want[c, et["src"][ents], t] = mass[ents]
    np.testing.assert_array_equal(CT, want)
    assert np.count_nonzero(want) == np.count_nonzero(A)


def _table_walk(tab, seqs, lens, bstack, blstack, logpb):
    """The counts as ``td_estep`` walks its entry table, in float64: per
    position and base, each destination's entries into vn[t] and each
    entry's mass; the mass to its flat index, E summed from the entries."""
    et = {k: v.numpy() for k, v in tab["estep"].items()}
    bstack, blstack, logpb = (x.double().numpy() for x in (bstack, blstack, logpb))
    S, nnz = tab["S"], tab["off"][-1]
    items = et["dst"].size
    dst_of = np.repeat(et["dst"], np.diff(et["ent_ptr"]))  # [nnz]
    base_of = np.repeat(np.arange(5), np.diff(et["dst_ptr"]))  # [items]
    b, lp = seqs.shape
    v = np.zeros((b, S))
    v[:, tab["begin"]] = 1.0
    ls = np.zeros(b)
    total = np.zeros(nnz)
    for k in range(lp):
        act = k < lens
        code = np.minimum(seqs[:, k], 5)
        w = np.exp(np.minimum(ls + blstack[k + 1] - logpb, 60.0)) * act
        vn = np.zeros((b, S))
        for c in range(5):
            r = np.nonzero(act & (code == c))[0]
            e = np.arange(et["ent_ptr"][et["dst_ptr"][c]],
                          et["ent_ptr"][et["dst_ptr"][c + 1]])
            flow = v[r][:, et["src"][e]] * et["val"][e]  # [reads, entries]
            np.add.at(vn, (r[:, None], dst_of[e][None, :]), flow)
            total[e] += (w[r] @ (flow * bstack[k + 1][r][:, dst_of[e]]))
        m = vn.max(axis=1)
        m = np.where(m > 0, m, 1.0)
        v = np.where(act[:, None], vn / m[:, None], v)
        ls = np.where(act, ls + np.log(m), ls)
    mass = np.zeros(nnz)
    mass[et["flat"]] = total
    E = np.zeros((5, S))
    starts = et["ent_ptr"][:-1]
    np.add.at(E, (base_of, et["dst"]), np.add.reduceat(total, starts)
              if items else np.zeros(0))
    return mass, E


def test_table_walk_gives_the_plain_counts(engine):
    seqs, lens = _reads()
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lens)
    tab = mesh.count_tables(engine.lat, "cpu")
    stack = engine.scorer.backward(s, ln)
    ct, e = mesh.Kahan(tab["off"][-1], "cpu"), mesh.Kahan((5, tab["S"]), "cpu")
    estep.forward_counts_plain(tab, s, ln, *stack, ct, e)
    mass, E = _table_walk(tab, seqs, lens, *stack)
    np.testing.assert_allclose(mass, ct.sum.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E, e.sum.numpy(), rtol=RTOL, atol=ATOL)
    # each base of a possible read carries mass 1; a read with a code above
    # 4 is impossible (its backward values are 0 through the zero step), and
    # its mass 0 although the clamp at 60 lets w reach e^60
    possible = ~((seqs > 4) & (np.arange(LP) < lens[:, None])).any(axis=1)
    assert 0 < possible.sum() < B
    n = float(lens[possible].sum())
    np.testing.assert_allclose([mass.sum(), E.sum()], [n, n], rtol=1e-4)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_estep_bytes_count_each_routes_buffers(engine, route, monkeypatch):
    S, Lp = engine.lat.S, LP
    nnz = [int(np.count_nonzero(engine.lat.A[c])) for c in range(5)]
    both = (Lp + 1) * (S + 1) * 4 + 4 + Lp + 4
    if route == "plain":
        per = both + 16 * Lp + 4 * (2 * S + 4) + 4 * (3 * max(nnz) + 4 * S)
        fixed = 0
        eng = engine
    else:
        eng = CudaEngine(_library(), "cpu")
        eng.device = torch.device("cuda", 0)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda d: types.SimpleNamespace(multi_processor_count=132))
        per = both
        fixed = 8 * 132 * sum(nnz) + 4 * sum(nnz) + 4 * 5 * S
    assert mesh.estep_bytes(eng, 0, Lp) == fixed
    assert mesh.estep_bytes(eng, 1000, Lp) == 1000 * per + fixed
    budget = eng.stack_budget()
    assert mesh.estep_reads(eng, Lp) == (budget - fixed) // per
    assert mesh.estep_bytes(eng, mesh.estep_reads(eng, Lp), Lp) <= budget
    assert mesh.estep_bytes(eng, mesh.estep_reads(eng, Lp) + 1, Lp) > budget
    if route == "kernel":  # no per-read temporaries: more reads a sub-batch
        assert mesh.estep_reads(eng, Lp) > mesh.estep_reads(engine, Lp)


def _jax_counts(mb, seqs, lens):
    import jax

    from tagdust_tpu.engine.tpu import TpuEngine
    from tagdust_tpu.parallel.mesh import DistributedTrainer as JaxTrainer
    from tagdust_tpu.parallel.mesh import make_mesh

    return JaxTrainer(TpuEngine(mb), make_mesh(jax.devices()[:1])).run(seqs, lens)


@pytest.mark.parametrize("seed", [7, 8])
def test_cpu_tensors_run_the_plain_version_equal_to_jax(engine, seed, monkeypatch):
    seqs, lens = _reads(seed, b=96)
    seqs = np.minimum(seqs, 4)  # the JAX one-hot takes codes 0-4
    calls = []
    plain = estep.forward_counts_plain
    monkeypatch.setattr(estep, "forward_counts_plain",
                        lambda *a: calls.append(a[1].shape[0]) or plain(*a))
    monkeypatch.setattr(estep, "forward_counts_cuda",
                        lambda *a: pytest.fail("the kernel on CPU tensors"))
    CT, E, n = mesh._expected_lattice_counts(
        engine, torch.from_numpy(seqs), torch.from_numpy(lens))
    assert calls == [96]
    CTj, Ej, nj = _jax_counts(engine.mb, seqs, lens)
    assert int(n) == nj == int(lens.sum())
    np.testing.assert_allclose(CT.numpy(), CTj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E.numpy(), Ej, rtol=RTOL, atol=ATOL)


def test_cuda_tensors_raise_without_the_kernel(engine, monkeypatch):
    """No fallback: on CUDA tensors (stubs here) whose kernel library cannot
    load, the E-step raises and never runs the plain version."""

    class OnCard:
        is_cuda = True
        device = torch.device("cuda", 0)
        shape = (4, LP)

        def contiguous(self):
            return self

    def unloadable():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "lib", unloadable)
    monkeypatch.setattr(estep, "forward_counts_plain",
                        lambda *a: pytest.fail("the plain version on CUDA tensors"))
    tab = mesh.count_tables(engine.lat, "cpu")
    ct, e = mesh.Kahan(tab["off"][-1], "cpu"), mesh.Kahan((5, tab["S"]), "cpu")
    before = fused_kernel.LAUNCHES["estep"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        estep.forward_counts(tab, *(OnCard() for _ in range(5)), ct, e)
    assert fused_kernel.LAUNCHES["estep"] == before


@pytest.mark.cuda
def test_td_estep_equals_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng = CudaEngine(_library(), "cuda")
    seqs, lens = _reads(b=2048)
    s, ln = torch.from_numpy(seqs).cuda(), torch.from_numpy(lens).cuda()
    tab = mesh.count_tables(eng.lat, s.device)
    stack = eng.scorer.backward(s, ln)
    before = fused_kernel.LAUNCHES["estep"]
    got = [estep.forward_counts_cuda(tab, s, ln, *stack) for _ in range(2)]
    torch.cuda.synchronize()
    assert fused_kernel.LAUNCHES["estep"] == before + 2
    for a, b in zip(*got):
        assert torch.equal(a, b)
    ct, e = mesh.Kahan(tab["off"][-1], s.device), mesh.Kahan((5, tab["S"]), s.device)
    estep.forward_counts_plain(tab, s, ln, *stack, ct, e)
    np.testing.assert_allclose(got[0][0].cpu().numpy(), ct.sum.cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[0][1].cpu().numpy(), e.sum.cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
