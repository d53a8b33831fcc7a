"""The port's data-parallel scoring over local devices
(``tagdust_tpu_torch.parallel.mesh.ShardedScorer``, the runner's
``_mesh_scorer``) and ``DistributedTrainer`` across processes, on the CPU.

* ``ShardedScorer`` over 1, 2, 3 and 8 ``cpu`` shards: its decided rows,
  label-carrying rows and ``run`` labels and Q equal ``CudaEngine("cpu")``'s
  exactly (the same plain versions per read), and its counts sum to the
  real reads, pads masked;
* against the JAX ``ShardedScorer`` over the 8 virtual CPU devices of
  ``conftest.py`` (its XLA scan flavor): labels identical, f_score within
  1e-5, Q within 1e-2 (ROADMAP's rule for port against JAX);
* ``run_get_label_batch`` with ``runner.local_devices`` patched to four
  ``cpu`` shards, small windows: ``read_type``, ``barcode``, ``seq_arena``
  and ``fingerprint`` equal the run with ``TAGDUST_TPU_MESH=0`` and the
  one-shot mesh run, on the decided and the label-carrying rows;
* shards on one device share its budget;
* ``local_devices`` is empty without a card, and a card engine cannot be
  built without one;
* ``DistributedTrainer`` in two gloo processes returns the one-process
  counts (rtol 1e-5);
* ``chip_smoke.py``'s mesh checks rehearse on the CPU, and fail on rows
  out of shard order.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.engine import runner
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.parallel import mesh
from tagdust_tpu_torch.parallel.mesh import DistributedTrainer, ShardedScorer

from test_torch_cli import BARCODES, _REPO, write_fastq
from test_torch_label_stream import batch_inputs, model
from test_torch_multihost import _free_port

SPECS = ["B:ACGTAC,TGCATG,CCAAGG", "R:N"]
THR = 10.0


@pytest.fixture
def bt8(monkeypatch):
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")


@pytest.fixture(scope="module")
def engine():
    return CudaEngine(model(SPECS, 48), "cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_rows_equal_one_engine(engine, bt8, n):
    B = 8 * n * (3 if n < 8 else 1)
    seqs, lens = batch_inputs(B, 48, seed=n)
    sc = ShardedScorer(engine, ["cpu"] * n)
    assert sc.n == n and sc.per_card == n
    thr32 = engine.threshold_f32_ceil(THR)
    got = sc.dispatch_decided(seqs, lens, thr32, 16)
    assert len(got) == n
    want = engine.dispatch_decided(seqs, lens, thr32, 16)
    assert torch.equal(torch.cat(got), want)
    assert torch.equal(torch.cat(sc.dispatch_packed(seqs, lens)),
                       engine.dispatch_packed(seqs, lens))
    # run: B - 5 real reads, padded to the shards' tiles with copies of read 0
    real = B - 5
    res, counts = sc.run(seqs[:real], lens[:real], THR)
    ref = engine.run_batch_fused(seqs[:real], lens[:real])
    for k in ("f_score", "r_score", "bar_prob", "labels", "mapq"):
        np.testing.assert_array_equal(getattr(res, k), getattr(ref, k), k)
    assert counts.sum() == real
    assert counts[0] == (ref.mapq >= THR).sum()
    res, _ = sc.run(seqs[:real], lens[:real], want_labels=False)
    assert res.labels is None


def test_sharded_scorer_matches_the_jax_sharded_scorer(engine, bt8):
    import jax

    from tagdust_tpu.engine.tpu import TpuEngine
    from tagdust_tpu.parallel.mesh import ShardedScorer as JaxScorer
    from tagdust_tpu.parallel.mesh import make_mesh

    B = 40
    seqs, lens = batch_inputs(64, 48, seed=11)
    seqs, lens = seqs[:B], lens[:B]
    res, counts = ShardedScorer(engine, ["cpu"] * 8).run(seqs, lens, THR)
    out = JaxScorer(TpuEngine(engine.mb), make_mesh(jax.devices()[:8]),
                    use_pallas=False).run(seqs, lens, threshold=THR)
    jlab = np.asarray(out[3])[:B].astype(np.int32)
    for b in range(B):  # slot 0 is the pre-read slot (0 in the port)
        L = int(lens[b])
        np.testing.assert_array_equal(res.labels[b, 1 : L + 1], jlab[b, 1 : L + 1])
    np.testing.assert_allclose(res.f_score, np.asarray(out[0])[:B], atol=1e-5)
    np.testing.assert_allclose(res.mapq, np.asarray(out[4])[:B], atol=1e-2)
    assert counts.sum() == np.asarray(out[5]).sum() == B


class _Param:
    matchstart = -1
    matchend = -1
    minlen = 16
    engine = "torch"
    dust = 0
    rtest = False


class _SubParam(_Param):
    matchstart = 0
    matchend = 36


def _chunk(path: str, n: int):
    from tagdust_tpu_torch.io.fastq import SeqReader

    reader = SeqReader(path)
    batch = reader.read_chunk_batch(n)
    reader.close()
    return batch


@pytest.mark.parametrize("rows", ["decided", "label-carrying"])
def test_label_batch_on_four_shards(tmp_path, monkeypatch, rows):
    """The streaming loop over four shards (windows of 4 x 16 reads), the
    same loop on one engine (TAGDUST_TPU_MESH=0), and the one-shot path over
    the shards (a window larger than the chunk) write the same decisions,
    sequences and fingerprints."""
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    fq = str(tmp_path / "in.fq")
    n = 300
    write_fastq(fq, n, seed=21)
    specs = [f"B:{','.join(BARCODES)}", "F:NNNN", "R:N"]
    mb = model(specs)
    param = _Param() if rows == "decided" else _SubParam()
    monkeypatch.setattr(runner, "local_devices",
                        lambda: [torch.device("cpu")] * 4)
    calls = {"dispatch": 0, "run": 0}
    for name, key in (("dispatch_decided", "dispatch"),
                      ("dispatch_packed", "dispatch"), ("run", "run")):
        real = getattr(ShardedScorer, name)

        def spy(self, *a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(ShardedScorer, name, spy)

    def label(window: str, mesh_on: bool):
        monkeypatch.setenv("TAGDUST_TPU_WINDOW", window)
        monkeypatch.setenv("TAGDUST_TPU_MESH", "1" if mesh_on else "0")
        batch = _chunk(fq, n)
        runner.run_get_label_batch(mb, mb.rs, batch, param, THR)
        return batch

    streamed = label("64", True)
    assert calls["dispatch"] >= 3 and calls["run"] == 0
    calls["dispatch"] = 0
    single = label("64", False)
    assert calls == {"dispatch": 0, "run": 0}
    oneshot = label("4096", True)
    assert calls["dispatch"] == 0 and calls["run"] >= 1
    assert (streamed.read_type == 0).sum() > n // 2
    for other in (single, oneshot):
        for k in ("read_type", "barcode", "seq_arena", "fingerprint"):
            np.testing.assert_array_equal(getattr(streamed, k), getattr(other, k), k)


def test_shards_on_one_device_share_its_budget(engine, bt8, monkeypatch):
    """Two shards on one device get half of its STACK_BYTES each: the
    streaming window of two shards is the window one engine would take,
    not twice it."""
    Lp = 64
    sc = ShardedScorer(engine, ["cpu", "cpu"])
    budget = engine.launch_bytes(64, Lp)
    assert sc.shard_reads(Lp, budget) == engine.reads_within(Lp, budget // 2)
    assert ShardedScorer(engine, ["cpu"]).shard_reads(Lp, budget) == 64

    sizes = []
    monkeypatch.setattr(runner, "local_devices", lambda: [torch.device("cpu")] * 2)
    monkeypatch.setenv("TAGDUST_TPU_PIPELINE_DEPTH", "1")
    eng = runner.get_engine(engine.mb, "torch")
    monkeypatch.setattr(eng, "STACK_BYTES", eng.launch_bytes(64, Lp))
    real = ShardedScorer.dispatch_decided

    def spy(self, seqs, *a):
        sizes.append(seqs.shape[0])
        return real(self, seqs, *a)

    monkeypatch.setattr(ShardedScorer, "dispatch_decided", spy)
    rng = np.random.default_rng(2)
    from tagdust_tpu_torch.io.batch import ReadBatch
    from tagdust_tpu_torch.io.fastq import Read

    batch = ReadBatch.from_reads([
        Read(seq=rng.integers(0, 4, int(rng.integers(40, 60))).astype(np.uint8))
        for _ in range(200)])
    runner.run_get_label_batch(engine.mb, engine.mb.rs, batch, _Param(), THR)
    assert len(sizes) >= 3 and max(sizes) <= 64


def test_no_local_devices_without_a_card(engine, monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            CudaEngine(engine.mb, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.local_devices() == []
    assert runner._mesh_scorer(runner.get_engine(engine.mb, "torch"), 4096, 64) is None
    # one device: no mesh, every single-card path as it was
    monkeypatch.setattr(runner, "local_devices", lambda: [torch.device("cpu")])
    assert runner._mesh_scorer(runner.get_engine(engine.mb, "torch"), 4096, 64) is None
    with pytest.raises(ValueError, match="shard on cuda"):
        ShardedScorer(engine, ["cpu", "cuda:0"])


_TRAINER = """
import json, sys
import numpy as np
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.parallel.mesh import DistributedTrainer
from tagdust_tpu_torch.parallel.multihost import init_multihost
sys.path.insert(0, "tests")
from test_torch_label_stream import model
port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_multihost(f"127.0.0.1:{port}", 2, pid)
rng = np.random.default_rng(5)
seqs = rng.integers(0, 4, (29, 40)).astype(np.uint8)
lens = rng.integers(12, 40, 29).astype(np.int32)
CT, E, n = DistributedTrainer(CudaEngine(model(%r, 48), "cpu"), ["cpu", "cpu"]).run(seqs, lens)
np.savez(out, CT=CT, E=E, n=n)
""" % (SPECS,)


def test_trainer_across_two_gloo_processes(tmp_path):
    """Each of two processes passes the same 29 reads, counts its block of
    two shards (of eight reads each, three zero-length reads of padding),
    and both return the one-process counts."""
    from conftest import spawn_env

    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 4, (29, 40)).astype(np.uint8)
    lens = rng.integers(12, 40, 29).astype(np.int32)
    CT1, E1, n1 = DistributedTrainer(CudaEngine(model(SPECS, 48), "cpu")).run(seqs, lens)
    port = _free_port()
    outs = [str(tmp_path / f"p{p}.npz") for p in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _TRAINER, str(port), str(p), outs[p]],
                              cwd=_REPO, env=spawn_env(rtest=False, OMP_NUM_THREADS=2),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
    got = [np.load(o) for o in outs]
    for g in got:
        assert int(g["n"]) == n1 == int(lens.sum())
        np.testing.assert_allclose(g["CT"], CT1, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["E"], E1, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0]["CT"], got[1]["CT"])
    np.testing.assert_array_equal(got[0]["E"], got[1]["E"])


def test_chip_smoke_mesh_checks_rehearse_on_the_cpu(bt8, monkeypatch):
    import chip_smoke as cs

    eng = CudaEngine(cs.library_model(cs.barcode_sets()["8"]), "cpu")
    cs.mesh_rows("8", eng, 0, device="cpu", B=64, Lp=64)
    r = cs.mesh_trainer(eng, 0, device="cpu", B=64, Lp=64)
    assert r["shard_err"] < 1 and max(r["ct_mass"], r["e_mass"]) < 1e-4
    real = ShardedScorer.dispatch_decided
    monkeypatch.setattr(ShardedScorer, "dispatch_decided",
                        lambda self, *a: real(self, *a)[::-1])
    with pytest.raises(SystemExit, match="sharded rows differ"):
        cs.mesh_rows("8", eng, 0, device="cpu", B=64, Lp=64)
