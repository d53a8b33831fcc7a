"""The port's entry points (``tagdust_tpu_torch/entry.py``) on the CPU,
against the JAX package where they have a counterpart there:

* ``flagship_model`` gives the model digest of the JAX package's
  ``init_model_bag`` over the same 20 barcodes and stats (built here from
  the JAX modules: ``__graft_entry__._flagship_engine`` shrinks to 4
  barcodes without the reference data directory), and raises on a file of
  fewer;
* ``entry(device="cpu")``'s step against JAX ``tpu._forward_backward`` on
  that model and the same inputs, with the tolerances of
  ``tests/test_pallas_kernel.py:46-54``: f within atol 1e-5, labels
  ``[:, 1:L+1]`` identical, Q within atol 1e-2;
* ``dryrun_multichip(2, device="cpu")`` prints its ok line and restores the
  environment and ``runner.local_devices``;
* without a card, every entry point that is not asked for the CPU raises;
* shards cycle over this process's cards;
* ``chip_smoke.py``'s entry-phase checks rehearse on the CPU;
* no module of the port names the reference data directory that the JAX
  benches read their barcodes from (``bench_e2e.EDITTAG``'s).
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from tagdust_tpu_torch import entry as E
from tagdust_tpu_torch.engine import runner

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the plain versions run many small ops, and a
    full thread pool in each of the suite's workers oversubscribes the
    cores (the CLI tests' subprocesses get OMP_NUM_THREADS=2 for the
    same reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_flagship_model():
    from tagdust_tpu.arch import build_read_structure
    from tagdust_tpu.logsum import p2sp
    from tagdust_tpu.model import init_model_bag
    from tagdust_tpu.stats import SequenceStats

    from tagdust_tpu_torch.flagship import load_barcodes

    bcs = load_barcodes()
    assert len(bcs) == 20
    ssi = SequenceStats()
    ssi.average_length = 50
    ssi.max_seq_len = 64
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(build_read_structure([f"B:{','.join(bcs)}", "R:N"]),
                          ssi, 0.05, 0.1)


def test_flagship_model_is_the_jax_model():
    pmb = E.flagship_engine("cpu").mb
    assert pmb.digest() == jax_flagship_model().digest()
    assert pmb.rs.types == ["B", "R"]


def test_flagship_needs_all_20_barcodes(tmp_path, monkeypatch):
    from tagdust_tpu_torch import flagship

    short = tmp_path / "four.txt"
    short.write_text("".join(f"Tag{i}:{b}\n" for i, b in
                             enumerate(flagship.load_barcodes()[:4])))
    monkeypatch.setattr(flagship, "PATH", str(short))
    with pytest.raises(RuntimeError, match="gives 4 barcodes"):
        E.flagship_model()


def test_entry_matches_jax_forward_backward():
    from tagdust_tpu.engine.tpu import TpuEngine, _forward_backward

    fn, (seqs, lens) = E.entry("cpu")
    assert seqs.device.type == "cpu" and tuple(seqs.shape) == (256, 48)
    assert (lens == 44).all()
    f, r, bar, labels, q = (t.numpy() for t in fn(seqs, lens))

    eng = TpuEngine(jax_flagship_model())
    s32 = np.random.default_rng(0).integers(0, 4, (256, 48)).astype(np.int32)
    np.testing.assert_array_equal(s32, seqs.numpy())
    ref = [np.asarray(x) for x in _forward_backward(eng._dev, s32, lens.numpy())]
    np.testing.assert_allclose(f, ref[0], atol=1e-5)
    np.testing.assert_allclose(r, ref[1], atol=1e-5)
    np.testing.assert_allclose(bar, ref[2], atol=1e-5)
    np.testing.assert_array_equal(labels[:, 1:49].astype(np.int32),
                                  ref[3][:, 1:49].astype(np.int32))
    np.testing.assert_allclose(q, ref[4], atol=1e-2)


def test_dryrun_multichip_on_cpu_shards(capsys, monkeypatch):
    for k in ("TAGDUST_TPU_BT", "TAGDUST_TPU_WINDOW", "TAGDUST_TPU_STRICT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TAGDUST_TPU_STRICT", "0")
    real = runner.local_devices
    E.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: 2 CPU shards, counts=" in out
    assert "reestimated 2 segments" in out
    assert runner.local_devices is real
    assert os.environ["TAGDUST_TPU_STRICT"] == "0"
    assert "TAGDUST_TPU_BT" not in os.environ and "TAGDUST_TPU_WINDOW" not in os.environ


@pytest.mark.parametrize("call", ["flagship_engine", "entry", "dryrun_multichip",
                                  "shard_devices"])
def test_entry_points_need_the_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"flagship_engine": E.flagship_engine, "entry": E.entry,
          "dryrun_multichip": lambda: E.dryrun_multichip(2),
          "shard_devices": lambda: E.shard_devices(2)}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


@pytest.mark.parametrize("cards,n,want", [
    (1, 2, "2 shards on cuda:0"),
    (2, 4, "4 shards on 2 cards (cuda:0, cuda:1)"),
    (4, 1, "1 shard on cuda:0"),
])
def test_shards_cycle_over_the_cards(monkeypatch, cards, n, want):
    from tagdust_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh, "local_devices",
                        lambda: [torch.device("cuda", i) for i in range(cards)])
    devs = E.shard_devices(n)
    assert devs == [torch.device("cuda", i % cards) for i in range(n)]
    assert E.describe(devs) == want
    assert E.describe(E.shard_devices(n, "cpu")) == f"{n} CPU shard" + "s" * (n > 1)


def test_chip_smoke_entry_checks_rehearse_on_the_cpu(tmp_path, monkeypatch):
    """The entry phase's comparisons on CPU tensors: ``entry()`` against its
    plain versions, the nibble A/B rows, and the CLI under
    TAGDUST_TPU_DEVICE_DECISIONS=0 with the decided run's bytes (windows of
    16 reads, so that each run streams)."""
    import chip_smoke as cs

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "16")
    monkeypatch.setenv("TAGDUST_TPU_FIRST_CHUNK", "64")
    errs = cs.entry_against_plain("cpu")
    assert errs == {"f_err": 0.0, "q_err": 0.0}
    eng = E.flagship_engine("cpu")
    cs.entry_nibble_rows(eng, 0, B=32, Lp=32)
    bcs = cs.barcode_sets()["flagship"]
    fq = str(tmp_path / "in.fq")
    cs.write_fastq(fq, 120, 4, bcs)
    runs = cs.entry_decisions(fq, bcs, str(tmp_path), device="cpu")
    assert runs["1"]["calls"]["dispatch_decided"] >= 3
    assert runs["0"]["calls"]["dispatch_packed"] >= 3


def reference_dir() -> str:
    """The directory of ``bench_e2e.EDITTAG``, read from its source."""
    with open(os.path.join(_REPO, "bench_e2e.py")) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "EDITTAG":
            return os.path.dirname(os.path.dirname(node.value.value))
    raise AssertionError("bench_e2e.EDITTAG not found")


def test_no_module_of_the_port_names_the_reference_tree():
    ref = reference_dir()
    assert ref.count("/") >= 2
    files = glob.glob(os.path.join(_REPO, "tagdust_tpu_torch", "**", "*.py"),
                      recursive=True)
    assert any(f.endswith(os.path.join("bench", "e2e.py")) for f in files)
    assert any(f.endswith("entry.py") for f in files)
    named = []
    for f in files:
        with open(f) as fh:
            if ref in fh.read():
                named.append(os.path.relpath(f, _REPO))
    assert not named
