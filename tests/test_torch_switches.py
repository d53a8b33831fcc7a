"""The JAX package's two A/B switches, in the port, on the CPU (``-engine
torch``): the counterparts of ``tests/test_multichip.py``'s
``test_nibble_gate_rows_identical`` and
``test_device_decisions_match_host_extractor``.

* ``TAGDUST_TPU_NIBBLE=0`` uploads plain uint8 rows where ``=1`` (the
  default) packs two bases a byte; the decided rows and ``run_batch_fused``'s
  results are identical under both;
* ``TAGDUST_TPU_DEVICE_DECISIONS=0`` streams a chunk through the
  label-carrying rows and the host extractor; on ``B:`` + ``F:NNNNNNNN`` +
  ``R:N`` with a minlen that trips the too-short path it gives the decided
  mode's read types, barcodes, fingerprint keys and sequence arena, and
  its Q within 1e-4.
"""

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.engine import decided as D
from tagdust_tpu_torch.engine import runner
from tagdust_tpu_torch.engine.cuda import CudaEngine


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


def model(specs, avg, mx):
    from tagdust_tpu_torch.arch import build_read_structure
    from tagdust_tpu_torch.logsum import p2sp
    from tagdust_tpu_torch.model import init_model_bag
    from tagdust_tpu_torch.stats import SequenceStats

    ssi = SequenceStats()
    ssi.average_length = avg
    ssi.max_seq_len = mx
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(build_read_structure(specs), ssi, 0.05, 0.1)


@pytest.fixture
def packs(monkeypatch):
    """Counts the calls of ``decided.pack_nibbles``."""
    n = {"calls": 0}
    real = D.pack_nibbles

    def spy(x):
        n["calls"] += 1
        return real(x)

    monkeypatch.setattr(D, "pack_nibbles", spy)
    return n


def test_nibble_gate_rows_identical(monkeypatch, packs):
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    eng = CudaEngine(model(["B:ACGTAC,TGCATG", "R:N"], 24, 32), "cpu")
    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 5, (16, 32)).astype(np.uint8)
    lens = rng.integers(10, 33, 16).astype(np.int32)
    rows, fused, calls = {}, {}, {}
    for nib in ("1", "0"):
        monkeypatch.setenv("TAGDUST_TPU_NIBBLE", nib)
        packs["calls"] = 0
        rows[nib] = eng.dispatch_decided(seqs, lens, np.float32(2.0), 10).numpy()
        res = eng.run_batch_fused(seqs, lens)
        fused[nib] = (res.f_score, res.mapq, res.labels)
        calls[nib] = packs["calls"]
    np.testing.assert_array_equal(rows["1"], rows["0"])
    for a, b in zip(fused["1"], fused["0"]):
        np.testing.assert_array_equal(a, b)
    # one packed upload each for the rows and the fused batch, none under 0
    assert calls == {"1": 2, "0": 0}


def test_nibble_upload_keeps_odd_lengths_plain(monkeypatch, packs):
    monkeypatch.setenv("TAGDUST_TPU_NIBBLE", "1")
    eng = CudaEngine(model(["B:ACGTAC,TGCATG", "R:N"], 24, 32), "cpu")
    seqs = np.random.default_rng(2).integers(0, 4, (8, 31)).astype(np.uint8)
    up = eng._upload_seqs(seqs)
    np.testing.assert_array_equal(up.numpy(), seqs)
    assert packs["calls"] == 0
    even = eng._upload_seqs(seqs[:, :30])
    np.testing.assert_array_equal(even.numpy(), seqs[:, :30])
    assert packs["calls"] == 1


class _Param:
    engine = "torch"
    rtest = False
    matchstart = -1
    matchend = -1
    minlen = 14  # trips the too-short path of some reads
    dust = 0
    num_threads = 4


def _batch():
    from tagdust_tpu_torch.io.batch import ReadBatch
    from tagdust_tpu_torch.io.fastq import Read

    rng = np.random.default_rng(23)
    reads = []
    for i in range(160):
        bc = ["ACGTAC", "TGCATG"][i % 2]
        umi = "".join(rng.choice(list("ACGT"), size=8))
        tail = "".join(rng.choice(list("ACGT"), size=int(rng.integers(8, 26))))
        s = (bc + umi + tail) if i % 6 else (umi + tail)
        code = np.frombuffer(s.encode(), dtype=np.uint8)
        code = np.searchsorted(np.frombuffer(b"ACGT", dtype=np.uint8), code).astype(np.uint8)
        reads.append(Read(name=f"u{i}", seq=code, qual="I" * len(s)))
    return ReadBatch.from_reads(reads)


def test_device_decisions_match_host_extractor(monkeypatch):
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "64")
    monkeypatch.setenv("TAGDUST_TPU_STRICT", "1")
    monkeypatch.setenv("TAGDUST_TPU_MESH", "0")
    mb = model(["B:ACGTAC,TGCATG", "F:NNNNNNNN", "R:N"], 30, 40)
    calls = {"dispatch_decided": 0, "dispatch_packed": 0}
    for name in calls:
        real = getattr(CudaEngine, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(CudaEngine, name, spy)
    results, used = {}, {}
    for mode in ("1", "0"):
        monkeypatch.setenv("TAGDUST_TPU_DEVICE_DECISIONS", mode)
        calls.update(dispatch_decided=0, dispatch_packed=0)
        b = _batch()
        runner.run_get_label_batch(mb, mb.rs, b, _Param(), 2.0)
        results[mode], used[mode] = b, dict(calls)
    assert used["1"] == {"dispatch_decided": 3, "dispatch_packed": 0}
    assert used["0"] == {"dispatch_decided": 0, "dispatch_packed": 3}
    dev, host = results["1"], results["0"]
    np.testing.assert_array_equal(dev.read_type, host.read_type)
    np.testing.assert_array_equal(dev.barcode, host.barcode)
    np.testing.assert_array_equal(dev.fingerprint, host.fingerprint)
    np.testing.assert_array_equal(dev.seq_arena, host.seq_arena)
    np.testing.assert_array_equal(dev.qual_arena, host.qual_arena)
    np.testing.assert_allclose(dev.mapq, host.mapq, atol=1e-4)
    # both outcome classes present, the too-short one among the failures
    assert (dev.read_type == 0).any() and (dev.read_type != 0).any()
    from tagdust_tpu_torch.constants import EXTRACT_FAIL_READ_TOO_SHORT

    assert (dev.read_type == EXTRACT_FAIL_READ_TOO_SHORT).any()
