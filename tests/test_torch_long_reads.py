"""Long reads on the port: the stack budget binds every launch.

``CudaEngine`` counts every per-read buffer of a fused launch
(``launch_bytes``: K1's stack, K2's path, the labels, ...) and splits a
batch into sub-batches that stay inside ``STACK_BYTES``, down to one read;
a read that alone exceeds it is refused.  The streaming loop hands a chunk
whose budget-sized window would fall under the batch granularity to that
one-shot path.  Reads padded past 4096nt print one long-reads note and run
on the same kernels (here, on CPU tensors, their plain versions), where the
JAX package moves them to its scan engine: the decisions are the same.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tagdust_tpu_torch.engine import cuda as cuda_mod
from tagdust_tpu_torch.engine import runner
from tagdust_tpu_torch.engine.cuda import CudaEngine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARCODES = ["ACAGTG", "ACTTGA"]
ARCH = ["-1", f"B:{','.join(BARCODES)}", "-2", "R:N"]

_PORT_RUNNER = """
import sys
sys.modules["jax"] = None
from tagdust_tpu_torch.cli.tagdust import main
main(sys.argv[1:])
"""


def _env(**extra):
    from conftest import spawn_env

    return spawn_env(rtest=False, **extra)


def _long_fastq(path: str) -> None:
    """The fixture of test_robustness.py::test_long_read_fallback_gate: 20
    reads of two barcodes and one read of 4,200nt (padded to 4224)."""
    rng = np.random.default_rng(7)
    with open(path, "w") as fh:
        for i in range(20):
            seq = BARCODES[i % 2] + "".join(rng.choice(list("ACGT"), size=50))
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
        seq = BARCODES[0] + "".join(rng.choice(list("ACGT"), size=4194))
        fh.write(f"@long\n{seq}\n+\n{'I' * len(seq)}\n")


def _outputs(prefix: str) -> dict:
    d = os.path.dirname(prefix)
    base = os.path.basename(prefix)
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith(base) and not f.endswith("_logfile.txt"):
            with open(os.path.join(d, f), "rb") as fh:
                out[f[len(base):]] = fh.read()
    return out


def test_long_read_matches_jax_cli(tmp_path):
    """A 4,200nt read: the port's -engine torch writes the same bytes as
    the JAX CLI (-engine tpu on its scan engine) and notes the long reads
    once."""
    fq = str(tmp_path / "in.fq")
    _long_fastq(fq)
    common = ["-seed", "42", *ARCH, "-Q", "10", fq]
    subprocess.run(
        [sys.executable, "-m", "tagdust_tpu.cli.tagdust", *common, "-o",
         str(tmp_path / "jax"), "-engine", "tpu"],
        check=True, capture_output=True, cwd=_REPO,
        env=_env(TAGDUST_TPU_PALLAS="0", TAGDUST_TPU_MESH="0"),
    )
    res = subprocess.run(
        [sys.executable, "-c", _PORT_RUNNER, *common, "-o", str(tmp_path / "port"),
         "-engine", "torch"],
        check=True, capture_output=True, text=True, cwd=_REPO, env=_env(),
    )
    assert res.stderr.count("NOTE: long-reads") == 1
    a, b = _outputs(str(tmp_path / "jax")), _outputs(str(tmp_path / "port"))
    assert a.keys() == b.keys() and "_un.fq" in a
    for k in a:
        assert a[k] == b[k], k


def _model():
    from tagdust_tpu_torch.arch import build_read_structure
    from tagdust_tpu_torch.logsum import p2sp
    from tagdust_tpu_torch.model import init_model_bag
    from tagdust_tpu_torch.stats import SequenceStats

    ssi = SequenceStats()
    ssi.average_length = 50
    ssi.max_seq_len = 64
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(build_read_structure(ARCH[1::2]), ssi, 0.05, 0.1)


def _reads(B: int, Lp: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    seqs[:, :6] = np.frombuffer(b"\x00\x01\x00\x02\x03\x02", dtype=np.uint8)  # ACAGTG
    return seqs, rng.integers(Lp // 2, Lp + 1, B).astype(np.int32)


def test_sub_batches_stay_inside_the_budget(monkeypatch):
    """With the budget cut to seven reads, every launch's buffers stay
    inside it, and the sub-batched results equal one unsplit call."""
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    eng = CudaEngine(_model(), "cpu")
    seqs, lens = _reads(40, 64)
    whole = eng.run_batch_fused(seqs, lens)
    budget = eng.launch_bytes(7, 64) + 100
    monkeypatch.setattr(eng, "STACK_BYTES", budget)
    assert eng.reads_within(64, budget) == 7
    calls = []
    full = eng._full

    def recording(s, ln):
        calls.append(eng.launch_bytes(*s.shape))
        return full(s, ln)

    monkeypatch.setattr(eng, "_full", recording)
    split = eng.run_batch_fused(seqs, lens)
    assert len(calls) == 6 and max(calls) <= budget
    for name in ("f_score", "r_score", "bar_prob", "mapq", "labels"):
        np.testing.assert_array_equal(getattr(split, name), getattr(whole, name))


def test_launch_bytes_count_every_buffer():
    """The count grows with the stack, the path (rows padded to 16) and the
    labels, and the largest launch is recorded."""
    eng = CudaEngine(_model(), "cpu")
    S, K = eng.lat.S, int(eng.tables["K"])
    H = int(eng.tables["tmat"].shape[0])
    Lp = 96
    one = eng.launch_bytes(1, Lp)
    assert one >= (Lp + 1) * (S + 1) * 4 + 16 * Lp * H + (Lp + 1) * 4
    assert eng.launch_bytes(16, Lp) == 16 * (one - 16 * Lp * H) + 16 * Lp * H
    cuda_mod.LAUNCH_STATS.update(reads=0, bytes=0)
    seqs, lens = _reads(12, Lp)
    eng.run_batch_fused(seqs, lens)
    assert cuda_mod.LAUNCH_STATS["bytes"] == eng.launch_bytes(256, Lp)


def test_streaming_hands_a_too_long_chunk_to_one_shot(tmp_path, monkeypatch):
    """The CLI over 40 reads in windows of 8: with a budget whose third
    holds fewer than 8 reads, the streaming loop labels no window and the
    one-shot path writes the same bytes."""
    from tagdust_tpu_torch.cli.tagdust import main

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "8")
    fq = str(tmp_path / "in.fq")
    rng = np.random.default_rng(5)
    with open(fq, "w") as fh:
        for i in range(40):
            seq = BARCODES[i % 2] + "".join(rng.choice(list("ACGT"), size=40))
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    out = {}
    for name, cut in (("streamed", False), ("one_shot", True)):
        runner._ENGINE_CACHE.clear()
        if cut:
            eng = CudaEngine(_model(), "cpu")
            monkeypatch.setattr(CudaEngine, "STACK_BYTES", 3 * eng.launch_bytes(7, 64))
        runner.STREAM_STATS["windows"] = 0
        main([*ARCH, fq, "-Q", "10", "-o", str(tmp_path / name), "-engine", "torch"])
        out[name] = (runner.STREAM_STATS["windows"], _outputs(str(tmp_path / name)))
    runner._ENGINE_CACHE.clear()
    assert out["streamed"][0] >= 3 and out["one_shot"][0] == 0
    assert out["streamed"][1] == out["one_shot"][1]


def test_a_read_over_the_budget_is_refused(monkeypatch):
    eng = CudaEngine(_model(), "cpu")
    monkeypatch.setattr(eng, "STACK_BYTES", eng.launch_bytes(1, 64) - 1)
    seqs, lens = _reads(4, 64)
    with pytest.raises(RuntimeError, match="a read padded to 64nt needs"):
        eng.run_batch_fused(seqs, lens)
