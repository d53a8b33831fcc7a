"""The label-carrying streaming rows of the port (``CudaEngine.dispatch_packed``
/ ``collect_packed``) and the two CLI paths that stream through them:
sub-range decodes (``-start/-end``) and fingerprints past 27nt.

* the rows, parsed back, equal ``run_batch_fused`` (labels, f, r, bar, q)
  and ``decided.dust_scores`` exactly: the same kernels' plain versions on
  the same CPU tensors;
* they agree with the JAX package's ``TpuEngine.collect_pallas(
  dispatch_pallas(...))`` (its Pallas kernels in interpret mode) at the
  tolerances of ``tests/test_pallas_kernel.py``: f within 1e-5 (plus 5e-7
  relative: at |f| near 90, where these 44-64nt reads score, one f32 ulp is
  7.6e-6), labels identical inside the reads, Q within 1e-2 (f32 sums over
  the states in another order), DUST on identical labels exact;
* ``launch_bytes`` counts the row;
* through the port's CLI (``-engine torch``, ``TAGDUST_TPU_WINDOW=64``) both
  paths stream in >= 3 windows and give the JAX CLI's bytes;
* a chunk whose streaming fails before its first window is labelled one-shot
  and counted (``STREAM_STATS["oneshot_after_failure"]``), one that fails
  later raises.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats

from tagdust_tpu_torch.engine import decided as D
from tagdust_tpu_torch.engine import runner
from tagdust_tpu_torch.engine.cuda import CudaEngine

from test_torch_cli import (
    _PORT_RUNNER, _REPO, _env, _outputs, BARCODES, write_fastq,
)

ARCHS = {
    "barcode": ["B:ACGTAC,TGCATG,CCAAGG", "R:N"],
    "finger30": ["B:ACGTAC,TGCATG", "F:" + "N" * 30, "R:N"],
}


def model(specs, max_len=64):
    ssi = SequenceStats()
    ssi.average_length = 40
    ssi.max_seq_len = max_len
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(build_read_structure(specs), ssi, 0.05, 0.1)


def batch_inputs(B=16, Lp=64, seed=5):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    heads = np.array([[0, 1, 2, 3, 0, 1], [3, 2, 1, 0, 3, 2]], dtype=np.uint8)
    seqs[: 3 * B // 4, :6] = heads[rng.integers(0, 2, 3 * B // 4)]
    lens = rng.integers(44, Lp + 1, B).astype(np.int32)
    return seqs, lens


@pytest.mark.parametrize("arch", list(ARCHS))
def test_packed_rows_equal_the_fused_batch_and_the_jax_rows(arch, monkeypatch):
    from tagdust_tpu.engine.tpu import TpuEngine

    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    mb = model(ARCHS[arch])
    eng = CudaEngine(mb, "cpu")
    seqs, lens = batch_inputs()
    B, Lp = seqs.shape
    rows = eng.dispatch_packed(seqs, lens)
    assert rows.dtype == torch.uint8
    assert tuple(rows.shape) == (B, eng.packed_row_bytes(Lp))
    got = eng.collect_packed(rows.numpy(), B - 3, Lp)
    ref = eng.run_batch_fused(seqs, lens)
    for k in ("f_score", "r_score", "bar_prob", "labels", "mapq"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k)[: B - 3], k)
    dust = D.dust_scores(torch.from_numpy(seqs), torch.from_numpy(ref.labels),
                         torch.from_numpy(lens), eng._dec_tables["is_r_full"])
    np.testing.assert_array_equal(got.dust, dust.numpy()[: B - 3])
    # the row is counted in the launch's buffers
    assert (eng.launch_bytes(B, Lp, packed=True) - eng.launch_bytes(B, Lp)
            == B * eng.packed_row_bytes(Lp))
    assert eng.reads_within(Lp, 1 << 24, True) <= eng.reads_within(Lp, 1 << 24)

    tpu = TpuEngine(mb)
    jres = tpu.collect_pallas(tpu.dispatch_pallas(seqs, lens), B - 3, Lp)
    np.testing.assert_allclose(got.f_score, jres.f_score, atol=1e-5, rtol=5e-7)
    np.testing.assert_allclose(got.r_score, jres.r_score, atol=1e-5, rtol=5e-7)
    np.testing.assert_allclose(got.bar_prob, jres.bar_prob, atol=1e-5, rtol=5e-7)
    np.testing.assert_array_equal(np.isfinite(got.mapq), np.isfinite(jres.mapq))
    fin = np.isfinite(got.mapq)
    np.testing.assert_allclose(got.mapq[fin], jres.mapq[fin], atol=1e-2)
    assert got.labels.dtype == jres.labels.dtype
    same = True
    for b in range(B - 3):
        L = int(lens[b])
        np.testing.assert_array_equal(got.labels[b, 1 : L + 1],
                                      jres.labels[b, 1 : L + 1])
        same &= np.array_equal(got.labels[b], jres.labels[b])
    if same:
        np.testing.assert_array_equal(got.dust, jres.dust)
    else:
        np.testing.assert_array_equal(got.dust[:, 1], jres.dust[:, 1])


CLI = {
    # -start/-end over the barcode and 30nt of the read
    "subrange": (["-1", f"B:{','.join(BARCODES)}", "-2", "R:N", "-start", "1",
                  "-end", "36"], 7),
    # a 30nt fingerprint: its key overflows the packed 2-bit form
    "finger30": (["-1", f"B:{','.join(BARCODES)}", "-2", "F:" + "N" * 30, "-3",
                  "R:N"], 8),
    # the sub-range with the DUST filter: host DUST on this path
    "subrange_dust": (["-1", f"B:{','.join(BARCODES)}", "-2", "R:N", "-start",
                       "1", "-end", "36", "-dust", "3"], 9),
}


def write_long_fastq(path: str, n: int, seed: int) -> None:
    """Barcode + 30nt fingerprint + insert (a tenth random reads)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n):
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(50, 70))))
            if rng.random() < 0.9:
                ins = BARCODES[int(rng.integers(len(BARCODES)))] + ins
            fh.write(f"@r{i}\n{ins}\n+\n{'I' * len(ins)}\n")


@pytest.mark.parametrize("case", list(CLI))
def test_cli_streams_label_carrying_rows_with_the_jax_bytes(tmp_path, case):
    args, seed = CLI[case]
    fq = str(tmp_path / "in.fq")
    if case == "finger30":
        write_long_fastq(fq, 400, seed)
    else:
        write_fastq(fq, 400, seed)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    common = [*args, fq, "-Q", "10"]
    subprocess.run(
        [sys.executable, "-m", "tagdust_tpu.cli.tagdust", *common, "-o",
         jax_out, "-engine", "tpu"],
        check=True, capture_output=True, cwd=_REPO,
        env=_env(TAGDUST_TPU_PALLAS="0", TAGDUST_TPU_STRICT="1",
                 TAGDUST_TPU_MESH="0"),
    )
    res = subprocess.run(
        [sys.executable, "-c", _PORT_RUNNER, *common, "-o", port_out,
         "-engine", "torch"],
        check=True, capture_output=True, text=True, cwd=_REPO,
        env=_env(TAGDUST_TPU_BT="8", TAGDUST_TPU_WINDOW="64",
                 OMP_NUM_THREADS="2", MKL_NUM_THREADS="2"),
    )
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["windows"] >= 3 and stats["plain_cuda"] == 0
    a, b = _outputs(jax_out), _outputs(port_out)
    assert a.keys() == b.keys() and any(k.startswith("_BC_") for k in a)
    for k in a:
        assert a[k] == b[k], k
    if case == "finger30":
        assert any(b";FP:" in v for v in b.values())


class _Param:
    matchstart = 0
    matchend = 36
    minlen = 16
    engine = "torch"
    dust = 0
    rtest = False


def _chunk(tmp_path, n=200):
    from tagdust_tpu_torch.io.fastq import SeqReader

    fq = str(tmp_path / "in.fq")
    write_fastq(fq, n, seed=4)
    reader = SeqReader(fq)
    batch = reader.read_chunk_batch(n)
    reader.close()
    return batch


@pytest.mark.parametrize("fail_at", [0, 2])
def test_streaming_failure_is_counted_or_raised(tmp_path, monkeypatch, fail_at):
    """A window that fails before any was extracted sends the chunk to the
    one-shot path and is counted; once a window was extracted (its spacers
    are in the arena) the failure raises."""
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "32")
    monkeypatch.setenv("TAGDUST_TPU_PIPELINE_DEPTH", "1")
    mb = model([f"B:{','.join(BARCODES)}", "R:N"])
    batch = _chunk(tmp_path)
    eng = runner.get_engine(mb, "torch")
    calls = {"n": 0}
    real = eng.dispatch_packed

    def flaky(seqs, lens):
        calls["n"] += 1
        if calls["n"] == fail_at + 1:
            raise RuntimeError("CUDA kernel td_fwd failed to launch (cudaError 1)")
        return real(seqs, lens)

    monkeypatch.setattr(eng, "dispatch_packed", flaky)
    runner.STREAM_STATS.update(windows=0, oneshot_after_failure=0)
    if fail_at:
        with pytest.raises(RuntimeError, match="td_fwd"):
            runner.run_get_label_batch(mb, mb.rs, batch, _Param(), 0.0)
        assert runner.STREAM_STATS["oneshot_after_failure"] == 0
        assert runner.STREAM_STATS["windows"] >= 1
    else:
        runner.run_get_label_batch(mb, mb.rs, batch, _Param(), 0.0)
        assert runner.STREAM_STATS == {"windows": 0, "oneshot_after_failure": 1}
        assert (batch.read_type == 0).sum() > 100
