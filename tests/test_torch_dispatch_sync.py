"""A streaming window's dispatch enqueues its work and returns without
waiting for the card.

The decided-mode pipeline (``runner._label_streaming``, DEPTH windows in
flight) overlaps the host's work on windows k-1 and k+1 with the card's on
window k only if ``dispatch_decided`` returns before window k's kernels
end.  A tensor built from host data in the per-window epilogue
(``torch.tensor(list, device=...)``) is a synchronous copy that waits for
them.

* On the CPU: ``dispatch_decided`` and ``dispatch_packed`` run their
  epilogues (``CudaEngine._full``'s, ``decided.decided_rows``,
  ``decided.dust_scores``) under a torch function mode that fails on
  ``torch.tensor``, ``torch.as_tensor`` and ``torch.from_numpy``; only the
  uploads (``CudaEngine._upload``) may build one.  The scorer's outputs are
  computed beforehand, outside the mode (the plain versions build their
  tables from numpy; the kernels replace them on the card).  The CPU
  engine writes no ``runner.left_running``.
* On the card (``-m cuda``): under ``torch.cuda.set_sync_debug_mode
  ("error")`` three windows through ``dispatch_decided`` and one through
  ``dispatch_packed`` give the rows of a run that synchronises after every
  window, and a chunk of several windows streamed by ``_label_streaming``
  leaves the card working after at least all its windows' dispatches but
  one (``runner.left_running``).  The same holds for a chunk streamed over
  two shards on the one card (``_mesh_scorer``, ``ShardedScorer``), with
  decided and with label-carrying rows (a ``-start/-end`` range), whose
  decisions, sequences and fingerprints equal the one engine's.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tagdust_tpu_torch import spans
from tagdust_tpu_torch.arch import build_read_structure
from tagdust_tpu_torch.engine import runner
from tagdust_tpu_torch.engine.cuda import CudaEngine
from tagdust_tpu_torch.flagship import PLATE_PATH, generate_barcodes, load_barcodes
from tagdust_tpu_torch.logsum import p2sp
from tagdust_tpu_torch.model import init_model_bag
from tagdust_tpu_torch.stats import SequenceStats

LIBRARIES = {
    "8x6nt": lambda: generate_barcodes(8, 6),
    "48x6nt": lambda: generate_barcodes(48, 6, 3, seed=2024),
    "plate96x8nt": lambda: load_barcodes(PLATE_PATH),
}

HOST_DATA = (torch.tensor, torch.as_tensor, torch.from_numpy)


def model(barcodes, specs=("R:N",)):
    ssi = SequenceStats()
    ssi.average_length = 50
    ssi.max_seq_len = 64
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    rs = build_read_structure([f"B:{','.join(barcodes)}", *specs])
    return init_model_bag(rs, ssi, 0.05, 0.1)


def window(barcodes, B, Lp=64, seed=0):
    """[B, Lp] reads, nine in ten starting with a barcode, and their
    lengths."""
    rng = np.random.default_rng(seed)
    codes = np.array([["ACGT".index(c) for c in b] for b in barcodes], np.uint8)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    k = codes.shape[1]
    tagged = rng.random(B) < 0.9
    seqs[tagged, :k] = codes[rng.integers(0, len(barcodes), int(tagged.sum()))]
    lens = rng.integers(Lp // 2, Lp - 7, B).astype(np.int32)
    return seqs, lens


class NoHostData(TorchFunctionMode):
    """Fails on a tensor built from host data, except inside an upload."""

    def __init__(self):
        super().__init__()
        self.uploading = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in HOST_DATA and not self.uploading:
            raise AssertionError(f"torch.{func.__name__} in a window's epilogue")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("specs", [("R:N",), ("F:NNNN", "R:N")],
                         ids=["barcode", "fingerprint"])
def test_epilogues_build_no_tensor_from_host_data(specs, monkeypatch):
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    barcodes = LIBRARIES["8x6nt"]()
    eng = CudaEngine(model(barcodes, specs), "cpu")
    seqs, lens = window(barcodes, 32)
    thr32 = eng.threshold_f32_ceil(0.5)
    want_dec = eng.dispatch_decided(seqs, lens, thr32, 16)
    want_pk = eng.dispatch_packed(seqs, lens)
    outs = eng.scorer(eng._upload_seqs(seqs), eng._upload(lens))
    monkeypatch.setattr(eng, "scorer", lambda s, ln: outs)

    mode = NoHostData()
    upload = eng._upload

    def allowed_upload(x):
        mode.uploading = True
        try:
            return upload(x)
        finally:
            mode.uploading = False

    monkeypatch.setattr(eng, "_upload", allowed_upload)
    with mode:
        with pytest.raises(AssertionError, match="torch.tensor"):
            torch.tensor([128, 64, 32, 16, 8, 4, 2, 1])
        got_dec = eng.dispatch_decided(seqs, lens, thr32, 16)
        got_pk = eng.dispatch_packed(seqs, lens)
    assert torch.equal(got_dec, want_dec)
    assert torch.equal(got_pk, want_pk)


class _Param:
    matchstart = -1
    matchend = -1
    minlen = 16
    dust = 0
    rtest = False

    def __init__(self, engine):
        self.engine = engine


class _SubParam(_Param):
    """``-start 1 -end 36``: label-carrying rows (``dispatch_packed``)."""
    matchstart = 0
    matchend = 36


def _chunk(tmp_path, barcodes, n, seed=3):
    """A ReadBatch of ``n`` reads of 32-56nt read back from a FASTQ file."""
    from tagdust_tpu_torch.io.fastq import SeqReader

    seqs, lens = window(barcodes, n, Lp=64, seed=seed)
    fq = str(tmp_path / "in.fq")
    with open(fq, "w") as fh:
        for i in range(n):
            s = "".join("ACGT"[c] for c in seqs[i, : lens[i]])
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    reader = SeqReader(fq)
    batch = reader.read_chunk_batch(n)
    reader.close()
    return batch


def _stream(mb, batch, kind, param=None):
    """Stream one chunk through ``_label_streaming``; (windows, the job's
    record)."""
    spans.reset()
    runner.STREAM_STATS.update(windows=0, oneshot_after_failure=0)
    param = param or _Param(kind)
    assert runner._label_streaming(mb, mb.rs, batch, param, 0.0, kind)
    assert runner.STREAM_STATS["oneshot_after_failure"] == 0
    windows = runner.STREAM_STATS["windows"]
    assert spans.TIMINGS["runner.dispatch.calls"] == windows
    return windows, dict(spans.TIMINGS)


def test_cpu_engine_counts_no_window_left_running(tmp_path, monkeypatch):
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "32")
    barcodes = LIBRARIES["8x6nt"]()
    mb = model(barcodes)
    windows, timings = _stream(mb, _chunk(tmp_path, barcodes, 120), "torch")
    assert windows >= 3
    assert timings.get("runner.left_running", 0) == 0


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("library", list(LIBRARIES))
def test_card_dispatch_never_synchronises(library):
    _need_card()
    barcodes = LIBRARIES[library]()
    eng = CudaEngine(model(barcodes), "cuda")
    B = 4096
    wins = [window(barcodes, B, seed=s) for s in range(4)]
    thr32 = eng.threshold_f32_ceil(0.5)

    def run_all(sync):
        out = []
        for i, (seqs, lens) in enumerate(wins):
            out.append(eng.dispatch_decided(seqs, lens, thr32, 16) if i < 3
                       else eng.dispatch_packed(seqs, lens))
            if sync:
                torch.cuda.synchronize()
        return out

    want = run_all(sync=True)  # also the warm-up: the first launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run_all(sync=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_streaming_leaves_the_card_working(tmp_path):
    _need_card()
    barcodes = LIBRARIES["plate96x8nt"]()
    mb = model(barcodes)
    # the plate's windows are about 7,000 reads (STACK_BYTES / DEPTH)
    batch = _chunk(tmp_path, barcodes, 30000)
    runner.get_engine(mb, "cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        windows, timings = _stream(mb, batch, "cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert windows >= 3
    assert timings["runner.left_running"] >= windows - 1


@pytest.mark.cuda
@pytest.mark.parametrize("param", [_Param, _SubParam], ids=["decided", "label-carrying"])
def test_card_streaming_over_two_shards_on_one_card(tmp_path, monkeypatch, param):
    _need_card()
    from tagdust_tpu_torch.parallel.mesh import ShardedScorer

    barcodes = LIBRARIES["plate96x8nt"]()
    mb = model(barcodes)
    monkeypatch.setattr(runner, "local_devices",
                        lambda: [torch.device("cuda", 0)] * 2)
    sharded = [0]
    for name in ("dispatch_decided", "dispatch_packed"):
        real = getattr(ShardedScorer, name)

        def spy(self, *a, _real=real, **k):
            sharded[0] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(ShardedScorer, name, spy)
    runner.get_engine(mb, "cuda")
    out = {}
    for mesh in ("1", "0"):
        monkeypatch.setenv("TAGDUST_TPU_MESH", mesh)
        batch = _chunk(tmp_path, barcodes, 30000)
        torch.cuda.set_sync_debug_mode("error")
        try:
            windows, timings = _stream(mb, batch, "cuda", param("cuda"))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert windows >= 3
        assert timings["runner.left_running"] >= windows - 1, (mesh, timings)
        out[mesh] = batch
        if mesh == "1":
            assert sharded[0] == windows
    for k in ("read_type", "barcode", "seq_arena", "fingerprint"):
        np.testing.assert_array_equal(getattr(out["1"], k), getattr(out["0"], k), k)
    if out["1"].dust_device is not None:
        np.testing.assert_array_equal(out["1"].dust_device, out["0"].dust_device)
