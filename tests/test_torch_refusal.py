"""A lattice the card cannot run is refused before any read is scored.

``CudaEngine`` on a CUDA device asks ``td_reads_per_block`` for K1/K4 and
for K2 when it is built; a lattice whose carries for one read do not fit a
block's shared memory raises a ``RuntimeError`` that names its states, the
bytes one read needs, the card's limit and ``-engine torch``.  Nothing
falls back to the plain versions on CUDA tensors.  Here a stub of the
kernel library stands in for the card: its ``td_reads_per_block`` fits no
read.
"""

import glob
import os

import numpy as np
import pytest
import torch

from tagdust_tpu_torch.engine import build, runner
from tagdust_tpu_torch.engine.cuda import CudaEngine

BARCODES = ["ACGTAC", "TGCATG", "CCAAGG"]


class _Unfit:
    """A kernel library whose blocks hold no read of any lattice."""

    def __init__(self):
        self.calls = []

    def td_reads_per_block(self, fwd, *args):
        self.calls.append(fwd)
        out = args[-1]  # the address of stage, one read's bytes, the limit
        import ctypes

        vals = (ctypes.c_longlong * 3).from_address(out)
        vals[1], vals[2] = 300000, 232448
        return 0


@pytest.fixture
def unfit(monkeypatch):
    stub = _Unfit()
    monkeypatch.setattr(build, "lib", lambda: stub)
    runner._ENGINE_CACHE.clear()
    yield stub
    runner._ENGINE_CACHE.clear()


def _model():
    from tagdust_tpu_torch.arch import build_read_structure
    from tagdust_tpu_torch.logsum import p2sp
    from tagdust_tpu_torch.model import init_model_bag
    from tagdust_tpu_torch.stats import SequenceStats

    ssi = SequenceStats()
    ssi.average_length = 40
    ssi.max_seq_len = 64
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    rs = build_read_structure([f"B:{','.join(BARCODES)}", "R:N"])
    return init_model_bag(rs, ssi, 0.05, 0.1)


def test_engine_refuses_when_built(unfit):
    """The refusal comes from the constructor, names the lattice, the bytes
    and the limit, and never reaches a CUDA tensor (this rig has none)."""
    mb = _model()
    with pytest.raises(RuntimeError) as err:
        CudaEngine(mb, "cuda")
    msg = str(err.value)
    assert f"{CudaEngine(mb, 'cpu').lat.S} states" in msg
    assert "300000 bytes" in msg and "232448 bytes" in msg
    assert "-engine torch" in msg
    assert unfit.calls == [0]  # K1/K4 asked first, and refused


@pytest.mark.parametrize("calibrate", [False, True], ids=["-Q", "calibrated"])
def test_cli_refuses_before_any_output(tmp_path, monkeypatch, unfit, calibrate):
    """``-engine cuda`` with the card's check failing: the run raises before
    it writes any output file, with -Q given and with calibration."""
    from tagdust_tpu_torch.cli.tagdust import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fq = str(tmp_path / "in.fq")
    rng = np.random.default_rng(2)
    with open(fq, "w") as fh:
        for i in range(30):
            seq = BARCODES[i % 3] + "".join(rng.choice(list("ACGT"), size=40))
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    prefix = str(tmp_path / "out")
    args = ["-1", f"B:{','.join(BARCODES)}", "-2", "R:N", fq, "-o", prefix,
            "-engine", "cuda"] + ([] if calibrate else ["-Q", "20"])
    with pytest.raises(RuntimeError, match="does not fit the card"):
        main(args)
    assert glob.glob(prefix + "*") == []
    assert os.listdir(tmp_path) == ["in.fq"]


def test_cpu_engine_is_unaffected(unfit):
    """The CPU engine never asks the kernel library and scores as before."""
    eng = CudaEngine(_model(), "cpu")
    rng = np.random.default_rng(4)
    seqs = rng.integers(0, 4, (8, 32)).astype(np.uint8)
    lens = np.full(8, 30, dtype=np.int32)
    res = eng.run_batch_fused(seqs, lens)
    assert np.isfinite(res.f_score).all() and unfit.calls == []
