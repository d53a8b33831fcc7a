"""``-arch`` detection of the port against the JAX package, on the CPU.

``tagdust_tpu_torch.detect.test_architectures`` with ``-engine torch``
scores the candidates through the plain K4 (``CudaEngine.backward_scores``
on CPU tensors) in the step mode the port's gate picks; it must choose the
same architecture and log the same "Using:" and "Confidence" lines as the
JAX ``test_architectures`` with ``-engine tpu`` (Pallas score-only kernel
in interpret mode) and with ``-engine exact`` (the host engine).  Per-read
scores are held against the exact engine within 0.25, the table-logsum
bound of tests/test_detect_device.py.
"""

import itertools

import numpy as np
import pytest

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.config import parse_args
from tagdust_tpu.engine.exact import ExactEngine
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats

from tagdust_tpu_torch.config import parse_args as port_parse_args
from tagdust_tpu_torch.engine import fused_kernel, runner
from tagdust_tpu_torch.engine.cuda import CudaEngine

BARS = ["ACGTAC", "TGCATG"]
BIG = ["".join(p) for p in itertools.product("ACGT", repeat=6)][7::83][:48]
# candidate sets: the fixture of tests/test_detect_device.py:59, and one
# with a 48-barcode candidate (591 states), scored in the grouped step mode
CANDIDATES = {
    "pair": ["tagdust -1 B:ACGTAC,TGCATG -2 R:N", "tagdust -1 R:N"],
    "grouped": [f"tagdust -1 B:{','.join(BIG)} -2 R:N",
                "tagdust -1 B:ACGTAC,TGCATG -2 R:N", "tagdust -1 R:N"],
}


def make_ssi(avg=30, mx=48):
    ssi = SequenceStats()
    ssi.average_length = avg
    ssi.max_seq_len = mx
    ssi.background = np.log(
        np.array([0.24990, 0.24990, 0.24990, 0.24990, 0.0004], np.float32)
    )
    return ssi


def write_reads(path, n=400, seed=11):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n):
            body = "".join("ACGT"[b] for b in rng.integers(0, 4, 24))
            seq = BARS[i % 2] + body
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


class _Log(list):
    def __call__(self, m):
        self.append(m)

    def __bool__(self):  # detection logs only to a truthy log
        return True


def _detect(fn, fq, arch, engine, out, parse=parse_args):
    lg = _Log()
    param = parse([str(fq), "-arch", str(arch), "-engine", engine, "-Q", "10",
                        "-o", str(out)])
    rs = fn(param, 0, log=lg)
    lines = [m for m in lg if "Confidence" in m or m.startswith("Using")]
    return rs.types, [list(s) for s in rs.seqs], lines


@pytest.mark.parametrize("cands", sorted(CANDIDATES))
def test_detection_matches_jax(tmp_path, monkeypatch, cands):
    from tagdust_tpu.detect import test_architectures as jax_detect

    from tagdust_tpu_torch.detect import test_architectures as port_detect

    monkeypatch.delenv("TAGDUST_TPU_GROUPED", raising=False)
    fq = tmp_path / "det.fq"
    write_reads(fq)
    arch = tmp_path / "arch.txt"
    arch.write_text("".join(line + "\n" for line in CANDIDATES[cands]))
    before = dict(fused_kernel.LAUNCHES)
    if cands == "grouped":
        # every candidate scored in the grouped step mode (the gate picks
        # the dense one for all of them)
        monkeypatch.setenv("TAGDUST_TPU_GROUPED", "1")
    port = _detect(port_detect, fq, arch, "torch", tmp_path / "o_port",
                   port_parse_args)
    monkeypatch.delenv("TAGDUST_TPU_GROUPED", raising=False)
    assert fused_kernel.LAUNCHES == before
    for eng in ("tpu", "exact"):
        assert _detect(jax_detect, fq, arch, eng, tmp_path / f"o_{eng}") == port, eng
    # -engine exact through the port runs its copy of the host detection
    assert _detect(port_detect, fq, arch, "exact", tmp_path / "o_px",
                   port_parse_args) == port
    assert port[0][0] == "B" and port[1][0][:2] == BARS
    assert len(port[2]) == 2 and port[2][1].endswith("Confidence.\n")
    # the 48-barcode candidate was scored in the grouped step mode
    if cands == "grouped":
        assert any(e.lat.S == 591 and e.scorer.grouped
                   for e in runner._ENGINE_CACHE.values() if isinstance(e, CudaEngine))


@pytest.mark.parametrize("specs", [
    ["B:ACGTAC,TGCATG,CCAAGG", "R:N"], ["R:N"],
    ["P:GGGG", "B:AC,GT", "R:N", "P:TTTT"],
], ids=["B+R", "R", "P+B+R+P"])
def test_backward_scores_match_exact(specs):
    """The port's K4 scores (plain, CPU) against the host exact engine's
    MODE_ARCH_COMP scores, ragged lengths."""
    rng = np.random.default_rng(7)
    mb = init_model_bag(build_read_structure(specs), make_ssi(), 0.05, 0.1)
    B, L = 24, 36
    lens = rng.integers(12, L + 1, B).astype(np.int32)
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    dev = CudaEngine(mb, "cpu").backward_scores(seqs, lens)
    ex = ExactEngine(mb)
    host = np.zeros(B, dtype=np.float32)
    for Lb in np.unique(lens):
        idxs = np.nonzero(lens == Lb)[0]
        sb = np.zeros((len(idxs), int(Lb) + 1), dtype=np.uint8)
        sb[:, :Lb] = seqs[idxs, :Lb]
        host[idxs] = ex.backward_only(sb, int(Lb))
    assert np.abs(dev - host).max() < 0.25
