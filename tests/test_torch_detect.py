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


# ---------------------------------------------------------------------------
# Columnar detection: the matrix, the exact buckets and the pick against the
# per-read versions they replaced, kept here as oracles.

from tagdust_tpu_torch import detect as port_detect_mod  # noqa: E402
from tagdust_tpu_torch.engine.runner import thread_slices  # noqa: E402
from tagdust_tpu_torch.io.fastq import SeqReader  # noqa: E402

PAIR_ARCH = "".join(line + "\n" for line in CANDIDATES["pair"])


def _old_fill(reads):
    """The per-read fill ``_device_scores`` ran before its matrix was
    gathered from the batch's arena."""
    lens = np.fromiter((r.len for r in reads), dtype=np.int32, count=len(reads))
    seqs = np.zeros((len(reads), int(lens.max(initial=1))), dtype=np.uint8)
    for i, r in enumerate(reads):
        seqs[i, : r.len] = r.seq
    return seqs, lens


def _old_exact(reads, models):
    bscores = np.zeros((len(models), len(reads)), dtype=np.float32)
    engines = [ExactEngine(mb) for mb in models]
    buckets = {}
    for idx, r in enumerate(reads):
        buckets.setdefault(r.len, []).append(idx)
    for L, idxs in buckets.items():
        seqs = np.zeros((len(idxs), L + 1), dtype=np.uint8)
        for bi, idx in enumerate(idxs):
            seqs[bi, :L] = reads[idx].seq
        for a, eng in enumerate(engines):
            bscores[a, idxs] = eng.backward_only(seqs, L)
    return bscores


def _old_pick(bscores, num_threads):
    """(posterior, winner, confidence) by the per-read loop of float32 sums."""
    n_arch, numseq = bscores.shape
    posterior = np.zeros(n_arch, dtype=np.float32)
    for s, e in thread_slices(numseq, num_threads):
        part = np.zeros(n_arch, dtype=np.float32)
        for i in range(s, e):
            part = (part + bscores[:, i]).astype(np.float32)
        posterior = (posterior + part).astype(np.float32)
    sums = posterior.copy()
    posterior = (posterior - port_detect_mod._logsum_all(posterior)).astype(np.float32)
    sm = port_detect_mod._logsum_all(posterior)
    best, best_score = -1, np.float32(-1.0)
    for i in range(n_arch):
        with np.errstate(over="ignore"):
            p = np.float32(np.exp(np.float64(np.float32(posterior[i] - sm))))
        if p > best_score:
            best, best_score = i, p
    return sums, best, best_score


def _mixed_reads(n, seed):
    """Reads of 0-60nt with N bases, every 37th empty, two in three carrying
    a candidate's barcode."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = "".join("ACGTN"[b] for b in rng.choice(5, rng.integers(0, 55),
                                                      p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        out.append("" if i % 37 == 5 else (BARS[i % 2] + body) if i % 3 else body)
    return out


def _write_input(tmp_path, fmt, n, seed):
    seqs = _mixed_reads(n, seed)
    if fmt == "fasta":
        path = tmp_path / "det.fa"
        path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    elif fmt == "sam":
        path = tmp_path / "det.sam"
        rows = ["@HD\tVN:1.6"]
        for i, s in enumerate(seqs):
            flag = (0, 4, 256, 16)[i % 4]  # -filter 0x4 drops the unmapped
            rows.append(f"r{i}\t{flag}\t*\t0\t{i % 60}\t*\t*\t0\t0\t{s}\t{'I' * len(s)}")
        path.write_text("\n".join(rows) + "\n")
    else:
        path = tmp_path / "det.fq"
        path.write_text("".join(f"@r{i}\n{s}\n+\n{'#' * len(s)}\n"
                                for i, s in enumerate(seqs)))
    return path


# (format, reads in the file, NUM_QUERY, -filter, pure-Python parser)
COLUMNAR = {
    "fastq_mixed_N": ("fastq", 300, 240, None, False),
    "fastq_python_parser": ("fastq", 300, 240, None, True),
    "fasta": ("fasta", 250, 200, None, False),
    "sam_filter": ("sam", 320, 150, "0x4", False),
    "short_file": ("fastq", 90, port_detect_mod.NUM_QUERY, None, False),
}


@pytest.mark.parametrize("case", sorted(COLUMNAR))
def test_columnar_matrix_equals_the_per_read_fill(tmp_path, monkeypatch, case):
    """The [numseq, Lmax] matrix and lengths detection hands to
    ``_pad_tpu_batch`` (gathered from ``read_chunk_batch``'s arena) equal the
    per-read fill of ``read_chunk``'s reads, and the exact engine's columnar
    buckets give the per-read buckets' scores bit for bit."""
    fmt, n, num_query, sam_filter, python_parser = COLUMNAR[case]
    if python_parser:
        monkeypatch.setenv("TAGDUST_TPU_FAST_IO", "0")
    monkeypatch.setattr(port_detect_mod, "NUM_QUERY", num_query)
    path = _write_input(tmp_path, fmt, n, seed=len(case))
    arch = tmp_path / "arch.txt"
    arch.write_text(PAIR_ARCH)
    handed = []
    real_pad = port_detect_mod._pad_tpu_batch

    def capture(seqs, lens):
        handed.append((seqs.copy(), lens.copy()))
        return real_pad(seqs, lens)

    monkeypatch.setattr(port_detect_mod, "_pad_tpu_batch", capture)
    args = [str(path), "-arch", str(arch), "-engine", "torch", "-Q", "10",
            "-o", str(tmp_path / "o")]
    if sam_filter:
        args += ["-filter", sam_filter]
    param = port_parse_args(args)
    port_detect_mod.test_architectures(param, 0)

    reader = SeqReader(str(path), sam_filter=sam_filter)
    reads = reader.read_chunk(num_query)
    reader.close()
    # -filter 0x4 keeps the secondary records (flag 256) and drops the
    # unmapped (flag 4), one in four
    in_file = n - (n + 2) // 4 if sam_filter else n
    assert len(reads) == min(num_query, in_file)
    seqs, lens = _old_fill(reads)
    assert len(handed) == 1
    got_seqs, got_lens = handed[0]
    assert got_seqs.dtype == seqs.dtype and got_lens.dtype == lens.dtype
    np.testing.assert_array_equal(got_lens, lens)
    np.testing.assert_array_equal(got_seqs, seqs)
    assert (lens == 0).any() and (seqs == 4).any()  # empty reads and N bases

    reader = SeqReader(str(path), sam_filter=sam_filter)
    batch = reader.read_chunk_batch(num_query)
    reader.close()
    models = [init_model_bag(build_read_structure(s.split()[1:][1::2]),
                             make_ssi(), 0.05, 0.1)
              for s in CANDIDATES["pair"]]
    new = port_detect_mod._exact_scores(batch, models)
    old = _old_exact(reads, models)
    np.testing.assert_array_equal(new.view(np.uint32), old.view(np.uint32))


@pytest.mark.parametrize("numseq,num_threads", [
    (1000, 8), (1003, 8), (999, 7), (100000 - 13, 16), (5, 8), (1, 4), (0, 3),
])
def test_pick_is_bit_identical_to_the_per_read_loop(numseq, num_threads):
    """``_slice_sums`` and ``_pick`` against the per-read float32 loop: the
    same posterior bits, winner and confidence, with ``-inf`` scores, slices
    of unequal length and empty slices."""
    rng = np.random.default_rng(numseq * 31 + num_threads)
    for n_arch in (2, 3, 5):
        bscores = rng.normal(-40.0, 15.0, (n_arch, numseq)).astype(np.float32)
        if numseq:
            bscores[rng.integers(0, n_arch), rng.integers(0, numseq)] = -np.inf
            bscores[:, rng.integers(0, numseq)] *= np.float32(1e3)
        sums, best, conf = _old_pick(bscores, num_threads)
        got = port_detect_mod._slice_sums(bscores, num_threads)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), sums.view(np.uint32))
        got_best, got_conf = port_detect_mod._pick(bscores, num_threads)
        assert got_best == best
        assert np.float32(got_conf).view(np.uint32) == np.float32(conf).view(np.uint32)
