"""Architecture auto-detection (``-arch``) of the port.

The counterpart of ``tagdust_tpu/detect.py:test_architectures``
(``test_architectures.c:20-289``): every "tagdust" line of the ``-arch``
file is a candidate with its own sequence-stats pass and model; with more
than one candidate the first 100,000 reads are scored backward-only per
candidate, the per-read log likelihoods are summed in float32 within each
emulated thread slice and the slices in thread order
(``barcode_hmm.c:2111-2148``, ``:1994-2017``), and a softmax, normalised
twice as the reference does, picks the winner.

The reads stay columnar from the parse to the pick: one ``ReadBatch``
(``SeqReader.read_chunk_batch``), padded matrices gathered from its arena,
and the slice sums taken over the [n_arch, numseq] scores as arrays.
On a device kind (``cuda``, ``torch``) the reads form one padded batch and
each candidate is scored by ``CudaEngine.backward_scores`` (K4, in the step
mode the engine's gate picks); on ``exact`` the reads are bucketed by length
and scored by ``ExactEngine.backward_only``, as the JAX package's host
branch does.
"""

from __future__ import annotations

import numpy as np

from .arch import (
    ReadStructure,
    build_read_structure,
    parse_arch_line,
    qc_read_structure,
    read_arch_file,
)
from .engine.exact import ExactEngine
from .engine.runner import (
    DEVICE_KINDS,
    _pad_tpu_batch,
    get_engine,
    resolve_engine,
    thread_slices,
)
from .io.batch import padded_matrix
from .io.fastq import SeqReader
from .logsum import logsum
from .model import init_model_bag
from .spans import count, span
from .stats import get_sequence_stats

NUM_QUERY = 100000
_F32 = np.float32


def _device_scores(batch, models, kind: str) -> np.ndarray:
    """[n_arch, numseq] logP_b of every read under every candidate, from
    one padded [B, Lmax] batch per candidate (MODE_ARCH_COMP)."""
    numseq = batch.B
    lens = batch.lens.astype(np.int32)
    Lmax = int(lens.max(initial=1))
    seqs = padded_matrix(batch.seq_arena, batch.seq_off, lens, Lmax, fill=0)
    seqs_p, lens_p = _pad_tpu_batch(seqs, lens)
    return np.stack([
        get_engine(mb, kind).backward_scores(seqs_p, lens_p)[:numseq]
        for mb in models
    ]).astype(np.float32)


def _exact_scores(batch, models) -> np.ndarray:
    """[n_arch, numseq] backward-only scores on the exact engine, the reads
    bucketed by length (the per-read values do not depend on the
    bucketing)."""
    lens = batch.lens
    bscores = np.zeros((len(models), batch.B), dtype=np.float32)
    engines = [ExactEngine(mb) for mb in models]
    order = np.argsort(lens, kind="stable")
    Ls, starts = np.unique(lens[order], return_index=True)
    for L, idxs in zip(Ls.tolist(), np.split(order, starts[1:])):
        seqs = padded_matrix(batch.seq_arena, batch.seq_off[idxs], lens[idxs],
                             L + 1, fill=0)
        for a, eng in enumerate(engines):
            bscores[a, idxs] = eng.backward_only(seqs, L)
    return bscores


def pretty_print_selected_architecture(line: str) -> str:
    """test_architectures.c:292-345."""
    specs = parse_arch_line(line)
    return "Using: " + " ".join(f"-{i + 1} {s}" for i, s in enumerate(specs)) + " \n"


def _logsum_all(x: np.ndarray):
    sm = x[0]
    for v in x[1:]:
        sm = logsum(sm, v)
    return sm


def _slice_sums(bscores: np.ndarray, num_threads: int) -> np.ndarray:
    """[n_arch] float32 sums of the scores within each emulated thread slice,
    the slices added in thread order (barcode_hmm.c:2126-2144, :2000).
    ``np.add.accumulate`` adds strictly in order, as the reference's per-read
    loop does; ``np.sum``'s pairwise sum would change the bits."""
    n_arch, numseq = bscores.shape
    posterior = np.zeros(n_arch, dtype=np.float32)
    for s, e in thread_slices(numseq, num_threads):
        part = (np.add.accumulate(bscores[:, s:e], axis=1, dtype=np.float32)[:, -1]
                if e > s else np.zeros(n_arch, dtype=np.float32))
        posterior = (posterior + part).astype(np.float32)
    return posterior


def _pick(bscores: np.ndarray, num_threads: int) -> tuple:
    """(winner, its probability): the slice sums, then run_pHMM's
    normalisation (:2009-2016) and test_architectures' second one
    (:191-206)."""
    n_arch = bscores.shape[0]
    posterior = _slice_sums(bscores, num_threads)
    posterior = (posterior - _logsum_all(posterior)).astype(np.float32)
    sm = _logsum_all(posterior)
    best, best_score = -1, _F32(-1.0)
    for i in range(n_arch):
        with np.errstate(over="ignore"):
            p = _F32(np.exp(np.float64(_F32(posterior[i] - sm))))
        if p > best_score:
            best, best_score = i, p
    return best, best_score


def test_architectures(param, file_num: int, log=None) -> ReadStructure:
    """The read structure of the best candidate of ``param.arch_file`` for
    input file ``file_num``; logs the choice and its confidence."""
    kind = resolve_engine(param)
    path = param.infile[file_num]
    entries = read_arch_file(param.arch_file)
    if log:
        log(f"Looking at file:{path}\n")
        log(f"Searching for best architecture in file '{param.arch_file}'\n")
    candidates = []
    for line, specs in entries:
        rs = build_read_structure(specs)
        with span("detect.stats"):
            ssi = get_sequence_stats(
                path, rs, NUM_QUERY, param.matchstart, param.matchend,
                sam_filter=param.filter,
            )
        qc_read_structure(rs)
        with span("detect.build"):
            mb = init_model_bag(rs, ssi, param.sequencer_error_rate,
                                param.indel_frequency)
        candidates.append((line, mb))
    if not candidates:
        raise SystemExit(
            f"Error - could not find any architectures in file: {param.arch_file}"
        )

    if len(candidates) > 1:
        with span("detect.read"):
            reader = SeqReader(path, sam_filter=param.filter)
            batch = reader.read_chunk_batch(NUM_QUERY)
            reader.close()
        count("detect.reads", batch.B)
        models = [mb for _, mb in candidates]
        with span("detect.score"):
            if kind in DEVICE_KINDS:
                bscores = _device_scores(batch, models, kind)
            else:
                bscores = _exact_scores(batch, models)
        with span("detect.pick"):
            best, best_score = _pick(bscores, param.num_threads)
        if log:
            log(pretty_print_selected_architecture(candidates[best][0]))
            log(f"{best_score:.2f} Confidence.\n")
    else:
        best = 0
        if log:
            log(pretty_print_selected_architecture(candidates[0][0]))
            log(f"Confidence: {1.0:.2f}\n")

    rs = build_read_structure(parse_arch_line(candidates[best][0]))
    qc_read_structure(rs)
    return rs
