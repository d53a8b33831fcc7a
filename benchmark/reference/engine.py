"""The plain reference of a whole ``tagdust`` job, in plain PyTorch and NumPy.

What the benchmark's check compares the program's outputs with.  It builds
everything again from the architecture and the generated reads: the
statistics (``stats``), the model (``model``), the lattice and its dense
step matrices (``lattice``, ``tables``), the backward and forward passes
and the traceback as dense float32 products (``scan``), Q, the extraction
(``extract``), DUST (``dust``), the writer's routing and headers
(``records``), the calibration's model, scoring and sweep (``calibrate``)
and the ``-arch`` pick (``pick_architecture``).

``Reference(device, tf32=False)`` runs the products in full float32 with
TF32 off; ``tf32=True`` is the control, the same reference one precision
step lower.  Reads are scored in blocks whose stack stays inside
``BLOCK_BYTES``, so the reference fits beside nothing else on the card.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import scan
from .arch import build_read_structure, parse_arch_line, qc_read_structure
from .batch import ReadBatch
from .calibrate import (
    NUM_TEST,
    emission_model,
    scoring_model,
    sweep_threshold,
)
from .constants import ALPHABET, EXTRACT_SUCCESS
from .dust import dust_batch_columnar
from .extract import extract_batch_columnar
from .lattice import compile_lattice
from .logsum import logsum
from .model import ModelBag, init_model_bag
from .stats import sequence_stats
from .tables import tables_from_lattice

# bytes of one block's backward stack, [Lp + 1, B, S] float32
BLOCK_BYTES = 2 << 30
# reads the controller's stats pre-pass and -arch detection read at a time
STATS_QUERY = 1000001
DETECT_QUERY = 100000
_F32 = np.float32


class Reference:
    """Scores reads under a model with the plain passes on ``device``."""

    def __init__(self, device="cpu", tf32: bool = False):
        self.device = torch.device(device)
        self.tf32 = tf32
        self._tables: Dict[int, dict] = {}

    # ---------------- model ----------------
    def tables(self, mb: ModelBag) -> dict:
        key = id(mb)
        if key not in self._tables:
            t = tables_from_lattice(mb, compile_lattice(mb))
            dev = lambda x: torch.as_tensor(np.asarray(x)).to(self.device)  # noqa: E731
            self._tables[key] = {
                "mb": mb,
                "Abwd": dev(t["Abwd"]), "Afwd": dev(t["Afwd"]), "end": dev(t["end"]),
                "Lmap": dev(t["Lmap"]), "ent_state": dev(t["ent_state"]),
                "tmat": dev(t["tmat"]), "begin": int(t["begin"]),
                "bg_log": torch.log(dev(t["bg"])), "avg_len": dev(t["avg_len"]),
                "bar_segments": [int(h) for h, _ in t["bar_segments"]],
                "S": int(t["S"]),
            }
        return self._tables[key]

    def _block(self, S: int, Lp: int) -> int:
        return max(1, min(16384, BLOCK_BYTES // ((Lp + 1) * S * 4)))

    def _upload(self, codes: np.ndarray, lens: np.ndarray):
        return (torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32)).to(self.device))

    # ---------------- scoring ----------------
    def score(self, mb: ModelBag, codes: np.ndarray, lens: np.ndarray,
              want_labels: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """(labels [B, Lp + 1] int32 or None, Q [B] float32) of reads
        ``codes`` [B, Lp]."""
        t = self.tables(mb)
        B, Lp = codes.shape
        step = self._block(t["S"], Lp)
        labels = np.zeros((B, Lp + 1), dtype=np.int32) if want_labels else None
        q = np.zeros(B, dtype=np.float32)
        with scan.precision(self.tf32):
            for s in range(0, B, step):
                sq, ln = self._upload(codes[s : s + step], lens[s : s + step])
                bstack, blstack, logpb = scan.backward_pass(
                    sq, ln, t["Abwd"], t["end"], t["begin"])
                path, dpfin, f_log, tp = scan.forward_decode(
                    sq, ln, t["Afwd"], t["end"], t["Lmap"], t["ent_state"],
                    t["tmat"], t["begin"], bstack, blstack, logpb)
                del bstack, blstack
                r_log = scan.random_log(sq, ln, t["bg_log"], t["avg_len"])
                bar = scan.bar_log(tp, t["bar_segments"])
                q[s : s + step] = scan.q_from_scores(f_log, r_log, bar).cpu().numpy()
                if want_labels:
                    labels[s : s + step] = scan.traceback(path, dpfin).cpu().numpy()
                del path
        return labels, q

    def backward_logp(self, mb: ModelBag, codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """[B] backward-only log P(x|M), as ``-arch`` detection scores."""
        t = self.tables(mb)
        B, Lp = codes.shape
        step = self._block(t["S"], Lp) * 4
        out = np.zeros(B, dtype=np.float32)
        with scan.precision(self.tf32):
            for s in range(0, B, step):
                sq, ln = self._upload(codes[s : s + step], lens[s : s + step])
                out[s : s + step] = scan.backward_scores(
                    sq, ln, t["Abwd"], t["end"], t["begin"]).cpu().numpy()
        return out

    def q_of_reads(self, mb: ModelBag, flat: np.ndarray, off: np.ndarray) -> np.ndarray:
        """Q of reads of any lengths, read ``i`` being ``flat[off[i]:off[i + 1]]``:
        scored in blocks of similar length."""
        n = off.shape[0] - 1
        lens = np.diff(off).astype(np.int32)
        order = np.argsort(lens, kind="stable")
        q = np.zeros(n, dtype=np.float32)
        S = self.tables(mb)["S"]
        s = 0
        while s < n:
            Lp = int(lens[order[min(s + 4095, n - 1)]])
            e = min(n, s + self._block(S, Lp))
            idx = order[s:e]
            Lp = max(int(lens[idx].max()), 1)
            pos = np.arange(Lp)[None, :]
            valid = pos < lens[idx][:, None]
            codes = np.where(valid, flat[np.minimum(off[idx][:, None] + pos, flat.shape[0] - 1)],
                             0).astype(np.uint8)
            q[idx] = self.score(mb, codes, lens[idx], want_labels=False)[1]
            s = e
        return q


def job_model(rs, codes: np.ndarray, lens: np.ndarray, error_rate: float,
              indel: float):
    """(stats, model) of a job without calibration: the controller's stats
    pre-pass over the file, then the model."""
    ssi = sequence_stats(codes, lens, STATS_QUERY)
    return ssi, init_model_bag(rs, ssi, error_rate, indel)


def calibrate(ref: Reference, rs, ssi, indel: float, flat: np.ndarray, off: np.ndarray,
              n_model: int):
    """(threshold, the stats as calibration leaves them, the emission
    model): the emitted reads (``flat``, ``off``: read ``i`` is
    ``flat[off[i]:off[i + 1]]``) scored under the scoring model, then
    swept.  ``ssi`` is not changed."""
    ssi = copy.deepcopy(ssi)
    emit_mb = emission_model(rs, ssi, indel)
    max_emitted = int(np.diff(off).max(initial=0))
    mb = scoring_model(rs, ssi, indel, max_emitted)
    q = ref.q_of_reads(mb, flat, off)
    return sweep_threshold(q, n_model), ssi, emit_mb


def pick_architecture(ref: Reference, lines: List[str], codes: np.ndarray,
                      lens: np.ndarray, error_rate: float, indel: float,
                      num_threads: int = 8) -> int:
    """Index of the candidate ``-arch`` detection picks: each candidate's
    model from the stats of its pre-pass, the backward scores of the first
    100,000 reads, float32 sums in thread order and the two normalisations
    (``detect.py:_pick``; barcode_hmm.c:2126-2144, test_architectures.c:191-206)."""
    ssi = sequence_stats(codes, lens, DETECT_QUERY)
    n = min(DETECT_QUERY, codes.shape[0])
    scores = []
    for line in lines:
        rs = build_read_structure(parse_arch_line(line))
        qc_read_structure(rs)
        mb = init_model_bag(rs, copy.deepcopy(ssi), error_rate, indel)
        scores.append(ref.backward_logp(mb, codes[:n], lens[:n]))
    bscores = np.stack(scores).astype(np.float32)
    n_arch, numseq = bscores.shape
    interval = int(float(numseq) / float(num_threads))
    slices = [(t * interval, t * interval + interval) for t in range(num_threads)]
    slices[-1] = (slices[-1][0], numseq)
    posterior = np.zeros(n_arch, dtype=np.float32)
    for s, e in slices:
        part = np.zeros(n_arch, dtype=np.float32)
        for i in range(s, e):
            part = (part + bscores[:, i]).astype(np.float32)
        posterior = (posterior + part).astype(np.float32)

    def logsum_all(x):
        sm = x[0]
        for v in x[1:]:
            sm = logsum(sm, v)
        return sm

    posterior = (posterior - logsum_all(posterior)).astype(np.float32)
    sm = logsum_all(posterior)
    best, best_score = -1, _F32(-1.0)
    for i in range(n_arch):
        with np.errstate(over="ignore"):
            p = _F32(np.exp(np.float64(_F32(posterior[i] - sm))))
        if p > best_score:
            best, best_score = i, p
    return best


def records(mb: ModelBag, rs, names: List[str], codes: np.ndarray, lens: np.ndarray,
            labels: np.ndarray, q: np.ndarray, threshold: float, minlen: int,
            dust_cut: int) -> List[List[Tuple[str, bytes, bytes]]]:
    """What the writer writes for each read: a list of (file, header line,
    sequence line), one per run of extracted bases; ``file`` is
    ``BC_<barcode>`` or ``un``."""
    B, L = codes.shape
    rb = ReadBatch()
    name_b = [n.encode() for n in names]
    rb.name_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(n) for n in name_b], out=rb.name_off[1:])
    rb.name_arena = np.frombuffer(b"".join(name_b), dtype=np.uint8).copy()
    valid = np.arange(L)[None, :] < lens[:, None]
    rb.seq_arena = np.ascontiguousarray(codes[valid]).astype(np.uint8)
    rb.seq_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(lens, out=rb.seq_off[1:])
    rb.qual_arena = np.full(rb.seq_arena.shape[0], ord("I"), dtype=np.uint8)
    rb.qual_off = rb.seq_off[:-1].copy()
    rb.qual_len = lens.astype(np.int64)
    rb.init_results()
    rb.mapq[:] = q.astype(np.float64)
    extract_batch_columnar(mb, rs, rb, labels, minlen, threshold, -1, -1)
    if dust_cut:
        dust_batch_columnar(rb, dust_cut)
    barseg = rs.barcode_segment()
    bars = rs.seqs[barseg] if barseg != -1 else []
    n_alt = rs.numseq_in_segment(barseg) if barseg != -1 else 2
    out = []
    for i in range(B):
        ok = rb.read_type[i] == EXTRACT_SUCCESS
        f = (int(rb.barcode[i]) & 0xFF if rb.barcode[i] != -1 else 0) if ok else n_alt - 1
        fp = rb.fp_value(i)
        head = (f"@{names[i]};FP:{fp};RQ:{rb.mapq[i]:.2f}" if fp != -1
                else f"@{names[i]};RQ:{rb.mapq[i]:.2f}").encode()
        seq = rb.seq(i)
        runs, start = [], None
        for j in range(seq.shape[0] + 1):
            inside = j < seq.shape[0] and seq[j] < 5
            if inside and start is None:
                start = j
            elif not inside and start is not None:
                runs.append(seq[start:j])
                start = None
        recs = []
        for k, run in enumerate(runs):
            fk = f + k * n_alt
            label = (f"BC_{bars[fk % n_alt]}" if barseg != -1 and fk % n_alt < n_alt - 1
                     else "un")
            if k:
                label += f"_run{k}"
            recs.append((label, head, "".join(ALPHABET[c] for c in run).encode()))
        out.append(recs)
    return out


__all__ = ["Reference", "job_model", "calibrate", "pick_architecture", "records",
           "NUM_TEST"]
