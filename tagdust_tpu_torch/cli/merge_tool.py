"""merge — paired-end read merger.

Re-implements the reference merge tool (``merge.c:45-688``): for each read
pair, reverse-complement read 2 (quality string reversed), build per-base
probability profiles from the quality values, score every overlap offset of
the two profiles by the summed log inner products, pick the best offset, and
emit a consensus where disagreements take the base with the higher profile
probability and qualities take the per-position maximum; pairs whose overlap
identity falls below the ``-Q`` threshold emit nothing.

Quirk preserved: consensus bases use the lookup "ACGTC" — an N (code 4)
prints as 'C' (``merge.c:572``).
"""

from __future__ import annotations

import functools
import math
import sys

import numpy as np

from ..config import parse_args
from ..io.fastq import SeqReader
from ..namecheck import compare_read_names

_OUT_ALPHA = "ACGTC"  # sic (merge.c:572)

# per-qual-byte probability, scalar libm pow for bit-parity with the
# per-base loop it replaces
_SCORE_LUT = np.array(
    [1.0 - 10.0 ** (-(qv - 33) / 10.0) for qv in range(256)], dtype=np.float64
)

_OUT_LUT = np.full(256, ord("N"), dtype=np.uint8)
for _i, _ch in enumerate(_OUT_ALPHA):
    _OUT_LUT[_i] = ord(_ch)

@functools.lru_cache(maxsize=8)
def _diag_index(F: int, R: int):
    """Flattened diagonal-id matrix for [F, R]: k = (j - i) + F - 1.

    Bounded cache: variable-length pairs (quality-trimmed input) would
    otherwise accumulate one F*R int64 array per distinct length pair."""
    i = np.arange(F)[:, None]
    j = np.arange(R)[None, :]
    return (((j - i) + F - 1).ravel(), F + R - 1)


def _profiles(seq: np.ndarray, qual: str) -> np.ndarray:
    n = seq.shape[0]
    if n == 0:
        return np.empty((0, 4), dtype=np.float64)
    q = np.frombuffer(qual.encode("latin-1"), dtype=np.uint8)
    score = _SCORE_LUT[q]
    p = np.broadcast_to(((1.0 - score) / 3.0)[:, None], (n, 4)).copy()
    known = seq <= 3
    rows = np.nonzero(known)[0]
    p[rows, seq[known].astype(np.int64)] = score[known]
    p[~known] = 0.25
    return p


def overlap_reads(fseq, fqual, rseq, rqual, min_overlap: int, threshold: float):
    """merge.c:399-688. Returns (consensus, qual) or (None, None)."""
    pa = _profiles(fseq, fqual)
    pb = _profiles(rseq, rqual)
    len_f = fseq.shape[0]
    len_r = rseq.shape[0]

    # every overlap score is a diagonal sum of log(pa @ pb.T): one matmul +
    # one bincount over diagonal indices replaces the per-offset inner loops
    # of merge.c:478-558 (identical float64 values and tie order, asserted
    # byte-identical against the scalar loops)
    best_d = -1
    if len_f and len_r:
        LD = np.log(pa @ pb.T)  # [len_f, len_r]
        diag_idx, nset = _diag_index(len_f, len_r)
        diag_sums = np.bincount(diag_idx, weights=LD.ravel(), minlength=nset)
        # offset d in [0, len_f): diagonal -d; d in [len_f, len_f+len_r):
        # diagonal d-len_f.  Invalid offsets (overlap <= min_overlap) -> -inf
        scores = np.full(len_f + len_r, -math.inf)
        if len_r > min_overlap:
            ii = np.arange(len_f)
            ok = (len_f - ii) > min_overlap
            scores[ii[ok]] = diag_sums[(len_f - 1) - ii[ok]]
        if len_f > min_overlap:
            jj = np.arange(len_r)
            ok = (len_r - jj) > min_overlap
            scores[len_f + jj[ok]] = diag_sums[(len_f - 1) + jj[ok]]
        d = int(np.argmax(scores))
        if scores[d] != -math.inf:
            best_d = d

    if best_d < 0:
        return None, None

    # consensus: slices + vector ops; only mismatch positions fall back to
    # the scalar max-profile pick (interleaved pa/pb tie order preserved)
    if best_d < len_f:
        li0, lj0 = best_d, 0
    else:
        li0, lj0 = 0, best_d - len_f
    n_ov = min(len_f - li0, len_r - lj0)
    fq = np.frombuffer(fqual.encode("latin-1"), dtype=np.uint8)
    rq = np.frombuffer(rqual.encode("latin-1"), dtype=np.uint8)

    fs = fseq[li0 : li0 + n_ov]
    rs2 = rseq[lj0 : lj0 + n_ov]
    eq = fs == rs2
    ident = float(eq.sum())
    aligned = float(n_ov)
    cons = np.where(eq, fs, 0).astype(np.uint8)
    for k in np.nonzero(~eq)[0]:
        mx = -math.inf
        nuc = 0
        i, j = li0 + int(k), lj0 + int(k)
        for c in range(4):
            if pa[i, c] > mx:
                mx = pa[i, c]
                nuc = c
            if pb[j, c] > mx:
                mx = pb[j, c]
                nuc = c
        cons[k] = nuc
    if aligned <= 0 or ident / aligned < threshold:
        return None, None

    seq_parts = []
    qual_parts = []
    if best_d < len_f:
        seq_parts.append(fseq[:li0])
        qual_parts.append(fq[:li0])
    else:
        seq_parts.append(rseq[:lj0])
        qual_parts.append(rq[:lj0])
    seq_parts.append(cons)
    qual_parts.append(np.maximum(fq[li0 : li0 + n_ov], rq[lj0 : lj0 + n_ov]))
    seq_parts.append(fseq[li0 + n_ov :])
    qual_parts.append(fq[li0 + n_ov :])
    seq_parts.append(rseq[lj0 + n_ov :])
    qual_parts.append(rq[lj0 + n_ov :])
    codes = np.concatenate(seq_parts)
    out = _OUT_LUT[codes].tobytes().decode("latin-1")
    oq = np.concatenate(qual_parts).tobytes().decode("latin-1")
    return out, oq


def main(argv=None) -> None:
    param = parse_args(sys.argv[1:] if argv is None else argv)
    if param.infiles < 2:
        raise SystemExit("Usage: merge <read1> <read2>")
    param.num_query = 1000 if param.rtest else 1000000

    from ..constants import REV_NUC_CODE, SPACER

    readers = [SeqReader(p) for p in param.infile]
    total = 0
    out = sys.stdout
    while True:
        chunks = [r.read_chunk(param.num_query) for r in readers]
        if sum(len(c) for c in chunks) == 0:
            break
        if len(chunks[0]) != len(chunks[1]):
            raise SystemExit("Input files differ in number of entries.")
        if total == 0:
            for c in range(min(1000, len(chunks[0]))):
                if compare_read_names(chunks[0][c].name, chunks[1][c].name):
                    raise SystemExit(
                        "Files seem to contain reads in different order"
                    )
        for r1, r2 in zip(chunks[0], chunks[1]):
            rc = np.empty_like(r2.seq)
            n = r2.seq.shape[0]
            for i in range(n):
                v = r2.seq[n - 1 - i]
                rc[i] = SPACER if v == SPACER else REV_NUC_CODE[int(v)]
            rq = r2.qual[::-1] if r2.qual else ""
            cons, cq = overlap_reads(
                r1.seq, r1.qual or "", rc, rq, param.minlen,
                param.confidence_threshold,
            )
            if cons:
                out.write(f"@{r1.name}\n{cons}\n+\n{cq}\n")
        total += len(chunks[0])
    for r in readers:
        r.close()


if __name__ == "__main__":
    main()
