"""evalres — scores demultiplexed outputs against simreads ground truth.

Re-implements ``evalresults.c:29-312``: pass 1 counts ``BARNUM:`` labels per
output file and assigns each library to the file holding most of its reads
(ambiguity is fatal); pass 2 computes the average per-read edit error of
extracted reads vs the ``SEQ:`` truth via the bit-parallel global distance
(``bpm_check_error_global``, ``misc.c:653-704``); TP/FP/TN/FN and
Sensitivity/Specificity/Precision/Kappa go to ``<o>_results.txt``.

Reference quirks reproduced:
* metric sums iterate file index only up to ``max_num_lib_detected``
  (``evalresults.c:241-258``);
* the length comparison selecting bpm argument order indexes the read buffer
  with the *file* index (``evalresults.c:209``).
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import parse_args
from ..constants import NUC_CODE
from ..filters import bpm_check_error_global
from ..io.fastq import SeqReader


def main(argv=None) -> None:
    param = parse_args(sys.argv[1:] if argv is None else argv)
    if not param.format:
        raise SystemExit(
            "Error: You need to specify the name of program with the -name option."
        )
    param.num_query = 1000000

    nfiles = param.infiles
    counts = np.zeros((100, nfiles + 5), dtype=np.int64)
    totals = np.zeros(100, dtype=np.int64)
    max_lib = -1

    for i in range(nfiles):
        reader = SeqReader(param.infile[i])
        while True:
            chunk = reader.read_chunk(param.num_query)
            if not chunk:
                break
            for r in chunk:
                c = r.name.find("BARNUM:")
                if c >= 0:
                    v = _atoi(r.name[c + 7 :])
                    if v > max_lib:
                        max_lib = v
                    counts[v, i] += 1
                    totals[v] += 1
        reader.close()

    assignment = [-1] * (max_lib + 1)
    for i in range(max_lib + 1):
        mx = 0
        for j in range(max_lib + 1):
            if counts[i, j] > mx:
                mx = counts[i, j]
                assignment[i] = j

    if param.sim_numseq:
        j = param.sim_numseq - int(
            float(param.sim_numseq) * (1.0 - param.sim_random_frac)
        ) - 1
        if totals[0] < j:
            assignment[0] = -1

    for i in range(max_lib + 1):
        for j in range(i + 1, max_lib + 1):
            if assignment[i] == assignment[j]:
                raise SystemExit(
                    "Cannot determine which file belongs to which library...\n"
                )

    num_extracted = 0.0
    avg_error = 0.0
    for i in range(nfiles):
        used = any(assignment[j] == i for j in range(1, max_lib + 1))
        if not used:
            continue
        reader = SeqReader(param.infile[i])
        while True:
            chunk = reader.read_chunk(param.num_query)
            if not chunk:
                break
            org = np.zeros(0, dtype=np.uint8)
            for j, r in enumerate(chunk):
                c = r.name.find("SEQ:")
                if c >= 0:
                    s = []
                    for ch in r.name[c + 4 :]:
                        if ch.isspace() or ch == ";":
                            break
                        s.append(int(NUC_CODE[ord(ch)]))
                    org = np.array(s, dtype=np.uint8)
                if "READ" in r.name:
                    num_extracted += 1
                    org_len = org.shape[0]
                    # reference bug: uses chunk[file_index].len here
                    # (evalresults.c:209)
                    probe_len = chunk[i].len if i < len(chunk) else 0
                    if probe_len < org_len:
                        c2 = bpm_check_error_global(r.seq, org, r.len, org_len)
                    else:
                        c2 = bpm_check_error_global(org, r.seq, org_len, r.len)
                    g = org_len if org_len > r.len else r.len
                    avg_error += float(c2) / float(g)
        reader.close()

    TP = FP = FN = TN = 0.0
    total = 0.0
    for i in range(max_lib + 1):
        for j in range(max_lib + 1):
            total += counts[i, j]
            if i == 0:
                if assignment[i] == j:
                    TN += counts[i, j]
                else:
                    FP += counts[i, j]
            else:
                if assignment[i] == j:
                    TP += counts[i, j]
                else:
                    FP += counts[i, j]

    if param.sim_numseq:
        j = param.sim_numseq - int(
            float(param.sim_numseq) * (1.0 - param.sim_random_frac)
        )
        TN += j - totals[0]
        total += j - totals[0]
        FN += param.sim_numseq - total
        total += param.sim_numseq - total

    precision = TP / (TP + FP)
    sensitivity = TP / (TP + FN)
    specificity = TN / (TN + FP)
    P_e = ((TP + FN) / total) * ((TP + FP) / total) + (
        ((FP + TN) / total) * ((FN + TN) / total)
    )
    P_o = (TP + TN) / total
    kappa = (P_o - P_e) / (1.0 - P_e)

    with open(f"{param.outfile}_results.txt", "w") as fh:
        fh.write(
            "Program\tSensitivity\tSpecificity\tPrecision\tKappa\tAvgError\tTP\tFP\tFN\tTN\n"
        )
        fh.write(
            f"{param.format}\t{sensitivity:.4f}\t{specificity:.4f}\t"
            f"{precision:.4f}\t{kappa:.4f}\t{avg_error / num_extracted:.4f}\t"
            f"{TP:.2f}\t{FP:.2f}\t{FN:.2f}\t{TN:.2f}\n"
        )


def _atoi(s: str) -> int:
    out = []
    for ch in s:
        if ch.isdigit() or (ch == "-" and not out):
            out.append(ch)
        else:
            break
    return int("".join(out)) if out and out != ["-"] else 0


if __name__ == "__main__":
    main()
