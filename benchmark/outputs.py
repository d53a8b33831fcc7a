"""Read back what a job wrote for a sample of its reads.

A job with output prefix ``<dir>/out`` writes ``out_BC_<barcode>.fq`` and
``out_un.fq``.  ``collect`` finds, in every such file, the records whose
name is one of the sampled read indices (``traffic.write_fastq`` names read
``i`` ``r<i, 10 digits>``) and returns for each of those reads the list of
(file, header line, sequence line) it was written as, in file order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .traffic import NAME_DIGITS

PREFIX = "out"


def output_files(outdir: str) -> List[str]:
    return sorted(f for f in os.listdir(outdir)
                  if f.startswith(PREFIX + "_") and f.endswith(".fq"))


def collect(outdir: str, wanted: np.ndarray) -> Dict[int, List[Tuple[str, bytes, bytes]]]:
    """{read index: [(file, header, sequence), ...]} for the read indices
    ``wanted`` (missing reads have no key)."""
    pow10 = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    out: Dict[int, List[Tuple[str, bytes, bytes]]] = {}
    for fname in output_files(outdir):
        label = fname[len(PREFIX) + 1 : -3]
        with open(os.path.join(outdir, fname), "rb") as fh:
            data = fh.read()
        if not data:
            continue
        buf = np.frombuffer(data, dtype=np.uint8)
        nl = np.flatnonzero(buf == 10)
        if nl.shape[0] % 4:
            raise ValueError(f"{fname}: {nl.shape[0]} lines, not whole records")
        starts = np.concatenate([[0], nl[3::4][:-1] + 1])
        if starts.size and not (buf[starts] == ord("@")).all():
            raise ValueError(f"{fname}: a record does not start with '@'")
        digits = buf[np.minimum(starts[:, None] + 2 + np.arange(NAME_DIGITS),
                                buf.shape[0] - 1)].astype(np.int64) - ord("0")
        idx = digits @ pow10
        for k in np.flatnonzero(np.isin(idx, wanted)):
            h0, h1 = int(starts[k]), int(nl[4 * k])
            s1 = int(nl[4 * k + 1])
            out.setdefault(int(idx[k]), []).append(
                (label, data[h0:h1], data[h1 + 1 : s1]))
    return out
