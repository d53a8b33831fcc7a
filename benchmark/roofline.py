"""The least time the card could take for the fused DP's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.

The work of scoring reads under a model (``dp_work``) is counted from the
reads and the model's own step matrices, whatever implements it:
operations per (read, position) under its base c are those of
``chip_smoke.py:bound``, K1's ``2 nnz(A[c]) + 2 S`` and K2's
``2 nnz(Af[c]) + 4 S + 3 K + 2 nnz(tmat) + 2 H``; bytes are the reads and
their lengths in, the tables, and per read its four scores and a label a
position out.  The stack and the path are intermediates of one design and
are not counted, so a later design that keeps them on chip is held to the
same least time.
"""

from __future__ import annotations

import numpy as np

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def dp_work(tables: dict, base_counts: np.ndarray, n_reads: int, read_len: int) -> dict:
    """{"ops", "bytes"} of scoring ``n_reads`` reads of ``read_len`` whose
    positions hold ``base_counts[c]`` bases of code c, under the model of
    ``tables`` (the reference's ``Reference.tables``)."""
    S = int(tables["S"])
    Abwd = tables["Abwd"].cpu().numpy().reshape(5, S, S)
    Afwd = tables["Afwd"].cpu().numpy()
    K = Afwd.shape[1] - S
    Af = Afwd.reshape(5, S, S + K)
    tmat = tables["tmat"].cpu().numpy()
    H = tmat.shape[0]
    nnz_b = np.count_nonzero(Abwd.reshape(5, -1), axis=1).astype(np.float64)
    nnz_f = np.count_nonzero(Af.reshape(5, -1), axis=1).astype(np.float64)
    nnz_t = float(np.count_nonzero(tmat))
    steps = np.asarray(base_counts, dtype=np.float64)[:5]
    n_steps = float(steps.sum())
    ops = (2 * (steps @ nnz_b) + 2 * S * n_steps
           + 2 * (steps @ nnz_f) + (4 * S + 3 * K + 2 * nnz_t + 2 * H) * n_steps)
    table_bytes = 8 * (nnz_b.sum() + nnz_f.sum()) + 4 * 5 * (2 * S + K + 2) + 12 * nnz_t
    io_bytes = n_reads * (read_len + 4) + n_reads * (16 + read_len + 1)
    return {"ops": float(ops), "bytes": float(table_bytes + io_bytes)}


def least_seconds(work: dict) -> float:
    return max(work["ops"] / F32_FLOPS, work["bytes"] / HBM_BYTES_PER_S)
