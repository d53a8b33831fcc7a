"""The jobs' inputs: seeded reads of a configuration, written as FASTQ.

``generate`` is ``chip_smoke.py:generate_reads`` (seeded NumPy) with two
changes: every read has the configuration's fixed length, as raw Illumina
reads do, and a substituted base is always another base (so the rate is
the configuration's).  A share ``random_fraction`` of the reads is random; each other
read starts with a barcode of the configuration's list, each of its bases
substituted with probability ``barcode_substitution_rate``, then a random
insert.  The stream is seeded by ``(seed, job)``, so the same seed and job
give the same bytes and every job of a run has reads of its own.

``write_fastq`` writes fixed-width records ``@r<10-digit index>`` with a
constant quality, so that the outputs can be matched back to the reads by
name (``outputs.py``), and flushes them to the disk before it returns, so
that no write-back of a job's input is left to run while the job is timed.
"""

from __future__ import annotations

import os

import numpy as np

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
NAME_DIGITS = 10
WARMUP_JOB = -1


def rng_for(seed: int, job: int, stream: int = 0) -> np.random.Generator:
    """The generator of job ``job`` (``WARMUP_JOB`` for the warm-up) of run
    ``seed``; ``stream`` tells apart the draws of one job (0: its reads)."""
    return np.random.default_rng([seed % (1 << 64), job + 1, stream])


def job_seed(seed: int, job: int) -> int:
    """The ``-seed`` that job ``job`` of run ``seed`` passes to calibration
    where its mix asks for one a job (``seed_per_job``)."""
    return int(rng_for(seed, job, 2).integers(1, 1 << 31))


def generate(n: int, seed: int, job: int, config: dict) -> dict:
    """{"codes": [n, L] uint8 codes 0-3, "lens": [n] int32, "truth": [n]
    barcode index or -1} of job ``job``."""
    rng = rng_for(seed, job)
    L = int(config["read_length"])
    barcodes = config["barcodes"]
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    truth = rng.integers(0, len(barcodes), n)
    truth[rng.random(n) < float(config["random_fraction"])] = -1
    lut = np.zeros(256, dtype=np.uint8)
    lut[ALPHA] = np.arange(4, dtype=np.uint8)
    bc = lut[np.array([np.frombuffer(b.encode(), dtype=np.uint8) for b in barcodes])]
    has = truth >= 0
    head = bc[truth[has]]
    noise = rng.random(head.shape) < float(config["barcode_substitution_rate"])
    # a substitution is always another base
    head[noise] = (head[noise] + rng.integers(1, 4, int(noise.sum()), dtype=np.uint8)) % 4
    codes[has, : bc.shape[1]] = head
    return {"codes": codes, "lens": np.full(n, L, dtype=np.int32), "truth": truth}


def names(indices) -> list:
    """The read names ``write_fastq`` gives the reads ``indices``."""
    return [f"r{int(i):0{NAME_DIGITS}d}" for i in indices]


def write_fastq(path: str, codes: np.ndarray, block: int = 1 << 18) -> int:
    """Write reads ``codes`` [n, L] as FASTQ; returns the bytes written."""
    n, L = codes.shape
    head = 2 + NAME_DIGITS + 1  # "@r" + digits + "\n"
    width = head + L + 3 + L + 1  # seq "\n+\n" qual "\n"
    rec = np.empty((min(block, max(n, 1)), width), dtype=np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    rec[:, head - 1] = ord("\n")
    rec[:, head + L : head + L + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, head + L + 3 : head + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    pow10 = 10 ** np.arange(NAME_DIGITS - 1, -1, -1, dtype=np.int64)
    with open(path, "wb") as fh:
        for s in range(0, n, block):
            e = min(n, s + block)
            r = rec[: e - s]
            idx = np.arange(s, e, dtype=np.int64)
            r[:, 2 : 2 + NAME_DIGITS] = (idx[:, None] // pow10 % 10 + ord("0")).astype(np.uint8)
            r[:, head : head + L] = ALPHA[codes[s:e]]
            fh.write(r.tobytes())
        fh.flush()
        os.fsync(fh.fileno())
    return n * width
