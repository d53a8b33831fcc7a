"""Whether what the timed jobs produced is correct: the program's outputs
against the plain reference (``reference/``), number by number.

For each job of the window the reference works out again, from the
configuration and the job's generated reads: the architecture ``-arch``
detection picks (``arch_fixedq``), the statistics, the threshold
calibration picks (``calibrated``; from the reads calibration emitted, whose
first ``EMIT_CHECKED`` the reference emits itself from the job's seed), the
model, and for the job's sampled reads what the writer writes: the file,
the sequence and the header.  The numbers compared, each with the limit of
the cell's ``limits/<cell>.json``:

* ``reads_apart_pct``: % of the compared reads written otherwise than the
  reference writes them, in any byte: another file, sequence, name, ``RQ``
  (printed to 0.01) or record count, or not at all;
* ``emitted_apart``: jobs whose first emitted reads differ from the
  reference's (calibrated cells);
* ``arch_apart``: jobs whose detected architecture differs (``-arch``
  cells);
* ``jobs_unchecked``: jobs that failed or left no outputs to compare.

Where the mix sets ``check_jobs``, the reference judges that many of the
window's jobs, drawn from the seed, so that it takes less time than the
window; every job still counts in ``jobs_unchecked``.
"""

from __future__ import annotations

import re
import sys
import time

import numpy as np

from . import roofline, traffic
from .reference import engine as R
from .reference.arch import build_read_structure, parse_arch_line, qc_read_structure
from .reference.calibrate import NUM_TEST, emit_first_reads
from .reference.model import init_model_bag

# TagDust2's defaults that the mixes leave as they are (interface.c:87-94):
# -e, -i, -minlen, -dust
ERROR_RATE = float(np.float32(0.05))
INDEL = float(np.float32(0.1))
MINLEN = 16
DUST = 100
EMIT_CHECKED = 16
_RQ = re.compile(rb";RQ:([^;\s]+)$")


def architecture(config: dict):
    rs = build_read_structure(config["architecture"])
    qc_read_structure(rs)
    return rs


def candidate_lines(path: str) -> list:
    with open(path) as fh:
        return [line for line in fh if "tagdust" in line and parse_arch_line(line)]


def _split_rq(header: bytes):
    m = _RQ.search(header)
    if not m:
        return header, None
    return header[: m.start()], float(m.group(1))


def compare_reads(expected: dict, got: dict, sample: np.ndarray) -> dict:
    """{"apart", "routed_apart", "compared", "rq_gap"} of the program's
    records ``got`` against the reference's ``expected`` ({read index:
    records}) over the sampled reads: reads written otherwise in any byte;
    of those, reads written otherwise in more than ``RQ``; and the largest
    ``RQ`` gap of reads written alike but for it."""
    apart = routed = 0
    gap = 0.0
    for idx in sample:
        exp = expected.get(int(idx), [])
        rec = got.get(int(idx), [])
        if exp == rec:
            continue
        apart += 1
        if len(exp) != len(rec):
            routed += 1
            continue
        for (ef, eh, es), (gf, gh, gs) in zip(exp, rec):
            eh0, erq = _split_rq(eh)
            gh0, grq = _split_rq(gh)
            if ef != gf or es != gs or eh0 != gh0 or erq is None or grq is None:
                routed += 1
                break
            gap = max(gap, abs(erq - grq))
    return {"apart": apart, "routed_apart": routed, "compared": len(sample), "rq_gap": gap}


def reference_job(ref, config: dict, mix: dict, job: dict, seed: int) -> dict:
    """What the reference makes of one job: {"records" (of the sampled
    reads), "arch", "threshold", "emitted_ok", "work" (the DP work of its
    streamed reads, or None)}."""
    n = job["n"]
    data = traffic.generate(n, seed, job["index"], config)
    codes, lens = data["codes"], data["lens"]
    out = {"arch": None, "threshold": None, "emitted_ok": None, "work": None}
    if mix.get("arch"):
        lines = candidate_lines(config["candidates"])
        best = R.pick_architecture(ref, lines, codes, lens, ERROR_RATE, INDEL)
        rs = build_read_structure(parse_arch_line(lines[best]))
        qc_read_structure(rs)
        out["arch"] = (list(rs.types), [list(s) for s in rs.seqs])
    else:
        rs = architecture(config)
    ssi = R.sequence_stats(codes, lens, R.STATS_QUERY)
    threshold = 0.0
    if mix.get("calibrate"):
        flat, off = job["emitted"] or (np.zeros(0, np.uint8), np.zeros(1, np.int64))
        avg_len = ssi.average_length
        threshold, ssi, emit_mb = R.calibrate(ref, rs, ssi, INDEL, flat, off, NUM_TEST // 2)
        first = emit_first_reads(emit_mb, traffic.job_seed(seed, job["index"]), avg_len,
                                 EMIT_CHECKED)
        out["emitted_ok"] = (off.shape[0] - 1 == NUM_TEST and all(
            np.array_equal(a, flat[off[i]:off[i + 1]]) for i, a in enumerate(first)))
        out["threshold"] = threshold
    mb = init_model_bag(rs, ssi, ERROR_RATE, INDEL)
    sample = job["sample"]
    labels, q = ref.score(mb, codes[sample], lens[sample])
    recs = R.records(mb, rs, traffic.names(sample), codes[sample], lens[sample],
                     labels, q, threshold, MINLEN, DUST)
    out["records"] = {int(i): r for i, r in zip(sample, recs) if r}
    if not mix.get("calibrate"):
        out["work"] = _work(ref, mb, codes)
    return out


def _work(ref, mb, codes: np.ndarray) -> dict:
    counts = np.bincount(codes.ravel(), minlength=5)[:5]
    return roofline.dp_work(ref.tables(mb), counts, codes.shape[0], codes.shape[1])


def job_work(ref, config: dict, mix: dict, job: dict, seed: int):
    """The DP work of a job's streamed reads under the configuration's own
    architecture, for a job the reference does not judge (None where the
    job calibrates: its calibration's scoring is not counted)."""
    if mix.get("calibrate"):
        return None
    data = traffic.generate(job["n"], seed, job["index"], config)
    rs = architecture(config)
    _, mb = R.job_model(rs, data["codes"], data["lens"], ERROR_RATE, INDEL)
    return _work(ref, mb, data["codes"])


def check(jobs: list, config: dict, mix: dict, seed: int, device) -> tuple:
    """(numbers, work, info) of the window's ``jobs`` against the reference
    (full float32 on ``device``); ``info`` holds what is printed and not
    compared: the reads compared, those apart in more than ``RQ``, the
    largest ``RQ`` gap, and in calibrated cells the largest gap between a
    job's threshold and the reference's.  That gap swings from seed to seed
    by its nature (the sweep's maximum is flat: a change of Q in the fifth
    digit moves it to another read), and the control does not part from
    it; what the threshold does to the reads is in ``reads_apart_pct``."""
    ref = R.Reference(device)
    nums = {"reads_apart_pct": 0.0, "jobs_unchecked": 0}
    info = {"compared_reads": 0, "routed_apart": 0, "rq_gap": 0.0}
    if mix.get("arch"):
        nums["arch_apart"] = 0
    if mix.get("calibrate"):
        nums["emitted_apart"] = 0
        info["threshold_gap"] = 0.0
    apart = compared = 0
    work = {"ops": 0.0, "bytes": 0.0}
    judged = range(len(jobs))
    if mix.get("check_jobs") and mix["check_jobs"] < len(jobs):
        rng = traffic.rng_for(seed, 0, 3)
        judged = sorted(rng.choice(len(jobs), mix["check_jobs"], replace=False))
    for k, job in enumerate(jobs):
        if job.get("error") or job.get("got") is None:
            nums["jobs_unchecked"] += 1
            work = None
            continue
        if k not in judged:
            w = job_work(ref, config, mix, job, seed)
            work = None if work is None or w is None else {x: work[x] + w[x] for x in work}
            continue
        t0 = time.perf_counter()
        r = reference_job(ref, config, mix, job, seed)
        sys.stderr.write(f"reference: job {job['index']} in {time.perf_counter() - t0:.1f} s\n")
        if mix.get("arch"):
            nums["arch_apart"] += int(job["arch"] != r["arch"])
        if mix.get("calibrate"):
            nums["emitted_apart"] += int(not r["emitted_ok"])
            gap = (abs(r["threshold"] - job["threshold"]) if job["threshold"] is not None
                   else float("inf"))
            info["threshold_gap"] = max(info["threshold_gap"], gap)
        c = compare_reads(r["records"], job["got"], job["sample"])
        apart += c["apart"]
        compared += c["compared"]
        info["routed_apart"] += c["routed_apart"]
        info["rq_gap"] = max(info["rq_gap"], c["rq_gap"])
        work = (None if work is None or r["work"] is None
                else {k: work[k] + r["work"][k] for k in work})
    nums["reads_apart_pct"] = 100.0 * apart / max(compared, 1)
    info["compared_reads"] = compared
    return nums, work, info


def within(nums: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number that has a limit; a
    number without one, or a limit without its number, raises."""
    names = set(nums)
    if names != set(limits):
        raise ValueError(f"numbers {sorted(names)} against limits {sorted(limits)}")
    return {k: {"value": nums[k], "limit": limits[k]} for k in sorted(limits)}
