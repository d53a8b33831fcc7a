"""Readers of the program's own spans: ``tagdust_tpu_torch/spans.py`` keeps
each span's seconds under its name in ``controller.TIMINGS``, which
``program.Program.job`` copies into each job's ``timings``.  A run whose
program has no such span (an older commit) reads None, never 0."""


def _present(run, keys) -> bool:
    return any(k in j["timings"] for j in run["jobs"] for k in keys)


def per_mread(run, *keys):
    """The seconds of ``keys`` summed over the jobs, per million input
    reads."""
    reads = sum(j["reads"] for j in run["jobs"])
    if not reads or not _present(run, keys):
        return None
    secs = sum(j["timings"].get(k, 0.0) for j in run["jobs"] for k in keys)
    return secs / reads * 1e6


def mean_a_job(run, key):
    """The seconds of ``key`` a job, a job without it counting 0."""
    jobs = run["jobs"]
    if not jobs or not _present(run, (key,)):
        return None
    return sum(j["timings"].get(key, 0.0) for j in jobs) / len(jobs)
