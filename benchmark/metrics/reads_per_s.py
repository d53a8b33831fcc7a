"""reads_per_s: the input reads of every job of the window over the sum of
those jobs' walls (host clock; a job's wall runs from the call into
``controller.hmm_controller_multiple`` to its return)."""


def read(run):
    jobs = run["jobs"]
    wall = sum(j["wall"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return sum(j["reads"] for j in jobs) / wall
