"""controller.detection_s: the mean per job of
``controller.TIMINGS["detection"]``, ``-arch`` detection (its candidates'
stats pre-passes and backward scores on the card, K4); nothing where no
job detected."""


def read(run):
    vals = [j["timings"].get("detection", 0.0) for j in run["jobs"]]
    if not vals or not any(vals):
        return None
    return sum(vals) / len(vals)
