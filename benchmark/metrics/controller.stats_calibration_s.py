"""controller.stats_calibration_s: the mean per job of
``controller.TIMINGS["calibration"]``, the stats pre-pass plus threshold
calibration (with ``-Q``, the pre-pass alone)."""


def read(run):
    vals = [j["timings"]["calibration"] for j in run["jobs"]
            if j["timings"].get("calibration") is not None]
    return sum(vals) / len(vals) if vals else None
