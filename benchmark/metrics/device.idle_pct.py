"""device.idle_pct: 100 x (1 - the union of the device operations'
intervals inside the window's jobs / the jobs' time), from the traced run's
``torch.profiler`` trace (``trace.summarize``)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0 or not t["device"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
