"""runner.label_s_per_mread: seconds inside
``controller.run_get_label_batch`` (the runner's streaming labelling and
extraction, with the engine and kernels under it), per million input
reads, from the benchmark's span around the call."""


def read(run):
    reads = sum(j["reads"] for j in run["jobs"])
    secs = sum(j["spans"].get("label", 0.0) for j in run["jobs"])
    return secs / reads * 1e6 if reads and secs else None
