"""io.write_s_per_mread: writer-thread seconds inside
``DemuxWriter.write_batch_columnar`` per million input reads, from the
benchmark's span around the call."""


def read(run):
    reads = sum(j["reads"] for j in run["jobs"])
    secs = sum(j["spans"].get("write", 0.0) for j in run["jobs"])
    return secs / reads * 1e6 if reads and secs else None
