"""runner.enqueue_s_per_mread: main-thread seconds in the program's spans
``runner.dispatch`` (a window's upload, nibble pack and kernel launches:
``dispatch_decided`` / ``dispatch_packed``) and ``runner.fetch`` (the pinned
buffer, the device-to-host copy and its events enqueued) per million input
reads: the host's time to put a window's work on the card."""

from benchmark.span_readers import per_mread


def read(run):
    return per_mread(run, "runner.dispatch", "runner.fetch")
