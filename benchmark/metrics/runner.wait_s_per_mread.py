"""runner.wait_s_per_mread: main-thread seconds in the program's span
``runner.wait`` (the wait on a window's copy events before its extraction:
the host waiting on the card) per million input reads."""

from benchmark.span_readers import per_mread


def read(run):
    return per_mread(run, "runner.wait")
