"""io.reader_wait_s_per_mread: main-thread seconds in the program's span
``io.reader_wait`` (the controller waiting on the reader thread's queue for
the next chunk, the first chunk included) per million input reads."""

from benchmark.span_readers import per_mread


def read(run):
    return per_mread(run, "io.reader_wait")
