"""io.writer_wait_s_per_mread: main-thread seconds in the program's span
``io.writer_wait`` (the controller waiting to hand a chunk to the writer
thread's queue, then at the end of the job on the writer's drain and the
output files' close) per million input reads."""

from benchmark.span_readers import per_mread


def read(run):
    return per_mread(run, "io.writer_wait")
