"""runner.prepare_s_per_mread: main-thread seconds in the program's span
``runner.prepare`` (each streaming window's padded read matrix:
``padded_matrix`` or ``_subrange_matrix``, then ``CudaEngine._pad``) per
million input reads."""

from benchmark.span_readers import per_mread


def read(run):
    return per_mread(run, "runner.prepare")
