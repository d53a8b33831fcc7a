"""io.parse_s_per_mread: reader-thread seconds in the program's span
``io.parse`` (``SeqReader.read_chunk_batch`` of each chunk) per million input
reads."""

from benchmark.span_readers import per_mread


def read(run):
    return per_mread(run, "io.parse")
