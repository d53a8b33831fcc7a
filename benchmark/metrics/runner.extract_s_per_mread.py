"""runner.extract_s_per_mread: main-thread seconds in the program's span
``runner.extract`` (a window's host extraction: ``collect_decided`` and
``apply_device_decisions``, or ``collect_packed`` and
``extract_batch_columnar``, and the device DUST copy) per million input
reads."""

from benchmark.span_readers import per_mread


def read(run):
    return per_mread(run, "runner.extract")
