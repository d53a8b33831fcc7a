"""tagdust — the demultiplexer CLI of the port.

The flags of ``tagdust_tpu.cli.tagdust``, parsed by this package's copy of
``config.parse_args``; ``-engine`` takes ``auto`` (the default: the card,
and an error without one), ``cuda``, ``torch`` (the plain versions on the
CPU) and ``exact`` (the host C-parity engine).  ``-profile DIR`` writes a
``torch.profiler`` trace of the run (a Chrome trace, ``DIR/trace.json``):
the device's operations and the main thread's ``tagdust.<span>`` ranges
(``spans.py``).  The profiler records only the thread that started it, so
the parse and writer threads' spans (``io.parse``, ``io.write``) are in the
per-job record ``controller.TIMINGS`` alone.

    python -m tagdust_tpu_torch.cli.tagdust -1 B:ACAGTG,ACTTGA -2 R:N \
        in.fq -o out -engine cuda
"""

from __future__ import annotations

import os
import sys

from ..arch import qc_read_structure, read_structure_from_params
from ..config import parse_args
from ..controller import MessageLog, hmm_controller_multiple


def _profiled(param, log) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(param.profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        hmm_controller_multiple(param, log=log)
    prof.export_chrome_trace(os.path.join(param.profile_dir, "trace.json"))


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    param = parse_args(args)
    if param.show_help:
        print("Usage: tagdust [options] <file> -o <output prefix>")
        return
    if param.show_version:
        print("tagdust_tpu_torch 0.1.0")
        return

    try:
        cli_rs = read_structure_from_params(param.segments)
        if cli_rs.num_segments:
            qc_read_structure(cli_rs)
    except ValueError as e:
        # QC failures surface as clean messages, not tracebacks
        sys.stderr.write(str(e) + "\n")
        raise SystemExit(1)
    if cli_rs.num_segments == 0 and param.arch_file is None:
        sys.stdout.write("ERROR: No read architecture found.\n")
        raise SystemExit(0)
    if param.infiles == 0:
        sys.stdout.write("ERROR: No input file found.\n")
        raise SystemExit(0)
    if param.outfile is None:
        sys.stdout.write(
            "ERROR: You need to specify an output file prefix using the -o / "
            "-out option.\n"
        )
        raise SystemExit(0)
    if param.arch_file is not None and not os.path.exists(param.arch_file):
        sys.stdout.write(f"ERROR: Arch file:{param.arch_file} does not exists.\n")
        raise SystemExit(0)
    for f in param.infile:
        if not os.path.exists(f):
            sys.stdout.write(f"ERROR: Input file:{f} does not exists.\n")
            raise SystemExit(0)

    # multiread + filter disabling (interface.c:419-450)
    c = sum(1 for t in cli_rs.types if t == "R")
    if c >= 2:
        param.multiread = c
    if (param.reference_fasta or param.dust) and param.multiread:
        param.dust = 0
        param.reference_fasta = None

    log = MessageLog()
    log("Start Run\n--------------------------------------------------\n")
    if param.profile_dir:
        _profiled(param, log)
    else:
        hmm_controller_multiple(param, log=log)


if __name__ == "__main__":
    main()
