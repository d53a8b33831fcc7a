"""Multi-file demultiplexing orchestrator of the port.

``tagdust_tpu/controller.py:hmm_controller_multiple`` over this package's
own modules, with its engine seam pointed at this package's runner.  The orchestration is the same (per-file
architecture resolution, the barcode-in-one-file check, output-overwrite
refusal, stats + threshold calibration + model build, the pipelined chunk
loop with cross-file checks, outcome merging, writing and the end-of-run
summary), with three changes:

1. ``param.engine`` is resolved to a concrete kind first, and ``-arch``
   detection runs the port's ``detect.test_architectures``, which scores
   the candidates on that engine (K4 on the card for ``-engine cuda``);
2. ``-multihost`` raises ``NotImplementedError`` (not ported yet);
3. the artifact filter (``-ref``) runs Myers' edit distance on the run's
   engine: the ``td_myers`` kernel on the card for ``-engine cuda``, its
   plain version on CPU tensors for ``-engine torch``, the host lanes for
   ``-engine exact`` (``engine/myers.py``, ``filters._reference_hits``).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from .arch import (
    ReadStructure,
    build_read_structure,
    qc_read_structure,
    read_structure_from_params,
)
from .calibrate import estimate_q_threshold
from .constants import (
    EXTRACT_FAIL_AMBIGIOUS_BARCODE,
    EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
    EXTRACT_FAIL_BAR_FINGER_NOT_FOUND,
    EXTRACT_FAIL_LOW_COMPLEXITY,
    EXTRACT_FAIL_MATCHES_ARTIFACTS,
    EXTRACT_FAIL_READ_TOO_SHORT,
    EXTRACT_SUCCESS,
)
from .io.fastq import SeqReader, read_fasta_contaminants
from .io.writer import DemuxWriter, existing_output_files
from .model import init_model_bag
from .namecheck import compare_read_names
from .stats import get_sequence_stats
from .detect import test_architectures
from .engine.runner import (
    resolve_engine,
    run_get_label_batch,
    run_get_prob,
    run_rna_dust_batch,
)


class MessageLog:
    """append_message (misc.c:285-335): timestamped lines, echoed to stderr,
    flushed to <out>_logfile.txt at teardown (interface.c:709-726)."""

    def __init__(self):
        self.messages: List[str] = []

    def __call__(self, msg: str) -> None:
        stamp = time.strftime("[%Y-%m-%d %H:%M:%S]\t")
        sys.stderr.write(stamp + msg)
        self.messages.append(stamp + msg)

    def flush(self, outfile: Optional[str]) -> None:
        if outfile:
            with open(f"{outfile}_logfile.txt", "w") as fh:
                fh.write("".join(self.messages) + "\n")


# wall seconds of the last run's -arch detection and its stats + threshold
# calibration phase
TIMINGS = {"detection": 0.0, "calibration": None}


def hmm_controller_multiple(param, log: Optional[MessageLog] = None) -> None:
    log = log or MessageLog()
    nfiles = param.infiles
    # concrete engine kind before anything reads it
    param.engine = resolve_engine(param)
    if getattr(param, "multihost", False):
        raise NotImplementedError(
            "-multihost is not ported to tagdust_tpu_torch yet"
        )

    cli_rs = read_structure_from_params(param.segments)
    read_structures: List[ReadStructure] = []
    TIMINGS["detection"] = 0.0
    for i in range(nfiles):
        if i == 0 and cli_rs.num_segments:
            rs = cli_rs
        elif param.arch_file:
            t_det = time.perf_counter()
            rs = test_architectures(param, i, log=log)
            TIMINGS["detection"] += time.perf_counter() - t_det
        else:
            rs = build_read_structure(["R:N"])
            qc_read_structure(rs)
        read_structures.append(rs)

    barcode_present = 0
    read_present = [0] * nfiles
    for i, rs in enumerate(read_structures):
        for j in range(rs.num_segments):
            if rs.types[j] == "B":
                barcode_present |= 1 << i
            if rs.types[j] == "R":
                read_present[i] += 1

    if bin(barcode_present).count("1") > 1:
        log("Barcodes seem to be in both architectures... \n")
        log.flush(param.outfile)
        raise SystemExit(1)

    num_out_reads = sum(read_present)
    for i in range(nfiles):
        if barcode_present & (1 << i):
            found = existing_output_files(
                param.outfile, read_structures[i], num_out_reads, param.multiread
            )
            if found:
                log.flush(param.outfile)
                raise SystemExit("Error: some output files already exists.\n")

    param.num_query = 1000 if param.rtest else 1000001
    # streaming chunks: the reference's 1M-read batches, with a short first
    # chunk that gets the device working sooner; RTEST keeps 1000-read
    # batches.  Output bytes are chunk-size invariant.
    read_chunk = param.num_query
    first_chunk = read_chunk
    env_chunk = os.environ.get("TAGDUST_TPU_CHUNK")
    if not param.rtest:
        read_chunk = int(env_chunk or 1000000)
        first_chunk = min(
            read_chunk, int(os.environ.get("TAGDUST_TPU_FIRST_CHUNK", "131072"))
        )
    elif env_chunk:
        read_chunk = first_chunk = int(env_chunk)

    t_cal = time.perf_counter()
    stats = [
        get_sequence_stats(
            param.infile[i], read_structures[i], param.num_query,
            param.matchstart, param.matchend, sam_filter=param.filter,
        )
        for i in range(nfiles)
    ]
    thresholds = [0.0] * nfiles
    if not param.confidence_threshold:
        # calibrate on the engine production will score with
        def _get_prob(mb, seq_list):
            return run_get_prob(mb, seq_list, engine_kind=param.engine)

        for i in range(nfiles):
            log(f"Determining threshold for read{i}.\n")
            thresholds[i] = estimate_q_threshold(
                param, read_structures[i], stats[i], _get_prob
            )
            log(f"Selected Threshold:: {thresholds[i]:f}\n")
    # NOTE: with -Q given the reference leaves confidence_thresholds[] at 0.0
    # and uses those per-file values (barcode_hmm.c:102, :314).
    TIMINGS["calibration"] = time.perf_counter() - t_cal

    model_bags = [
        init_model_bag(
            read_structures[i], stats[i], param.sequencer_error_rate,
            param.indel_frequency,
        )
        for i in range(nfiles)
    ]

    contaminants = None
    contaminant_names = None
    if param.reference_fasta:
        contaminant_names, contaminants = read_fasta_contaminants(param.reference_fasta)
    mer_hash = [0] * (len(contaminants) if contaminants else 0)

    readers = [
        SeqReader(param.infile[i], sam_filter=param.filter) for i in range(nfiles)
    ]

    counters = {
        "total": 0,
        "success": 0,
        "bar_finger": 0,
        "too_short": 0,
        "arch_mismatch": 0,
        "artifact": 0,
        "low_complexity": 0,
    }

    writer: Optional[DemuxWriter] = None
    # read_structure used by the writer: the barcoded file's, else the last
    # file's (barcode_hmm.c:312-340)
    writer_rs = read_structures[-1]
    for i in range(nfiles):
        if barcode_present & (1 << i):
            writer_rs = read_structures[i]
            break

    # Pipelined streaming loop: a reader thread prefetches the next chunk
    # while the current one is scored and extracted, and a writer thread
    # drains finished chunks, in order.
    chunk_q: queue.Queue = queue.Queue(maxsize=2)
    write_q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()
    writer_err: List[BaseException] = []

    def _reader_loop() -> None:
        try:
            cidx = 0
            while not stop.is_set():
                clen = first_chunk if cidx == 0 else read_chunk
                chunks = [readers[i].read_chunk_batch(clen) for i in range(nfiles)]
                counts = [c.B for c in chunks]
                chunk_q.put((cidx, chunks, counts))
                if sum(counts) == 0:
                    return
                cidx += 1
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            chunk_q.put(e)

    def _writer_loop() -> None:
        # after a write failure keep draining until the None sentinel, or
        # the main thread's next put() would block forever
        while True:
            item = write_q.get()
            if item is None:
                return
            if writer_err:
                continue
            try:
                chunks_, numseq_ = item
                writer.write_batch_columnar(chunks_, numseq_)
            except BaseException as e:  # noqa: BLE001
                writer_err.append(e)

    reader_thread = threading.Thread(
        target=_reader_loop, name="tagdust-reader", daemon=True
    )
    reader_thread.start()
    writer_thread: Optional[threading.Thread] = None

    def _shutdown_pipeline() -> None:
        stop.set()
        while True:  # unblock the reader if it is waiting on a full queue
            try:
                chunk_q.get_nowait()
            except queue.Empty:
                break
        reader_thread.join(timeout=10)
        if writer_thread is not None:
            write_q.put(None)
            writer_thread.join(timeout=60)

    first_batch = True
    while True:
        item = chunk_q.get()
        if isinstance(item, BaseException):
            _shutdown_pipeline()
            raise item
        _, chunks, numseqs = item
        if sum(numseqs) == 0:
            break
        for i in range(nfiles - 1):
            for j in range(i + 1, nfiles):
                if numseqs[i] != numseqs[j]:
                    log(
                        f"Input File:{param.infile[i]} and {param.infile[j]} "
                        "differ in number of entries.\n"
                    )
                    log.flush(param.outfile)
                    _shutdown_pipeline()
                    raise SystemExit(1)
        if first_batch:
            for i in range(nfiles - 1):
                for j in range(i + 1, nfiles):
                    for c in range(min(1000, numseqs[0])):
                        if compare_read_names(chunks[i].name(c), chunks[j].name(c), log):
                            log(
                                "Files seem to contain reads in different "
                                f"order:\n{chunks[i].name(c)}\n{chunks[j].name(c)}\n"
                            )
                            log.flush(param.outfile)
                            _shutdown_pipeline()
                            raise SystemExit(1)

        for i in range(nfiles):
            mx = int(chunks[i].lens.max(initial=0))
            if mx >= stats[i].max_seq_len:
                stats[i].max_seq_len = mx

        for i in range(nfiles):
            rs = read_structures[i]
            if rs.is_pure_R():
                run_rna_dust_batch(chunks[i], param, contaminants)
            else:
                run_get_label_batch(
                    model_bags[i], rs, chunks[i], param, thresholds[i],
                    contaminants,
                )

        # propagate barcode from the barcoded file to file 0
        for i in range(nfiles):
            if barcode_present & (1 << i):
                if i:
                    chunks[0].barcode[:] = chunks[i].barcode
                break

        if nfiles > 1:
            chunks[0].read_type[:] = np.maximum.reduce(
                [chunks[j].read_type for j in range(nfiles)]
            )

        if writer is None:
            writer = DemuxWriter(
                param.outfile, writer_rs, read_present, param.print_seq_finger
            )
            writer_thread = threading.Thread(
                target=_writer_loop, name="tagdust-writer", daemon=True
            )
            writer_thread.start()
        if writer_err:
            _shutdown_pipeline()
            raise writer_err[0]
        write_q.put((chunks, numseqs[0]))
        first_batch = False

        counters["total"] += numseqs[0]
        rt = chunks[0].read_type
        counters["success"] += int((rt == EXTRACT_SUCCESS).sum())
        counters["bar_finger"] += int((rt == EXTRACT_FAIL_BAR_FINGER_NOT_FOUND).sum())
        counters["too_short"] += int((rt == EXTRACT_FAIL_READ_TOO_SHORT).sum())
        counters["arch_mismatch"] += int(
            (rt == EXTRACT_FAIL_ARCHITECTURE_MISMATCH).sum()
        )
        # reference case fallthrough (barcode_hmm.c:373-377): plain
        # MATCHES_ARTIFACTS counts as artifact AND low complexity
        plain_art = int((rt == EXTRACT_FAIL_MATCHES_ARTIFACTS).sum())
        counters["artifact"] += plain_art
        counters["low_complexity"] += plain_art + int(
            (rt == EXTRACT_FAIL_LOW_COMPLEXITY).sum()
        )
        other = (rt > EXTRACT_FAIL_LOW_COMPLEXITY) | (
            rt == EXTRACT_FAIL_AMBIGIOUS_BARCODE
        )
        counters["artifact"] += int(other.sum())
        if mer_hash:
            ids = (rt[other] >> 8) - 1
            bc = np.bincount(
                np.clip(ids, 0, len(mer_hash) - 1), minlength=len(mer_hash)
            )
            for k in range(len(mer_hash)):
                mer_hash[k] += int(bc[k])

    if writer_thread is not None:
        write_q.put(None)
        writer_thread.join()
        if writer_err:
            raise writer_err[0]
    reader_thread.join(timeout=10)
    if writer is not None:
        writer.close()
    if not reader_thread.is_alive():
        # close the readers only once the reader thread is provably done
        for r in readers:
            r.close()

    log("Done.\n\n")
    for i in range(nfiles):
        log(f"{param.infile[i]}\tInput file {i}.\n")
    log(f"{counters['total']}\ttotal input reads\n")
    log(f"{thresholds[-1]:.2f}\tselected threshold\n")
    log(f"{counters['success']}\tsuccessfully extracted\n")
    pct = (
        100.0 * counters["success"] / counters["total"] if counters["total"] else 0.0
    )
    log(f"{pct:.1f}%\textracted\n")
    log(f"{counters['arch_mismatch']}\tproblems with architecture\n")
    log(f"{counters['bar_finger']}\tbarcode / UMI not found\n")
    log(f"{counters['too_short']}\ttoo short\n")
    log(f"{counters['low_complexity']}\tlow complexity\n")
    log(f"{counters['artifact']}\tmatch artifacts:\n")
    if contaminant_names:
        for i, n in enumerate(contaminant_names):
            if mer_hash[i]:
                log(f"{mer_hash[i]}\t{n}\n")
    log.flush(param.outfile)
