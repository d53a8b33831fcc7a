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
2. ``-multihost`` joins a ``torch.distributed`` process group (gloo,
   ``parallel/multihost.py``) in place of ``jax.distributed``; the wiring
   is the JAX controller's: chunk ownership and boundary skips, the
   ``.h<pid>`` output shards and their sidecars, stats, calibration and
   ``-arch`` detection once on host 0 and broadcast, the shard merge and
   the global counters; each process labels its chunks on its local cards
   (``engine/runner.py:_mesh_scorer``);
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
from . import spans
from .spans import TIMINGS, span
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


def hmm_controller_multiple(param, log: Optional[MessageLog] = None) -> None:
    log = log or MessageLog()
    nfiles = param.infiles
    # concrete engine kind before anything reads it
    param.engine = resolve_engine(param)
    spans.reset()

    # multi-host: each process owns chunks with index % nproc == pid,
    # skip-parses the rest (io/fastq.py:skip_chunk), and writes its own
    # output shard; stats, calibration and -arch detection run ONCE on host 0
    # and are broadcast; counters are summed across hosts and host 0 merges
    # the shards back into the reference's single file set at the end
    # (parallel/multihost.py)
    pid, nproc = 0, 1
    final_outfile = param.outfile
    if getattr(param, "multihost", False):
        from .parallel.multihost import init_multihost

        pid, nproc = init_multihost(
            param.coordinator, param.num_processes, param.process_id
        )
        if nproc > 1 and param.outfile:
            param.outfile = f"{param.outfile}.h{pid}"
            log(
                f"Multi-host run: process {pid}/{nproc}; "
                f"output shard prefix {param.outfile}\n"
            )
            # a crashed earlier run may have left this host's sidecar behind;
            # a stale index would corrupt the end-of-run shard merge
            try:
                os.remove(f"{param.outfile}.chunks.json")
            except FileNotFoundError:
                pass

    def _once_on_host0(compute):
        """Run `compute` on host 0 and broadcast the result; other hosts
        receive it (or a host-0 failure, surfaced as SystemExit)."""
        if nproc == 1:
            return compute()
        from .parallel.multihost import broadcast_obj

        if pid == 0:
            exc = None
            try:
                payload = ("ok", compute())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                exc = e
                payload = ("err", f"{type(e).__name__}: {e}")
            out = broadcast_obj(payload, True)
            if exc is not None:
                raise exc
            return out[1]
        status, data = broadcast_obj(None, False)
        if status == "err":
            log(f"host 0 failed: {data}\n")
            log.flush(param.outfile)
            raise SystemExit(1)
        return data

    cli_rs = read_structure_from_params(param.segments)

    def _resolve_read_structures() -> List[ReadStructure]:
        out: List[ReadStructure] = []
        for i in range(nfiles):
            if i == 0 and cli_rs.num_segments:
                rs = cli_rs
            elif param.arch_file:
                with span("detection"):
                    rs = test_architectures(param, i, log=log)
            else:
                rs = build_read_structure(["R:N"])
                qc_read_structure(rs)
            out.append(rs)
        return out

    read_structures = _once_on_host0(_resolve_read_structures)

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
            # refuse on the FINAL (merged) names: that's the file set the
            # user receives (shards are transient under -multihost)
            found = existing_output_files(
                final_outfile, read_structures[i], num_out_reads, param.multiread
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

    def _compute_stats_thresholds():
        t_cal = time.perf_counter()
        with span("controller.stats"):
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
        # NOTE: with -Q given the reference leaves confidence_thresholds[] at
        # 0.0 and uses those per-file values (barcode_hmm.c:102, :314).
        TIMINGS["calibration"] = time.perf_counter() - t_cal
        return stats, thresholds

    stats, thresholds = _once_on_host0(_compute_stats_thresholds)

    with span("controller.model_build"):
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
        # multi-host input sharding: a chunk with index % nproc != pid is
        # owned by another host, and only record-boundary scanning is paid
        # for it (SeqReader.skip_chunk).  With several input files every host
        # parses the HEAD of chunk 0 (the <= 1000 records the read-name
        # pairing check compares) and boundary-skips the rest, so the check
        # fails symmetrically on all hosts.  The chunk schedule is a pure
        # function of cidx, identical on every host.
        try:
            cidx = 0
            while not stop.is_set():
                clen = first_chunk if cidx == 0 else read_chunk
                if nproc == 1 or cidx % nproc == pid:
                    with span("io.parse"):
                        chunks = [readers[i].read_chunk_batch(clen)
                                  for i in range(nfiles)]
                    counts = [c.B for c in chunks]
                elif cidx == 0 and nfiles > 1:
                    head = min(1000, clen)
                    chunks = [readers[i].read_chunk_batch(head) for i in range(nfiles)]
                    counts = [
                        c.B + (readers[i].skip_chunk(clen - head) if clen > head else 0)
                        for i, c in enumerate(chunks)
                    ]
                else:
                    chunks = None
                    counts = [readers[i].skip_chunk(clen) for i in range(nfiles)]
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
                chunks_, numseq_, cidx_ = item
                with span("io.write"):
                    writer.write_batch_columnar(chunks_, numseq_)
                if writer.track_chunks:
                    # the GLOBAL-chunk-indexed byte ranges the shard merge
                    # interleaves back (multihost.py:merge_output_shards)
                    writer.mark_chunk(cidx_)
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
        with span("io.reader_wait"):
            item = chunk_q.get()
        if isinstance(item, BaseException):
            _shutdown_pipeline()
            raise item
        chunk_idx, chunks, numseqs = item
        if sum(numseqs) == 0:
            break
        # the cross-file record-count check runs on every chunk on every
        # host (skip_chunk returns per-file counts), so a mismatch aborts all
        # hosts symmetrically and leaves no collective waiting
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
        if first_batch and chunks is not None:
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

        if chunks is None or chunk_idx % nproc != pid:
            first_batch = False
            continue  # another host owns this chunk (consistency checks ran)

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
                param.outfile, writer_rs, read_present, param.print_seq_finger,
                track_chunks=nproc > 1,
            )
            writer_thread = threading.Thread(
                target=_writer_loop, name="tagdust-writer", daemon=True
            )
            writer_thread.start()
        if writer_err:
            _shutdown_pipeline()
            raise writer_err[0]
        with span("io.writer_wait"):
            write_q.put((chunks, numseqs[0], chunk_idx))
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

    with span("io.writer_wait"):
        if writer_thread is not None:
            write_q.put(None)
            writer_thread.join()
            if writer_err:
                raise writer_err[0]
        if writer is not None:
            writer.close()
    reader_thread.join(timeout=10)
    if not reader_thread.is_alive():
        # close the readers only once the reader thread is provably done
        for r in readers:
            r.close()

    if nproc > 1:
        import json

        from .parallel.multihost import global_counter_sum, merge_output_shards

        if os.environ.get("TAGDUST_TPU_IO_STATS"):
            with open(f"{param.outfile}.iostats.json", "w") as fh:
                json.dump(
                    {
                        "parsed": sum(r.records_parsed for r in readers),
                        "skipped": sum(r.records_skipped for r in readers),
                    },
                    fh,
                )
        # every host enters the merge (it holds a cross-host barrier); host 0
        # interleaves the shards back into the reference's single file set
        if writer is not None:
            writer.write_sidecar(f"{param.outfile}.chunks.json")
        merge_output_shards(final_outfile, pid, nproc)
        # every host's logfile reports the GLOBAL outcome totals
        counters = global_counter_sum(counters)
        if mer_hash:
            mh = global_counter_sum({str(i): v for i, v in enumerate(mer_hash)})
            mer_hash = [mh[str(i)] for i in range(len(mer_hash))]

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
    # host 0 writes the reference-named <out>_logfile.txt (its counters are
    # the global totals); other hosts keep their shard-named logfiles
    log.flush(final_outfile if pid == 0 else param.outfile)
