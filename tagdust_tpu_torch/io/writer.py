"""Demultiplexed FASTQ output with the reference's exact naming and headers.

Re-implements ``print_all`` (``io.c:757-1016``):

* output-file set = (#barcodes, or 2 when no barcode segment) x (#R-segments
  summed over input files), named ``<p>_BC_<seq>[_READ<n>].fq`` /
  ``<p>[_READ<n>].fq`` / ``<p>_un[_READ<n>].fq`` (``io.c:857-915``);
* reads route by merged outcome + decoded barcode; the un-file is the last
  alternative;
* extracted sequences are stored with 65-valued spacers; each maximal
  spacer-free run goes to the next READ file in sequence (``io.c:946-996``);
* headers are ``@<name>[;FP:<key|seq>];RQ:<q>`` with the per-file read's own
  mapq (``io.c:959-994``; ``get_finger_seq``, ``io.c:1018-1029``);
* refuses to start if outputs exist (``io.c:633-691``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..arch import ReadStructure
from ..constants import ALPHABET, EXTRACT_SUCCESS

# code -> output letter; codes >= 5 are run separators (65-spacers, '.')
_ASCII_LUT = np.zeros(256, dtype=np.uint8)
for _i, _ch in enumerate(ALPHABET[:5]):
    _ASCII_LUT[_i] = ord(_ch)


def finger_seq(key: int) -> str:
    """get_finger_seq (io.c:1018-1029)."""
    length = key & 0xFF
    key >>= 8
    out = [""] * length
    for i in range(length):
        out[length - i - 1] = "ACGTN"[key & 0x3]
        key >>= 2
    return "".join(out)


def existing_output_files(
    outfile: str, rs: ReadStructure, num_reads: int, multiread: int
) -> List[str]:
    """check_for_existing_demultiplexed_files_multiple (io.c:633-691)."""
    found = []
    barseg = rs.barcode_segment()
    if barseg != -1:
        for i in range(rs.numseq_in_segment(barseg) - 1):
            if num_reads > 1:
                for j in range(num_reads):
                    p = f"{outfile}_BC_{rs.seqs[barseg][i]}_READ{j + 1}.fq"
                    if os.path.exists(p):
                        found.append(p)
            else:
                p = f"{outfile}_BC_{rs.seqs[barseg][i]}.fq"
                if os.path.exists(p):
                    found.append(p)
    else:
        if multiread == 2:
            for j in range(num_reads):
                p = f"{outfile}_READ{j + 1}.fq"
                if os.path.exists(p):
                    found.append(p)
        else:
            p = f"{outfile}.fq"
            if os.path.exists(p):
                found.append(p)
    if multiread == 2:
        for j in range(num_reads):
            p = f"{outfile}_un_READ{j + 1}.fq"
            if os.path.exists(p):
                found.append(p)
    else:
        p = f"{outfile}_un.fq"
        if os.path.exists(p):
            found.append(p)
    return found


class DemuxWriter:
    """Holds the open per-(read-slot, alternative) file handles across
    batches; file layout mirrors io.c:861-915."""

    def __init__(
        self,
        outfile: str,
        rs: ReadStructure,
        read_present: List[int],
        print_seq_finger: bool = False,
        track_chunks: bool = False,
    ):
        self.outfile = outfile
        self.rs = rs
        self.read_present = read_present
        self.print_seq_finger = print_seq_finger
        self.track_chunks = track_chunks
        self.num_out_reads = sum(read_present)
        barseg = rs.barcode_segment()
        if barseg != -1:
            self.num_alternatives = rs.numseq_in_segment(barseg)
            bar_matrix = rs.seqs[barseg]
        else:
            self.num_alternatives = 2
            bar_matrix = None
        if self.num_out_reads == 0:
            raise SystemExit(
                "ERROR: No output files to create. Input sequences may not "
                "contain extractable reads or may not match the expected "
                "architecture."
            )
        names = []
        if bar_matrix is not None:
            if self.num_out_reads > 1:
                for i in range(self.num_out_reads):
                    for j in range(self.num_alternatives - 1):
                        names.append(f"{outfile}_BC_{bar_matrix[j]}_READ{i + 1}.fq")
                    names.append(f"{outfile}_un_READ{i + 1}.fq")
            else:
                for j in range(self.num_alternatives - 1):
                    names.append(f"{outfile}_BC_{bar_matrix[j]}.fq")
                names.append(f"{outfile}_un.fq")
        else:
            if self.num_out_reads > 1:
                for i in range(self.num_out_reads):
                    names.append(f"{outfile}_READ{i + 1}.fq")
                    names.append(f"{outfile}_un_READ{i + 1}.fq")
            else:
                names.append(f"{outfile}.fq")
                names.append(f"{outfile}_un.fq")
        self.names = names
        self.files = [open(n, "wb") for n in names]
        # multi-host shard bookkeeping (only under -multihost): byte range
        # each chunk wrote to each output file, so host 0 can interleave the
        # shards back into the reference's single file set in global chunk
        # order (parallel/multihost.py:merge_output_shards)
        if track_chunks:
            self._suffixes = [n[len(outfile):] for n in names]
            self._chunk_segments: dict = {s: [] for s in self._suffixes}
            self._last_pos = [0] * len(names)

    def mark_chunk(self, chunk_idx: int) -> None:
        """Record [start, end) byte ranges this chunk appended per file.

        The native emitter writes straight to the fds, so positions come
        from lseek after flushing the Python-side buffers."""
        assert self.track_chunks, "mark_chunk requires track_chunks=True"
        for i, f in enumerate(self.files):
            f.flush()
            pos = os.lseek(f.fileno(), 0, os.SEEK_CUR)
            if pos > self._last_pos[i]:
                self._chunk_segments[self._suffixes[i]].append(
                    [chunk_idx, self._last_pos[i], pos]
                )
            self._last_pos[i] = pos

    def write_sidecar(self, path: str) -> None:
        """Dump the per-chunk byte-range index (JSON) next to the shard."""
        import json

        with open(path, "w") as fh:
            json.dump({"files": self._chunk_segments}, fh)

    def write_batch_columnar(self, batches, numseq: int) -> None:
        """print_all over columnar ReadBatches (the production hot path).

        Routing/formatting matches :meth:`write_batch` byte for byte (gold
        tests pin it); the per-run emit loop runs in the native codec
        (``td_emit_runs``) writing straight to the output fds."""
        import ctypes

        from ..constants import EXTRACT_SUCCESS as _OK
        from .native_io import get_lib

        b0 = batches[0]
        assert b0.B == numseq, (b0.B, numseq)
        if any(b.fp_big for b in batches):
            # >27nt UMI keys exceed the int64 column: rare exact-precision
            # path through the per-read writer
            self.write_batch([b.to_reads() for b in batches], numseq)
            return
        n_alt = self.num_alternatives
        ok = b0.read_type == _OK
        base_f = np.where(
            ok,
            np.where(b0.barcode != -1, b0.barcode & 0xFF, 0),
            n_alt - 1,
        ).astype(np.int64)
        lib = get_lib()
        fds = np.array([f.fileno() for f in self.files], dtype=np.int32)
        for f in self.files:
            f.flush()
        c = 0
        i64p = ctypes.POINTER(ctypes.c_long)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for j in range(len(self.read_present)):
            if not self.read_present[j]:
                c += n_alt * self.read_present[j]
                continue
            b = batches[j]
            arrs = {
                "na": np.ascontiguousarray(b.name_arena),
                "no": np.ascontiguousarray(b.name_off),
                "sa": np.ascontiguousarray(b.seq_arena),
                "so": np.ascontiguousarray(b.seq_off),
                "qa": np.ascontiguousarray(b.qual_arena),
                "qo": np.ascontiguousarray(b.qual_off),
                "ql": np.ascontiguousarray(b.qual_len),
                "mq": np.ascontiguousarray(b.mapq, dtype=np.float64),
                "fp": np.ascontiguousarray(b.fingerprint, dtype=np.int64),
                "fb": np.ascontiguousarray(base_f + c),
            }
            rc = lib.td_emit_runs(
                arrs["na"].ctypes.data_as(u8p),
                arrs["no"].ctypes.data_as(i64p),
                arrs["sa"].ctypes.data_as(u8p),
                arrs["so"].ctypes.data_as(i64p),
                arrs["qa"].ctypes.data_as(u8p),
                arrs["qo"].ctypes.data_as(i64p),
                arrs["ql"].ctypes.data_as(i64p),
                arrs["mq"].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                arrs["fp"].ctypes.data_as(i64p),
                ctypes.c_int(1 if self.print_seq_finger else 0),
                arrs["fb"].ctypes.data_as(i64p),
                ctypes.c_long(numseq),
                ctypes.c_long(n_alt),
                fds.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                ctypes.c_long(len(self.files)),
            )
            if rc != 0:
                raise OSError(
                    f"tagdust writer: native emit failed (rc={rc}) — "
                    "output device error (disk full / broken pipe?)"
                )
            c += n_alt * self.read_present[j]

    def write_batch(self, read_info_container, numseq: int) -> None:
        """read_info_container[file][i] like the reference; routing uses
        file 0's merged read_type/barcode (io.c:923-1001).

        Formatting is batched: one LUT translate + run-boundary scan over the
        whole [B, Lmax] code matrix per input file, then per-run byte slices
        into per-output-file buffers (equivalent to the per-base walk of
        io.c:946-996, asserted byte-identical by the gold tests)."""
        n_alt = self.num_alternatives
        r0s = read_info_container[0]
        base_f = np.empty(numseq, dtype=np.int64)
        for i in range(numseq):
            r0 = r0s[i]
            if r0.read_type == EXTRACT_SUCCESS:
                base_f[i] = (r0.barcode & 0xFF) if r0.barcode != -1 else 0
            else:
                base_f[i] = n_alt - 1
        buffers: List[List[bytes]] = [[] for _ in self.files]
        c = 0
        for j in range(len(self.read_present)):
            if self.read_present[j]:
                self._emit_batch(
                    read_info_container[j][:numseq], base_f + c, buffers
                )
            c += n_alt * self.read_present[j]
        for fh, buf in zip(self.files, buffers):
            if buf:
                fh.write(b"".join(buf))

    def _emit_batch(self, reads, f_per_read, buffers) -> None:
        B = len(reads)
        if B == 0:
            return
        lens = np.fromiter((r.len for r in reads), dtype=np.int64, count=B)
        Lmax = max(int(lens.max(initial=0)), 1)
        arr = np.full((B, Lmax), 255, dtype=np.uint8)
        qarr = np.full((B, Lmax), ord("."), dtype=np.uint8)
        for i, r in enumerate(reads):
            L = r.len
            arr[i, :L] = r.seq
            if r.qual is not None:
                qarr[i, :L] = np.frombuffer(
                    r.qual.encode("latin-1"), dtype=np.uint8
                )[:L]
        seq_flat = _ASCII_LUT[arr].tobytes()
        qual_flat = qarr.tobytes()
        keep = arr < 5
        prev = np.zeros_like(keep)
        prev[:, 1:] = keep[:, :-1]
        nxt = np.zeros_like(keep)
        nxt[:, :-1] = keep[:, 1:]
        si, sj = np.nonzero(keep & ~prev)  # run starts, row-major order
        ei, ej = np.nonzero(keep & ~nxt)  # matching run ends (inclusive)
        headers = [self._header(r) for r in reads]
        n_alt = self.num_alternatives
        run_k = 0
        prev_i = -1
        for n in range(si.shape[0]):
            i = int(si[n])
            if i != prev_i:
                run_k = 0
                prev_i = i
            a = i * Lmax + int(sj[n])
            b = i * Lmax + int(ej[n]) + 1
            buf = buffers[int(f_per_read[i]) + run_k * n_alt]
            buf.append(headers[i])
            buf.append(seq_flat[a:b])
            buf.append(b"\n+\n")
            buf.append(qual_flat[a:b])
            buf.append(b"\n")
            run_k += 1

    def _header(self, r) -> bytes:
        if r.fingerprint != -1:
            if self.print_seq_finger:
                s = f"@{r.name};FP:{finger_seq(r.fingerprint)};RQ:{r.mapq:.2f}\n"
            else:
                s = f"@{r.name};FP:{r.fingerprint};RQ:{r.mapq:.2f}\n"
        else:
            s = f"@{r.name};RQ:{r.mapq:.2f}\n"
        return s.encode("latin-1")

    def close(self) -> None:
        for f in self.files:
            f.close()
