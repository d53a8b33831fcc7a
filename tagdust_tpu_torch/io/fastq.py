"""Sequence input: FASTA / FASTQ / SAM readers with gzip/bz2 support.

Re-implements the reference reader semantics:

* file-type detection by suffix (``io.c:410-456``);
* the line-state FASTQ/FASTA parser (``read_fasta_fastq``, ``io.c:1684-1815``):
  header lines start records, a bare ``+`` introduces the quality line, the
  *full* header after ``@``/``>`` (including spaces) becomes the read name,
  sequences are encoded to 0-5 codes via the nuc_code table;
* SAM parsing of name/seq/qual columns (``read_sam_chunk``, ``io.c:1498-1667``);
* chunked reading: a chunk returns exactly ``num_query`` reads unless the
  file is exhausted.

Where the reference pipes through ``zcat``/``bzcat``/``samtools view`` child
processes (``io.c:459-606``), this implementation uses in-process streaming
decompression (gzip/bz2 modules) and direct SAM parsing; ``.bam`` files fall
back to a ``samtools view`` subprocess when available.
"""

from __future__ import annotations

import bz2
import gzip
import os
import subprocess
from dataclasses import dataclass, field
from typing import IO, List, Optional

import numpy as np

from ..constants import NUC_CODE


@dataclass
class Read:
    name: str = ""
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint8))
    qual: Optional[str] = None
    # result fields (read_info, io.h:76-91)
    labels: Optional[np.ndarray] = None
    mapq: float = -1.0
    bar_prob: float = 0.0
    barcode: int = -1
    fingerprint: int = -1
    read_type: int = 0

    @property
    def len(self) -> int:
        return int(self.seq.shape[0])


def detect_format(path: str) -> dict:
    """Suffix-based detection mirroring io.c:410-456."""
    d = {"sam": 0, "fasta": 0, "gzipped": 0, "bzipped": 0}
    suffix_map = [
        (".sam.gz", {"sam": 1, "gzipped": 1}),
        (".bam.gz", {"sam": 2, "gzipped": 1}),
        (".fa.gz", {"fasta": 1, "gzipped": 1}),
        (".fq.gz", {"gzipped": 1}),
        (".fastq.gz", {"gzipped": 1}),
        (".fastaq.gz", {"gzipped": 1}),
        (".fasta.gz", {"gzipped": 1}),
        (".fastq.bz2", {"bzipped": 1}),
        (".fq.bz2", {"bzipped": 1}),
        (".sam", {"sam": 1}),
        (".bam", {"sam": 2}),
        (".fa", {"fasta": 1}),
        (".fq", {}),
        (".fastq", {}),
        (".fastaq", {}),
        (".fasta", {"fasta": 1}),
    ]
    for suf, flags in suffix_map:
        if path.endswith(suf):
            d.update(flags)
            return d
    d["sam"] = -1
    return d


def _open_stream(path: str, fmt: dict, sam_filter: Optional[str] = None) -> IO[bytes]:
    if fmt["sam"] == 2:
        # BAM needs samtools; mirror `samtools view -F 768` — with `-filter`
        # given, the user's value replaces 768 (io.c:469-562)
        proc = subprocess.Popen(
            ["samtools", "view", "-F", sam_filter or "768", path],
            stdout=subprocess.PIPE,
        )
        return proc.stdout  # type: ignore[return-value]
    if fmt["gzipped"]:
        return gzip.open(path, "rb")
    if fmt["bzipped"]:
        return bz2.open(path, "rb")
    return open(path, "rb")


class SeqReader:
    """Streaming chunked reader over one sequence file.

    FASTA/FASTQ parsing goes through the native codec
    (csrc/fastq_codec.cpp) by default; results are identical to the Python
    line-state parser (asserted by tests).  Set env TAGDUST_TPU_FAST_IO=0
    (or fast=False) to force the pure-Python parser."""

    def __init__(
        self,
        path: str,
        fast: Optional[bool] = None,
        sam_filter: Optional[str] = None,
    ):
        self.path = path
        self.fmt = detect_format(path)
        self.stream = _open_stream(path, self.fmt, sam_filter)
        self.is_sam = self.fmt["sam"] in (1, 2)
        # -filter replaces the default 768 exclusion mask the reference
        # passes to `samtools view -F` (io.c:469-562); samtools parses the
        # value with strtol base 0, hence int(v, 0)
        self._sam_exclude = int(sam_filter, 0) if sam_filter else 768
        self.is_fasta = bool(self.fmt["fasta"])
        # multi-host input-sharding accounting: how many records this reader
        # fully parsed vs boundary-skipped (asserted by tests/test_multihost)
        self.records_parsed = 0
        self.records_skipped = 0
        self._pending: Optional[bytes] = None
        if fast is None:
            fast = os.environ.get("TAGDUST_TPU_FAST_IO", "1") == "1"
        self._fast = None
        if fast and not self.is_sam:
            try:
                from .native_io import FastParser

                self._fast = FastParser(self.stream, self.is_fasta)
            except Exception as e:  # noqa: BLE001 — loud downgrade, strict re-raise
                from ..strict import fallback

                fallback(
                    "native-fastq-codec",
                    e,
                    "native C++ FASTQ/FASTA codec unavailable; parsing with "
                    "the Python line-state parser",
                )
                self._fast = None

    def close(self) -> None:
        try:
            self.stream.close()
        except Exception:
            pass

    def _lines(self):
        if self._pending is not None:
            ln = self._pending
            self._pending = None
            yield ln
        for ln in self.stream:
            yield ln

    def read_chunk(self, num_query: int) -> List[Read]:
        if self.is_sam:
            out = self._read_sam_chunk(num_query)
        elif self._fast is not None:
            out = self._fast.read_records(num_query)
        else:
            out = self._read_fasta_fastq_chunk(num_query)
        self.records_parsed += len(out)
        return out

    def skip_chunk(self, num_query: int) -> int:
        """Skip up to num_query records, returning the count skipped.

        Multi-host input sharding (parallel/multihost.py): chunks owned by
        another process only pay record-boundary scanning here — the
        native codec's ``td_skip_fastq`` does no arena copies and no nuc
        encoding.  SAM and the pure-Python parser fall back to
        parse-and-discard (still cheaper than scoring, and rare paths)."""
        if self._fast is not None and not self.is_sam:
            n = self._fast.skip_records(num_query)
        else:
            n = len(self.read_chunk(num_query))
            self.records_parsed -= n  # parse-and-discard counts as a skip
        self.records_skipped += n
        return n

    def read_chunk_batch(self, num_query: int):
        """Columnar chunk read (ReadBatch) — the production hot path.

        FASTQ/FASTA via the native codec stays array-only end to end; SAM
        and the pure-Python parser convert through per-read objects."""
        from .batch import ReadBatch

        if self._fast is not None and not self.is_sam:
            rb = self._fast.read_batch(num_query)
            self.records_parsed += rb.B
            return rb
        return ReadBatch.from_reads(self.read_chunk(num_query))

    # -- FASTA / FASTQ (io.c:1684-1815) --
    def _read_fasta_fastq_chunk(self, num_query: int) -> List[Read]:
        out: List[Read] = []
        cur: Optional[Read] = None
        set_flag = 0
        seq_p = 0
        for raw in self._lines():
            line = raw.rstrip(b"\r\n")
            first = line[:1]
            if (first == b"@" or first == b">") and not set_flag:
                cur = Read(name=line[1:].decode("ascii", "replace"))
                out.append(cur)
                seq_p = 1
                set_flag = 1
            elif first == b"+" and not set_flag:
                seq_p = 0
                set_flag = 1
            else:
                if set_flag and cur is not None:
                    if seq_p:
                        cur.seq = NUC_CODE[np.frombuffer(line, dtype=np.uint8)].copy()
                    else:
                        if len(line) != cur.len:
                            raise SystemExit(
                                "ERROR: Length of sequence and base qualities"
                                " differ!."
                            )
                        cur.qual = line.decode("ascii", "replace")
                set_flag = 0
            if len(out) == num_query:
                done = (
                    cur is not None
                    and (cur.qual is not None if not self.is_fasta else cur.len > 0)
                )
                if done:
                    return out
        return out

    # -- SAM (io.c:1498-1667) --
    def _read_sam_chunk(self, num_query: int) -> List[Read]:
        out: List[Read] = []
        for raw in self._lines():
            if raw.startswith(b"@"):
                continue
            cols = raw.rstrip(b"\r\n").split(b"\t")
            if len(cols) < 11:
                continue
            # reference pipes SAM through `samtools view -F 768` (io.c:485):
            # drop secondary (0x100) and QC-fail (0x200) records, or the
            # caller's -filter mask
            try:
                flag = int(cols[1])
            except ValueError:
                continue
            if flag & self._sam_exclude:
                continue
            r = Read(name=cols[0].decode("ascii", "replace"))
            r.mapq = float(cols[4])
            r.seq = NUC_CODE[np.frombuffer(cols[9], dtype=np.uint8)].copy()
            r.qual = cols[10].decode("ascii", "replace")
            out.append(r)
            if len(out) == num_query:
                return out
        return out


def open_seq_file(path: str) -> SeqReader:
    return SeqReader(path)


def read_fasta_contaminants(path: str):
    """Contaminant FASTA loader mirroring get_fasta/read_fasta
    (io.c:1826-2001): names with spaces -> '_', sequences nuc-coded."""
    names: List[str] = []
    seqs: List[np.ndarray] = []
    cur_name = None
    cur: List[int] = []
    with open(path, "rb") as fh:
        data = fh.read().replace(b"\r", b"\n")
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            if cur_name is not None:
                seqs.append(np.array(cur, dtype=np.uint8))
            cur_name = (
                line[1:].decode("ascii", "replace").replace(" ", "_").replace("\t", "_")
            )
            names.append(cur_name)
            cur = []
        else:
            for ch in line:
                if chr(ch).isalnum():
                    cur.append(int(NUC_CODE[ch]))
    if cur_name is not None:
        seqs.append(np.array(cur, dtype=np.uint8))
    return names, seqs
