"""Read-architecture DSL: parsing, QC, and the arch-file format.

The architecture language accepts segment types R G O P S F B
(``interface.c:503-516``) given as ``-1 .. -10`` options.  Semantics
reproduced here:

* ``assign_segment_sequences`` (``interface.c:489-598``): comma-separated
  alternatives; for ``B`` and ``S`` segments an extra all-``N`` alternative of
  the same length is appended (the "null barcode" that captures non-barcoded
  reads, rejected later in extraction, ``barcode_hmm.c:3220-3224``); ``R``
  segments always carry the single pseudo-sequence ``"N"``.
* ``QC_read_structure`` (``interface.c:759-829``): no skipped slots, and all
  alternatives within a segment must share one length.
* arch files (``test_architectures.c:72-137``): every line containing the word
  "tagdust" describes one candidate architecture via the same ``-1..-10``
  options; duplicate lines are an error; at most 100 architectures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class ReadStructure:
    """One file's architecture: typed segments with alternative sequences."""

    types: List[str] = field(default_factory=list)
    # sequence_matrix[segment][alternative] -> str
    seqs: List[List[str]] = field(default_factory=list)

    @property
    def num_segments(self) -> int:
        return len(self.types)

    def numseq_in_segment(self, i: int) -> int:
        return len(self.seqs[i])

    def seg_len(self, i: int) -> int:
        return len(self.seqs[i][0])

    def num_R_segments(self) -> int:
        return sum(1 for t in self.types if t == "R")

    def is_pure_R(self) -> bool:
        return self.num_segments == 1 and self.types[0] == "R"

    def barcode_segment(self) -> int:
        """Index of the first B segment or -1 (io.c:643-648)."""
        for i, t in enumerate(self.types):
            if t == "B":
                return i
        return -1


def assign_segment_sequences(spec: str) -> tuple[str, List[str]]:
    """Parse one segment spec like ``B:AC,GG`` -> (type, alternatives).

    Mirrors interface.c:489-598 including the appended all-N alternative for
    B and S segments.
    """
    if not spec or spec[0] not in "RGOPSFB":
        raise ValueError(f"Segment type :{spec[:1]} not recognized.")
    t = spec[0]
    if t == "R":
        return t, ["N"]
    body = spec[2:]
    alts = body.split(",")
    if t in ("B", "S"):
        alts = alts + ["N" * len(alts[0])]
    return t, alts


def build_read_structure(segment_specs: List[str]) -> ReadStructure:
    rs = ReadStructure()
    for spec in segment_specs:
        t, alts = assign_segment_sequences(spec)
        rs.types.append(t)
        rs.seqs.append(alts)
    return rs


def read_structure_from_params(segments: List) -> ReadStructure:
    """Build from the Params.segments slot list (-1..-10), ignoring gaps
    beyond the last set slot but failing QC on internal gaps."""
    specs = []
    last = -1
    for i, s in enumerate(segments):
        if s is not None:
            specs.append(s)
            if last + 1 != i:
                raise ValueError("ERROR: a hmm building block was skipped??")
            last = i
    return build_read_structure(specs)


def qc_read_structure(rs: ReadStructure) -> None:
    """Same-length check per segment (interface.c:776-792)."""
    for i in range(rs.num_segments):
        lens = {len(s) for s in rs.seqs[i]}
        if len(lens) > 1:
            raise ValueError(
                "ERROR: the sequences in the same segment have to have the "
                "same length."
            )


def parse_arch_line(line: str) -> List[str]:
    """Extract the ``-1..-10`` option values from one arch-file line.

    Mirrors test_architectures.c:82-111: for c in 1..10 find the substring
    ``-c`` and take the following whitespace-delimited token.
    """
    specs = []
    for c in range(1, 11):
        pat = f"-{c}"
        idx = line.find(pat)
        if idx < 0:
            if c == 1:
                return []
            continue
        j = idx + len(pat)
        while j < len(line) and line[j].isspace():
            j += 1
        k = j
        while k < len(line) and not line[k].isspace():
            k += 1
        if k > j:
            specs.append(line[j:k])
    return specs


def read_arch_file(path: str) -> List[tuple[str, List[str]]]:
    """Return [(raw_line, segment_specs)] for each architecture line.

    A line is an architecture if it contains "tagdust"
    (test_architectures.c:74).  Raises on duplicates (:149-160) and on
    more than 100 entries (:18, :128-133).
    """
    out = []
    with open(path) as fh:
        for line in fh:
            if "tagdust" in line:
                specs = parse_arch_line(line)
                if specs:
                    out.append((line, specs))
                    if len(out) > 100:
                        raise ValueError(
                            "Error - your architechture file has too many "
                            "architectures. Currently only 100 allowed."
                        )
    for i in range(len(out)):
        for j in range(i + 1, len(out)):
            if out[i][0] == out[j][0]:
                raise ValueError(
                    "ERROR: two architectures in the arch file are the same"
                )
    return out
