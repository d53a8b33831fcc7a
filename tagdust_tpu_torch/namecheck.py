"""Paired-file read-name order verification.

Re-implements ``compare_read_names`` (``io.c:2128-2394``): auto-detects the
name format once per run — CASAVA >=1.8
(``instrument:run:flowcell:lane:tile:x:y``), CASAVA <1.8
(``instrument:lane:tile:x:y``) or generic — then verifies that paired files
carry reads in the same order (all coordinate fields must match; generic
names must be identical up to the first space or ';').
"""

from __future__ import annotations

import re
from typing import Optional

_detected: Optional[int] = None

_C18 = re.compile(r"^([^:]+):(-?\d+):([^:]+):(-?\d+):(-?\d+):(-?\d+):(-?\d+)")
_C17 = re.compile(r"^([^:]+):(-?\d+):(-?\d+):(-?\d+):(-?\d+)")


def reset_detection() -> None:
    global _detected
    _detected = None


def compare_read_names(name1: str, name2: str, log=None) -> int:
    """Returns 0 if consistent, 1 otherwise (mirrors io.c:2128-2394)."""
    global _detected
    if _detected is None:
        if _C18.match(name1):
            _detected = 1
            if log:
                log("Detected casava 1.8 format.\n")
        elif _C17.match(name1):
            _detected = 2
            if log:
                log("Detected casava <1.7 format.\n")
        else:
            _detected = 1000

    if _detected == 1:
        m1 = _C18.match(name1)
        m2 = _C18.match(name2)
        if not m1 or not m2:
            return 1
        return 0 if m1.groups() == m2.groups() else 1
    if _detected == 2:
        m1 = _C17.match(name1)
        m2 = _C17.match(name2)
        if not m1 or not m2:
            return 1
        return 0 if m1.groups() == m2.groups() else 1
    # generic: byte equality up to the first space or ';' (io.c:2361-2390)
    for i, ch in enumerate(name1):
        if ch.isspace() or ch == ";":
            break
        if i >= len(name2) or name2[i] != ch:
            return 1
    return 0
