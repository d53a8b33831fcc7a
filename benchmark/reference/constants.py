"""Shared constants: nucleotide codes, transition indices, outcome codes.

Parity notes (the TagDust2 reference sources):
* nucleotide encoding mirrors ``nuc_code.c:46-74``: A/a=0 C/c=1 G/g=2 T/t/U/u=3,
  '.'=5, everything else 4 (N); complement table maps 0<->3, 1<->2, 4->4.
* the 9 per-column transition slots mirror ``barcode_hmm.h:87-96``.
* extraction outcome codes mirror ``barcode_hmm.h:172-178``.
* the multi-read spacer value 65 mirrors ``barcode_hmm.c:3348``.
"""

import numpy as np

# ---- transition indices (per HMM column) ----
MM, MI, MD, II, IM, DD, DM, MSKIP, ISKIP = 0, 1, 2, 3, 4, 5, 6, 7, 8
NUM_TRANS = 9

# ---- extraction outcomes ----
EXTRACT_SUCCESS = 0
EXTRACT_FAIL_BAR_FINGER_NOT_FOUND = 1
EXTRACT_FAIL_READ_TOO_SHORT = 2
EXTRACT_FAIL_AMBIGIOUS_BARCODE = 3
EXTRACT_FAIL_ARCHITECTURE_MISMATCH = 4
EXTRACT_FAIL_MATCHES_ARTIFACTS = 5
EXTRACT_FAIL_LOW_COMPLEXITY = 6

# ---- engine run modes ----
MODE_GET_LABEL = 1
MODE_TRAIN = 2
MODE_GET_PROB = 4
MODE_ARCH_COMP = 5

SPACER = 65  # multi-read spacer code inside extracted sequences

MAX_NUM_SEGMENTS = 10  # -1 ... -10 CLI options

ALPHABET = "ACGTNN"  # code -> letter for output

# nucleotide code tables
NUC_CODE = np.full(256, 4, dtype=np.uint8)
NUC_CODE[ord(".")] = 5
for _ch, _c in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    NUC_CODE[ord(_ch)] = _c
    NUC_CODE[ord(_ch.lower())] = _c

REV_NUC_CODE = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode_seq(s: bytes) -> np.ndarray:
    """Encode an ASCII sequence into 0-5 codes."""
    return NUC_CODE[np.frombuffer(s, dtype=np.uint8)]


def decode_seq(codes) -> str:
    """Decode 0-5 codes back to letters (4 and 5 both print as N)."""
    out = []
    for c in codes:
        out.append(ALPHABET[int(c)])
    return "".join(out)
