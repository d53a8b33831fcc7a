"""Deterministic RNG matching the reference's ``-DRTEST`` LCG.

Under ``-DRTEST`` the reference macro-replaces libc rand()/srand() with a
fixed 32-bit LCG (``misc.c:878-887``, ``misc.h:85-94``)::

    next = next * 1103515245 + 12345
    rand() = (next / 65536) % 32768        # RAND_MAX == 32767

and every ``(float)rand()/(float)my_rand_max`` division uses
``my_rand_max == 32768`` (e.g. ``barcode_hmm.c:2602-2606``,
``simulate_reads.c:39-43``).  Reproducing that byte stream is what makes the
dev/ golden outputs (seed 42) achievable.  This class is the single RNG used
throughout the deterministic paths of this framework.
"""

import numpy as np


class CRand:
    """The reference RTEST LCG. State is a uint32."""

    RAND_MAX_DIV = np.float32(32768.0)

    def __init__(self, seed: int = 1):
        self.next = np.uint32(seed)

    def srand(self, seed: int) -> None:
        self.next = np.uint32(seed)

    def rand(self) -> int:
        """Return the next integer in [0, 32767]."""
        # uint32 wrap-around arithmetic
        self.next = np.uint32(
            (int(self.next) * 1103515245 + 12345) & 0xFFFFFFFF
        )
        return (int(self.next) // 65536) % 32768

    def randf(self) -> np.float32:
        """(float)rand() / (float)32768 — float32 division like the C code."""
        return np.float32(np.float32(self.rand()) / self.RAND_MAX_DIV)
