"""The barcode sets in the repository.

* ``data/flagship_20x6nt.txt``: the flagship set, 20 barcodes of 6nt;
* ``data/plate_96x8nt.txt``: a 96-well plate, 96 barcodes of 8nt (the
  seeded pick finds only 64 at 6nt).

Both are in the EDITTAG line format (``Tag<i>:SEQ``).  They come from
``generate_barcodes``: a seeded greedy pick over the k-mers with exactly
k/2 G/C bases and no run of three equal bases, keeping each candidate at
Hamming distance >= 3 from every barcode already picked.  Regenerate the
files with ``python -m tagdust_tpu_torch.flagship``.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

SEED = 2024
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PATH = os.path.join(_DATA, "flagship_20x6nt.txt")
PLATE_PATH = os.path.join(_DATA, "plate_96x8nt.txt")
# (path, count, length, title) of each set
SETS = [(PATH, 20, 6, "flagship barcode set"),
        (PLATE_PATH, 96, 8, "96-well plate barcode set")]


def generate_barcodes(n: int = 20, length: int = 6, min_dist: int = 3,
                      seed: int = SEED) -> list:
    cands = [
        "".join(p) for p in itertools.product("ACGT", repeat=length)
        if sum(c in "GC" for c in p) == length // 2
        and not any(p[i] == p[i + 1] == p[i + 2] for i in range(length - 2))
    ]
    picked: list = []
    for i in np.random.default_rng(seed).permutation(len(cands)):
        c = cands[int(i)]
        if all(sum(a != b for a, b in zip(c, p)) >= min_dist for p in picked):
            picked.append(c)
            if len(picked) == n:
                return picked
    raise ValueError(f"only {len(picked)} barcodes at distance >= {min_dist}")


def spacer(length: int = 140, seed: int = SEED) -> str:
    """A seeded random spacer of ``length`` nt for an ``S:`` segment.  Its
    chain is 2 * length states wide, so past 64nt a library that holds it
    has no grouped (block-banded) form and runs the dense step mode."""
    return "".join("ACGT"[i] for i in np.random.default_rng(seed).integers(0, 4, length))


def file_text(barcodes: list, title: str = SETS[0][3]) -> str:
    n, k = len(barcodes), len(barcodes[0])
    head = (
        f"# {title} of tagdust_tpu_torch\n"
        f"# {n} barcodes of {k}nt, pairwise Hamming "
        f"distance >= 3, {k // 2} G/C bases each\n"
        f"# made by tagdust_tpu_torch.flagship.generate_barcodes({n}, {k}, 3, "
        f"seed={SEED})\n"
    )
    return head + "".join(f"Tag{i}:{b}\n" for i, b in enumerate(barcodes))


def load_barcodes(path: str = PATH) -> list:
    """Barcodes of an EDITTAG-format file (the sequence after the colon)."""
    with open(path) as fh:
        return [ln.split(":")[1].strip() for ln in fh if ":" in ln]


if __name__ == "__main__":
    for path, n, k, title in SETS:
        with open(path, "w") as fh:
            fh.write(file_text(generate_barcodes(n, k), title))
