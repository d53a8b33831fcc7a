"""The port's benches, each a module run with ``python -m``:

* ``kernels``: kernel-pipeline reads/s of the flagship (``CudaEngine._full``
  in a pipeline of batches on the card), the counterpart of ``bench.py``;
* ``e2e``: CLI reads/s with a split per stage, the counterpart of
  ``bench_e2e.py``;
* ``multichip``: ``ShardedScorer`` reads/s at 1/2/4/8 shards, the
  counterpart of ``bench_multichip.py``.

Each runs on the card and exits non-zero without one, unless ``--device
cpu`` asks for the plain versions on the CPU.  Each JSON line it prints
names the card it ran on and its power limit (``card``).
"""

from __future__ import annotations

import subprocess

import torch


def card(device: torch.device) -> dict:
    """``{"device": name, "power_limit_w": W}`` of the card ``device`` is on,
    as ``nvidia-smi --query-gpu=name,power.limit`` gives them
    (``{"device": "cpu", "power_limit_w": None}`` on the CPU)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    name, limit = out[min(index, len(out) - 1)].rsplit(",", 1)
    return {"device": name.strip(), "power_limit_w": float(limit.split()[0])}
