"""Batched Myers bit-parallel edit distance on a torch device.

The counterpart of ``tagdust_tpu/engine/myers_tpu.py``: the best substring
edit distance of every read (the pattern, at most 63 symbols) in a shared
contaminant text, one lane per read (``filters._bpm_batch``,
``misc.c:718-765``).  Patterns are capped at 63 symbols; spacer symbols skip
the match masks but occupy bit positions.

* ``bpm_batch_plain`` — the plain PyTorch version: ``int64`` lanes (their
  two's-complement wrap-around of ``+`` and ``<<`` is the host's uint64
  arithmetic, and the hit tests are ``(HP & mask) != 0``, so no logical right
  shift is needed), one Python step per text symbol;
* ``bpm_batch_cuda`` — the hand-written kernel ``td_myers``
  (``csrc/myers.cu``): one thread per (read, text, orientation), the state in
  registers over the whole text;
* ``bpm_batch`` — the wrapper: the kernel for CUDA tensors, the plain version
  for CPU tensors, nothing in between;
* ``reference_hits_device`` — the artifact filter's loop over contaminants
  and orientations on one device: the pattern masks go up once per chunk and
  only ``hit`` and ``best_id`` come back.

A lane with ``m < 1`` (an empty read) runs as ``m = 1`` in both versions:
its distance is defined and ``reference_hits_device`` masks it with
``lens > 0``.  Integers throughout, so kernel and plain version agree
exactly.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import scan
from .fused_kernel import LAUNCHES, _stream

# bytes of the distances one launch may write ([contaminants, 2, B] int32);
# more contaminants than fit go in further launches
K_BYTES = 1 << 30
# the kernel's grid takes one (text, orientation) job per blockIdx.y
MAX_JOBS = 65535


def masks_tensor(B4: np.ndarray, device) -> torch.Tensor:
    """uint64 pattern masks ``[..., B, 4]`` (``filters._pattern_masks``) as an
    int64 tensor of the same bits on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(B4).view(np.int64))
    return t.to(device)


def text_tensors(texts: Sequence[np.ndarray], device):
    """(text uint8 [sum T], offs int32 [C + 1]): the texts end to end."""
    offs = np.zeros(len(texts) + 1, dtype=np.int32)
    offs[1:] = np.cumsum([t.shape[0] for t in texts])
    flat = (np.concatenate([np.asarray(t, dtype=np.uint8) for t in texts])
            if offs[-1] else np.zeros(0, dtype=np.uint8))
    return torch.from_numpy(flat).to(device), torch.from_numpy(offs).to(device)


def bpm_batch_plain(text, B4, m, device=None) -> torch.Tensor:
    """Best distance ``k`` [B] int32 of each pattern (rows of ``B4`` [B, 4],
    lengths ``m`` [B]) in one text [T]: the plain version, on ``device`` (or
    where ``B4`` lies)."""
    if isinstance(B4, np.ndarray):
        B4 = masks_tensor(B4, device or "cpu")
    elif device is not None:
        B4 = B4.to(device)
    dev = B4.device
    if dev.type == "cuda":
        scan.PLAIN_CUDA_CALLS["count"] += 1
    m = torch.as_tensor(m).to(dev).long().clamp(1, 63)
    text = np.asarray(text.cpu() if isinstance(text, torch.Tensor) else text)
    mask = torch.ones_like(m) << (m - 1)
    VP = ~(torch.full_like(m, -1) << m)
    VN = torch.zeros_like(m)
    diff = m.clone()
    k = m.clone()
    cols = [B4[:, c].contiguous() for c in range(4)]
    for t in text:
        X = cols[int(t) & 0x3] | VN
        D0 = ((VP + (X & VP)) ^ VP) | X
        HN = VP & D0
        HP = VN | ~(VP | D0)
        X = HP << 1
        VN = X & D0
        VP = (HN << 1) | ~(X | D0)
        diff = diff + ((HP & mask) != 0).long() - ((HN & mask) != 0).long()
        k = torch.minimum(k, diff)
    return k.int()


def bpm_batch_cuda(text: torch.Tensor, offs: torch.Tensor, B4: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    """``td_myers``: ``k`` [C, n_orient, B] int32 for the texts ``text``
    (uint8, end to end, ``offs`` [C + 1] int32), the masks ``B4`` [n_orient,
    B, 4] int64 and the lengths ``m`` [B] int32, all on one CUDA device."""
    from .build import check, lib

    want = {"text": torch.uint8, "offs": torch.int32, "B4": torch.int64,
            "m": torch.int32}
    for name, t in (("text", text), ("offs", offs), ("B4", B4), ("m", m)):
        if not t.is_cuda or t.device != B4.device:
            raise ValueError(f"{name} on {t.device}, masks on {B4.device}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B4.dim() != 3 or B4.shape[2] != 4 or m.shape != (B4.shape[1],):
        raise ValueError(
            f"masks {tuple(B4.shape)} / lengths {tuple(m.shape)}: want "
            "[n_orient, B, 4] and [B]"
        )
    n_orient, B = int(B4.shape[0]), int(B4.shape[1])
    C = int(offs.shape[0]) - 1
    if C < 1 or C * n_orient > MAX_JOBS or B < 1:
        raise ValueError(f"{C} texts x {n_orient} orientations over {B} reads")
    k = torch.empty((C, n_orient, B), dtype=torch.int32, device=B4.device)
    with torch.cuda.device(B4.device):
        err = lib().td_myers(text.data_ptr() if text.numel() else None,
                             offs.data_ptr(), C, B4.data_ptr(), n_orient,
                             m.data_ptr(), k.data_ptr(), B, _stream(B4.device))
    check(err, "td_myers")
    LAUNCHES["myers"] += 1
    return k


def bpm_batch(texts: List[np.ndarray], B4: torch.Tensor,
              m: torch.Tensor) -> torch.Tensor:
    """``k`` [C, n_orient, B] int32 where ``B4`` lies: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if B4.is_cuda:
        text, offs = text_tensors(texts, B4.device)
        return bpm_batch_cuda(text, offs, B4.contiguous(), m.int().contiguous())
    return torch.stack([
        torch.stack([bpm_batch_plain(t, B4[o], m) for o in range(B4.shape[0])])
        for t in texts
    ])


def reference_hits_device(fwdB4: np.ndarray, revB4: np.ndarray, lens: np.ndarray,
                          contaminants: List[np.ndarray], error_cut: int,
                          device):
    """(hit [B] bool, best_id [B] int64) as ``filters._reference_hits`` gives
    them: contaminants in file order, forward before reverse-complement, a
    strictly smaller distance wins (so the first of equals keeps the id),
    ``best_id`` 1-based, ``hit = (best <= error_cut) & (lens > 0)``."""
    dev = torch.device(device)
    B = int(lens.shape[0])
    B4 = masks_tensor(np.stack([fwdB4, revB4]), dev)
    m = torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32)).to(dev)
    n_jobs = 2 * len(contaminants)
    per = max(min(K_BYTES // (8 * max(B, 1)), MAX_JOBS // 2), 1)
    best_key = None
    for c0 in range(0, len(contaminants), per):
        k = bpm_batch(contaminants[c0 : c0 + per], B4, m)
        # distance and job index in one key: its minimum is the smallest
        # distance at the first job that reaches it
        job = torch.arange(2 * c0, 2 * c0 + k.shape[0] * 2, device=dev)
        key = (k.reshape(-1, B).long() * n_jobs + job[:, None]).min(dim=0).values
        best_key = key if best_key is None else torch.minimum(best_key, key)
    best = best_key // n_jobs
    best_id = (best_key % n_jobs) // 2 + 1
    hit = (best <= int(error_cut)) & (m > 0)
    return hit.cpu().numpy(), best_id.cpu().numpy()
