"""Decided-mode epilogue: the extraction decisions, computed on the device.

Torch-op port of ``tagdust_tpu/engine/tpu.py``: ``dust_scores_device``,
``unpack_nibbles_device``, ``_get_pallas_decided.full_decided`` and
``collect_pallas_decided``.  One uint8 row per read, byte for byte the
layout the shared host code (``extract.apply_device_decisions``) parses::

    keep_bits[Lp/8] | read_type[1] | bar_mem i32[4] | fp_lo u32[4] |
    fp_hi u32[4] | q f32[4] | dust f32[8]          (Lp/8 + 25 bytes)

Keep bits are big-endian within each byte (np.unpackbits order).  Integer
fields are assembled from int64 intermediates byte by byte (little-endian),
so the rows do not depend on torch's unsigned-integer support.

The device functions build no tensor from host data (their constants come
in the engine's tables, built once): such a tensor is a synchronous copy,
which on the card would hold a window's dispatch until its kernels end
(``tests/test_torch_dispatch_sync.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (
    EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
    EXTRACT_FAIL_BAR_FINGER_NOT_FOUND,
    EXTRACT_FAIL_READ_TOO_SHORT,
    EXTRACT_SUCCESS,
)


def pack_nibbles(seqs: np.ndarray) -> np.ndarray:
    """[B, Lp] codes (0-5) -> [B, Lp/2] uint8: base 2k in the low nibble,
    2k+1 in the high one (tpu.py pack_nibbles)."""
    return (seqs[:, 0::2] | (seqs[:, 1::2] << 4)).astype(np.uint8)


def unpack_nibbles(sp: torch.Tensor, Lp: int) -> torch.Tensor:
    """Device inverse of ``pack_nibbles``: [B, Lp/2] -> [B, Lp] uint8."""
    return torch.stack([sp & 0xF, sp >> 4], dim=2).reshape(sp.shape[0], Lp)


def dust_scores(seqs, labels, lens, is_r_label) -> torch.Tensor:
    """DUST over the first-64nt window, both variants per read as [B, 2] f32:
    column 0 on the extracted sequence (non-R bases are spacers), column 1
    on the raw sequence (filters._dust_scores_core, barcode_hmm.c:2424)."""
    B, Lp = seqs.shape
    W = 64
    dev = seqs.device
    pos = torch.arange(W, device=dev)[None, :]
    lens = lens.long()
    ln = torch.clamp_max(lens, W)[:, None]
    seqs = seqs.long()
    labels = labels.long()
    if Lp >= W:
        arr = seqs[:, :W]
        lab = labels[:, 1 : W + 1]
    else:
        arr = F.pad(seqs, (0, W - Lp))
        lab = F.pad(labels, (0, W - Lp))[:, 1 : W + 1]
    non_r = (~is_r_label)[torch.clamp(lab, 0, is_r_label.shape[0] - 1)]
    beyond = pos >= ln
    b2 = arr & 3
    key = torch.zeros((B, W), dtype=torch.long, device=dev)
    key[:, 2:] = (b2[:, 2:] << 4) | (b2[:, 1:-1] << 2) | b2[:, :-2]

    def first_true(m, default):
        return torch.where(m.any(dim=1), torch.argmax(m.int(), dim=1), default)

    def one(is_sp):
        lead = first_true(~is_sp, ln[:, 0])
        degenerate = (lead + 1) >= lens
        after = pos >= (lead + 2)[:, None]
        first_sp = first_true(is_sp & after, torch.full_like(lead, W))
        counted = after & (pos < first_sp[:, None])
        idx = torch.where(counted, key, torch.full_like(key, W))
        c = torch.zeros((B, W + 1), dtype=torch.float32, device=dev)
        c = c.scatter_add_(1, idx, torch.ones_like(c[:, :W]))[:, :W]
        s = torch.sum(c * (c - 1.0) * 0.5, dim=1)
        c_final = lead.float() + 2.0 + counted.sum(dim=1).float()
        denom = torch.where(
            c_final == 3.0, torch.full_like(c_final, float("nan")), c_final - 3.0
        )
        return torch.where(degenerate, torch.zeros_like(s), s / denom * 10.0)

    return torch.stack([one(non_r | beyond), one(beyond)], dim=1)


def _le_bytes(x: torch.Tensor) -> torch.Tensor:
    """[B] int64 -> [B, 4] uint8: the low 32 bits, little-endian."""
    return torch.stack([(x >> (8 * i)) & 0xFF for i in range(4)], dim=1).to(
        torch.uint8
    )


def decided_rows(seqs, lens, labels, q, thr32, minlen: int, T: dict,
                 rfl: int) -> torch.Tensor:
    """Per-read extraction decisions (extract_reads' decision tree,
    barcode_hmm.c:3203-3304) on the label path, packed into rows.

    ``T`` holds label-indexed device tables: ``is_R``, ``is_B``, ``is_F``,
    ``null_b``, ``alt``, ``seg`` and ``is_r_full`` (the DUST spacer mask),
    and ``bitw``, the keep bits' weights 128, 64, ..., 1 (int64).
    ``thr32`` is the f32-ceiled threshold, so ``q >= thr32`` decides like
    the host's float64 compare."""
    B, Lp = seqs.shape
    dev = seqs.device
    seqs = seqs.long()
    lens = lens.long()
    dust = dust_scores(seqs, labels, lens, T["is_r_full"])
    nlab = T["seg"].shape[0]
    labd = torch.clamp(labels[:, 1:].long(), 0, nlab - 1)
    pos = torch.arange(Lp, device=dev)[None, :]
    valid = pos < lens[:, None]
    keep = T["is_R"][labd]
    tR = keep & valid
    tB = T["is_B"][labd] & valid
    tF = T["is_F"][labd] & valid

    keep_bytes = (keep.reshape(B, Lp // 8, 8).long() * T["bitw"]).sum(dim=2)

    passed = q >= float(thr32)  # NaN -> False, like the host compare
    fingerlen = tF.sum(dim=1)
    has_b = tB.any(dim=1)
    last_b = torch.where(
        has_b, Lp - 1 - torch.argmax(tB.flip(1).int(), dim=1), torch.zeros_like(lens)
    )
    lab_last = labd.gather(1, last_b[:, None])[:, 0]
    neg = torch.full_like(lens, -1)
    bar = torch.where(has_b, T["alt"][lab_last].long(), neg)
    mem = torch.where(has_b, T["seg"][lab_last].long(), neg)
    hb = torch.where(
        has_b, torch.where(T["null_b"][lab_last], neg, -neg), torch.zeros_like(lens)
    )

    # too short: every maximal R run must reach minlen
    idxs = pos.expand(B, Lp)
    last_nonr = torch.cummax(torch.where(tR, -1, idxs), dim=1).values
    runlen = idxs - last_nonr
    nxt = F.pad(tR[:, 1:], (0, 1))
    too_short = (tR & ~nxt & (runlen < minlen)).any(dim=1)

    # fingerprint key: 2-bit packed F bases, two 32-bit halves
    if rfl and rfl <= 27:
        shift = 2 * (fingerlen[:, None] - torch.cumsum(tF.long(), dim=1))
        bits = seqs[:, :Lp] & 3
        lo = torch.where(
            tF & (shift < 32), bits << torch.clamp(shift, 0, 31), 0
        ).sum(dim=1)
        hi = torch.where(
            tF & (shift >= 32), bits << torch.clamp(shift - 32, 0, 31), 0
        ).sum(dim=1)
    else:
        lo = hi = torch.zeros_like(lens)

    finger_ok = fingerlen == rfl
    if rfl:
        core = torch.where(
            hb == 1, finger_ok & (bar != -1), (hb == 0) & finger_ok
        )
    else:
        core = torch.where(hb == 1, bar != -1, hb == 0)
    success = passed & ~too_short & core
    read_type = torch.where(
        passed,
        torch.where(
            too_short,
            EXTRACT_FAIL_READ_TOO_SHORT,
            torch.where(success, EXTRACT_SUCCESS, EXTRACT_FAIL_BAR_FINGER_NOT_FOUND),
        ),
        EXTRACT_FAIL_ARCHITECTURE_MISMATCH,
    )
    bar_mem = torch.where(success & (hb == 1), (mem << 16) | bar, neg)
    return torch.cat(
        [
            keep_bytes.to(torch.uint8),
            read_type.to(torch.uint8)[:, None],
            _le_bytes(bar_mem),
            _le_bytes(lo),
            _le_bytes(hi),
            q.to(torch.float32).contiguous().view(torch.uint8).reshape(B, 4),
            dust.contiguous().view(torch.uint8).reshape(B, 8),
        ],
        dim=1,
    )


def collect_decided(rows: np.ndarray, n: int, Lp: int) -> dict:
    """Parse one fetched window of rows back to host arrays
    (tpu.py collect_pallas_decided)."""
    a = np.asarray(rows)[:n]
    kb = Lp // 8
    keep = np.unpackbits(np.ascontiguousarray(a[:, :kb]), axis=1).astype(bool)

    def field(at, dt):
        return np.ascontiguousarray(a[:, at : at + 4]).view(dt)[:, 0]

    lo = field(kb + 5, np.uint32)
    hi = field(kb + 9, np.uint32)
    sc = np.ascontiguousarray(a[:, kb + 13 : kb + 25]).view(np.float32)
    return {
        "keep": keep,
        "read_type": a[:, kb].astype(np.int64),
        "bar_mem": field(kb + 1, np.int32),
        "fp_key": (hi.astype(np.int64) << 32) | lo.astype(np.int64),
        "mapq": sc[:, 0],
        "dust": sc[:, 1:3],
    }
