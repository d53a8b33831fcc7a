"""The Baum-Welch E-step's forward recurrence and posterior mass on a torch
device: ``fwd_step`` of ``tagdust_tpu/parallel/mesh.py:_expected_lattice_counts``
(:293-311) in the port's stack convention (slot ``k + 1`` of K1's stack is
the JAX stack's slot ``k``: the carry after positions k+1..Lp-1).

* ``forward_counts_plain`` — the plain PyTorch version: per position, the
  reads sorted by base, and per base the gathers, products and
  ``index_add_`` over the non-zero entries of ``A[c]``; Kahan sums over the
  positions;
* ``forward_counts_cuda`` — the hand-written kernel ``td_estep``
  (``csrc/estep.cu``): a persistent block per SM walks read tiles with the
  carry in shared memory, reads each stack row once and keeps f64 partials
  per entry, summed in block order, so two launches give the same bits;
* ``forward_counts`` — the wrapper: the kernel for CUDA tensors, the plain
  version for CPU tensors, nothing in between.

The tables are ``parallel.mesh.count_tables``: the per-base ``edges``
(src, dst, val) the plain version reads and ``estep``, the kernel's entry
table (``tables.estep_tables``).  Both write the transition mass in the
same flat order (``off``).
"""

from __future__ import annotations

import torch

from . import scan
from .fused_kernel import LAUNCHES, _stream

_TABLE = ("dst_ptr", "dst", "ent_ptr", "src", "val", "flat")


def forward_counts_plain(tab: dict, seqs, lens, bstack, blstack, logpb,
                         ct, e) -> None:
    """The forward recurrence of one batch, adding its transition mass per
    entry into the Kahan sum ``ct`` and its emission mass [5, S] into
    ``e``, one position at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if seqs.is_cuda:
        scan.PLAIN_CUDA_CALLS["count"] += 1
    B, Lp = seqs.shape
    S, dev, off = tab["S"], seqs.device, tab["off"]
    codes = torch.clamp(seqs.long(), max=5)  # 5: no base, a zero one-hot row
    order = torch.argsort(codes, dim=0, stable=True)  # [B, Lp]: reads by base
    counts = torch.stack([(codes == c).sum(dim=0) for c in range(5)], dim=1)
    counts = counts.cpu().numpy()  # [Lp, 5], the one host sync of a batch
    v = torch.zeros((B, S), dtype=torch.float32, device=dev)
    v[:, tab["begin"]] = 1.0
    ls = torch.zeros(B, dtype=torch.float32, device=dev)
    for k in range(Lp):
        act = k < lens
        # clamped: on padded steps the stale scales can overflow the exp
        w = torch.exp(torch.clamp_max(ls + blstack[k + 1] - logpb, 60.0)) * act
        # the reads sorted by their base at k: each base's rows are contiguous
        perm = order[:, k]
        vs = v.index_select(0, perm)
        bws = bstack[k + 1].index_select(0, perm)
        ws = w.index_select(0, perm)
        vns = torch.zeros_like(v)
        inc_ct = torch.zeros(off[-1], dtype=torch.float32, device=dev)
        inc_e = torch.zeros((5, S), dtype=torch.float32, device=dev)
        end = 0
        for c in range(5):
            start, end = end, end + int(counts[k, c])
            if start == end:
                continue
            src, dst, val = tab["edges"][c]
            flow = vs[start:end].index_select(1, src) * val  # v[s] A[c][s, t]
            vns[start:end].index_add_(1, dst, flow)  # v A[c] over the entries
            mass = ws[start:end] @ (flow * bws[start:end].index_select(1, dst))
            inc_ct[off[c] : off[c + 1]] = mass
            # the emission mass at t is the transition mass into t
            inc_e[c].index_add_(0, dst, mass)
        ct.add(inc_ct)
        e.add(inc_e)
        vn = torch.empty_like(v)
        vn[perm] = vns
        vn, lm = scan._rescale(vn)
        v = torch.where(act[:, None], vn, v)
        ls = torch.where(act, ls + lm, ls)


def forward_counts_cuda(tab: dict, seqs: torch.Tensor, lens: torch.Tensor,
                        bstack: torch.Tensor, blstack: torch.Tensor,
                        logpb: torch.Tensor):
    """``td_estep``: (mass [nnz] f32 in ``count_tables``' flat order, E [5, S]
    f32) of one batch, ``seqs`` [B, Lp] uint8, ``lens`` [B] int32 and K1's
    ``bstack`` [Lp+1, B, S], ``blstack`` [Lp+1, B], ``logpb`` [B] float32, all
    on one CUDA device with the tables."""
    from .build import check, lib

    L = lib()
    dev = seqs.device
    S, nnz = int(tab["S"]), int(tab["off"][-1])
    et = tab["estep"]
    tensors = {"seqs": (seqs, torch.uint8), "lens": (lens, torch.int32),
               "bstack": (bstack, torch.float32), "blstack": (blstack, torch.float32),
               "logpb": (logpb, torch.float32),
               **{n: (et[n], torch.float32 if n == "val" else torch.int32)
                  for n in _TABLE}}
    for name, (t, dtype) in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} on {t.device}, reads on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Lp = seqs.shape
    if (tuple(lens.shape) != (B,) or tuple(bstack.shape) != (Lp + 1, B, S)
            or tuple(blstack.shape) != (Lp + 1, B) or tuple(logpb.shape) != (B,)):
        raise ValueError("lens / stack shapes do not match the batch")
    mass = torch.empty(nnz, dtype=torch.float32, device=dev)
    E = torch.zeros((5, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if L.td_estep_reads_per_tile(S) < 1:
            raise RuntimeError(
                f"the lattice of {S} states does not fit the card: one read's "
                "two carries in td_estep exceed a block's shared memory")
        G = torch.cuda.get_device_properties(dev).multi_processor_count
        part = torch.zeros((G, nnz), dtype=torch.float64, device=dev)
        err = L.td_estep(
            seqs.data_ptr(), lens.data_ptr(), bstack.data_ptr(), blstack.data_ptr(),
            logpb.data_ptr(), *(et[n].data_ptr() for n in _TABLE),
            part.data_ptr(), mass.data_ptr(), E.data_ptr(), B, Lp, S,
            int(tab["begin"]), nnz, int(et["dst"].shape[0]), G, _stream(dev))
    check(err, "td_estep")
    LAUNCHES["estep"] += 1
    return mass, E


def forward_counts(tab: dict, seqs, lens, bstack, blstack, logpb, ct, e) -> None:
    """One batch's transition mass into ``ct`` and emission mass into ``e``
    (Kahan sums) where the reads lie: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if seqs.is_cuda:
        mass, E = forward_counts_cuda(tab, *(x.contiguous() for x in (
            seqs, lens, bstack, blstack, logpb)))
        ct.add(mass)
        e.add(E)
    else:
        forward_counts_plain(tab, seqs, lens, bstack, blstack, logpb, ct, e)
