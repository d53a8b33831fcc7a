"""The Baum-Welch E-step's forward recurrence and posterior mass on a torch
device: ``fwd_step`` of ``tagdust_tpu/parallel/mesh.py:_expected_lattice_counts``
(:293-311) in the port's stack convention (slot ``k + 1`` of K1's stack is
the JAX stack's slot ``k``: the carry after positions k+1..Lp-1).

* ``forward_counts_plain`` — the plain PyTorch version: per position, the
  reads sorted by base, and per base the gathers, products and
  ``index_add_`` over the non-zero entries of ``A[c]``; Kahan sums over the
  positions;
* ``forward_counts_cuda`` — the hand-written kernel ``td_estep``
  (``csrc/estep.cu``): a persistent grid of thread block clusters, each
  block holding a range of the states (their carries, the entries into
  them and each entry's f64 sum) in shared memory, a cluster walking read
  tiles; the sums are written once per cluster and summed in cluster
  order, so two launches give the same bits;
* ``forward_counts`` — the wrapper: the kernel for CUDA tensors, the plain
  version for CPU tensors, nothing in between.

The tables are ``parallel.mesh.count_tables``: the per-base ``edges``
(src, dst, val) the plain version reads and ``estep``, the kernel's entry
table (``tables.estep_tables``).  Both write the transition mass in the
same flat order (``off``).  ``geometry`` chooses the kernel's cluster and
tile for a lattice and a card's shared memory; ``launch_plan`` splits the
entry table over the cluster (``tables.estep_slices``) once per device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scan
from .fused_kernel import LAUNCHES, _stream
from .tables import (carry_offset, estep_block_bytes, estep_slices, estep_state_bytes,
                     estep_tables, slice_bounds)

_TABLE = ("dst_ptr", "dst", "ent_ptr", "flat")
_SLICES = ("t0", "ent_off", "item_off", "ibase", "nheavy", "ient", "idst", "ekey",
           "eval", "eidx", "halo_off", "halo", "push_off", "push")
# the blocks of a cluster, smallest first; the reads of a tile, at most
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_READS = 32
# csrc/estep.cu's bound on the step kernel's static shared memory
STATIC_SMEM = 3584


def split(et: dict, S: int, C: int, R: int) -> np.ndarray:
    """[C+1] the states of C blocks at R reads, balanced by the shared bytes
    each block holds: ``tables.estep_state_bytes``, then a few rounds in
    which each block's halo rows (``tables.estep_block_bytes``, which the
    first split fixes) are spread over its states' weights."""
    sb = estep_state_bytes(et, S, R | 1).astype(np.float64)
    t0 = slice_bounds(sb, C)
    for _ in range(4):
        width = np.diff(t0)
        halo = estep_block_bytes(et, S, t0, R | 1) - np.add.reduceat(sb, t0[:-1])
        t0 = slice_bounds(sb + np.repeat(halo / width, width), C)
    return t0


def _fit(et: dict, S: int, C: int, R: int, optin: int):
    """(bounds, dynamic bytes a block) of C blocks at R reads, or None where
    a block's bytes exceed ``optin``, a carry's rows 2^16 words or a block's
    entries 2^16 (the 16-bit source rows and entry offsets)."""
    t0 = split(et, S, C, R)
    smem = -(-int(estep_block_bytes(et, S, t0, R | 1).max()) // 16) * 16
    dst_of = np.repeat(et["dst"], np.diff(et["ent_ptr"]))
    if (carry_offset(S, R | 1) >= 1 << 16
            or np.bincount(np.searchsorted(t0, dst_of, "right") - 1).max() >= 1 << 16):
        return None
    return (t0, smem) if STATIC_SMEM + smem <= optin else None


def geometry(et: dict, S: int, optin: int) -> dict:
    """``td_estep``'s geometry for the entry table ``et`` of S states on a
    card whose blocks hold ``optin`` bytes of shared memory
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``): C, the smallest cluster
    size at which R = 32 reads fit, else C = 8 with the largest R that
    does; the states split by their bytes (``split``).  -> {C, R, P (a
    carry row, R | 1), smem (dynamic bytes a block), t0}.  Raises where no
    geometry fits."""
    for C, R in [(C, MAX_READS) for C in CLUSTER_SIZES] + [
            (CLUSTER_SIZES[-1], R) for R in range(MAX_READS - 1, 0, -1)]:
        fit = _fit(et, S, C, R, optin)
        if fit is not None:
            t0, smem = fit
            return {"C": C, "R": R, "P": R | 1, "smem": smem, "t0": t0}
    raise RuntimeError(
        f"the lattice of {S} states and {et['src'].size} entries does not fit "
        f"td_estep: one read's carries and the entry table over "
        f"{CLUSTER_SIZES[-1]} blocks exceed {optin} bytes of shared memory a block")


def optin_bytes(dev) -> int:
    """The shared memory a block of the card ``dev`` can hold."""
    from .build import lib

    with torch.cuda.device(dev):
        return int(lib().td_estep_optin())


def launch_clusters(g: dict, dev) -> int:
    """The clusters of geometry ``g`` that the card ``dev`` holds at once
    (``cudaOccupancyMaxActiveClusters``): the persistent grid.  Raises
    where the card takes none."""
    from .build import lib

    with torch.cuda.device(dev):
        n = int(lib().td_estep_clusters(g["C"], g["smem"]))
    if n < 1:
        raise RuntimeError(
            f"td_estep: the card holds no cluster of {g['C']} blocks with "
            f"{g['smem']} bytes of shared memory each (cudaError {-n})")
    return n


def clusters(engine) -> int:
    """The clusters ``td_estep`` launches for the engine's lattice on its
    card (the rows of its f64 partials), kept on the engine per device."""
    cache = engine.__dict__.setdefault("_estep_clusters", {})
    if engine.device not in cache:
        et = estep_tables(np.asarray(engine.lat.A, dtype=np.float32))
        g = geometry(et, int(engine.lat.S), optin_bytes(engine.device))
        cache[engine.device] = launch_clusters(g, engine.device)
    return cache[engine.device]


def launch_plan(tab: dict, dev) -> dict:
    """The geometry of ``td_estep`` for ``tab`` (``count_tables``) on the
    card ``dev``, its clusters and the sliced entry table on the card,
    built once and kept in ``tab``."""
    plans = tab.setdefault("plans", {})
    if dev not in plans:
        et = {k: v.cpu().numpy() for k, v in tab["estep"].items()}
        g = geometry(et, int(tab["S"]), optin_bytes(dev))
        g["clusters"] = launch_clusters(g, dev)
        sl = estep_slices(et, int(tab["S"]), g["t0"], g["P"])
        g["slices"] = {n: torch.from_numpy(np.ascontiguousarray(sl[n])).to(dev)
                       for n in _SLICES}
        plans[dev] = g
    return plans[dev]


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
               **{n: (et[n], torch.int32) for n in _TABLE}}
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
    g = launch_plan(tab, dev)
    # the tiles take the reads longest first, so that a tile walks about as
    # many positions as each of its reads has (a stable sort: the same
    # tiles, so the same sums, at every launch)
    order = torch.argsort(lens, descending=True, stable=True).to(torch.int32)
    mass = torch.empty(nnz, dtype=torch.float32, device=dev)
    E = torch.zeros((5, S), dtype=torch.float32, device=dev)
    # every cluster writes its whole row
    part = torch.empty((g["clusters"], nnz), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = L.td_estep(
            seqs.data_ptr(), lens.data_ptr(), order.data_ptr(), bstack.data_ptr(),
            blstack.data_ptr(),
            logpb.data_ptr(), *(et[n].data_ptr() for n in _TABLE),
            *(g["slices"][n].data_ptr() for n in _SLICES),
            part.data_ptr(), mass.data_ptr(), E.data_ptr(), B, Lp, S,
            int(tab["begin"]), nnz, int(et["dst"].shape[0]), g["C"], g["R"], g["P"],
            g["smem"], g["clusters"], _stream(dev))
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
