"""Baum-Welch training (the reference's MODE_TRAIN) over local shards.

The counterpart of ``tagdust_tpu/parallel/mesh.py:_expected_lattice_counts``
and ``DistributedTrainer`` (per-thread count merge
``copy_estimated_parameter``, barcode_hmm.c:5694-5744, reduced at
:1977-1992):

* ``_expected_lattice_counts`` is the E-step in lattice state space.  It
  reads K1's stack (``FusedScorer.backward``: ``td_bwd`` on the card, its
  plain version ``scan.backward_pass`` on CPU tensors), so the counts see
  the backward values that production scores see, and runs no second
  backward recurrence.  The forward recurrence and the counts are torch
  ops over the non-zero entries of the step matrix ``A[c]`` that each
  read's base selects: per base, the reads whose base it is, gathered at
  the entries' (src, dst) and summed over reads.  Nothing is multiplied
  over the one-hot expansion of the carry or over A[c]'s zeros;
* ``DistributedTrainer`` cuts a batch into contiguous shards, one per
  entry of ``devices`` (every entry the engine's device: shards across
  cards come with several GPUs), and sums the shards' counts in shard
  order: ``psum``'s counterpart over local shards.  Each shard is cut
  into sub-batches whose buffers, its reads included, stay inside
  ``CudaEngine.STACK_BYTES`` (``estep_bytes``): a sub-batch's reads go up
  to the card only when it runs.

Sums over positions, sub-batches and shards are Kahan-compensated f32, as
in the JAX package.  Every product runs in full float32 (TF32 off).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..engine import scan

# seconds spent since the last reset by DistributedTrainer calls: K1 (the
# backward recurrence and its stack), the E-step (the forward recurrence
# and the counts) and the host mapping of expected_segment_counts
TIMINGS = {"backward_s": 0.0, "estep_s": 0.0, "map_s": 0.0}


class Kahan:
    """Compensated float32 running sum.  A plain f32 sum drops an increment
    once the sum is past about 2^24 times it: tens of millions of emitted
    bases, the scale of a training run."""

    def __init__(self, shape, device):
        self.sum = torch.zeros(shape, dtype=torch.float32, device=device)
        self.comp = torch.zeros_like(self.sum)

    def add(self, inc: torch.Tensor) -> None:
        y = inc - self.comp
        t = self.sum + y
        self.comp = (t - self.sum) - y
        self.sum = t


def count_tables(lat, device) -> dict:
    """The non-zero entries of each base's step matrix ``A[c]`` (``lat.A``
    as float32, the values the JAX package reads under its default x32):
    per base ``(src, dst, val)`` on ``device`` (int64, int64, f32), and
    ``off``, the offsets of each base's entries in the flat transition
    mass."""
    A = np.asarray(lat.A, dtype=np.float32)
    edges, off = [], [0]
    for c in range(5):
        s, t = np.nonzero(A[c])
        edges.append((torch.from_numpy(s.astype(np.int64)).to(device),
                      torch.from_numpy(t.astype(np.int64)).to(device),
                      torch.from_numpy(np.ascontiguousarray(A[c, s, t])).to(device)))
        off.append(off[-1] + int(s.size))
    return {"S": int(lat.S), "begin": int(lat.begin), "edges": edges, "off": off}


def estep_bytes(engine, B: int, Lp: int) -> int:
    """Device bytes of one E-step over B reads padded to Lp: K1's stack and
    log scales ((Lp+1) * (S+1) * 4 a read), logP, the reads, their codes and
    order by base (int64), the carries and scales, and the worst case of the
    per-base temporaries (every read under the base with the most entries,
    nnz): the gathered flows, backward values and their product (3 nnz
    floats), and the carry, backward values and new carry sorted by base
    and the new carry in read order (4 S)."""
    S = engine.lat.S
    nnz = max(int(np.count_nonzero(engine.lat.A[c])) for c in range(5))
    per_read = ((Lp + 1) * (S + 1) * 4 + 4 + Lp + 4 + 16 * Lp
                + 4 * (2 * S + 4) + 4 * (3 * nnz + 4 * S))
    return B * per_read


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _forward_counts(tab: dict, seqs, lens, bstack, blstack, logpb,
                    ct: Kahan, e: Kahan) -> None:
    """The forward recurrence of one batch (``fwd_step``, mesh.py:293-311
    of the JAX package), adding its transition mass per entry into ``ct``
    and its emission mass [5, S] into ``e``.  Slot ``k + 1`` of the port's
    stack is the JAX stack's slot ``k``: the carry after positions
    k+1..Lp-1."""
    torch.backends.cuda.matmul.allow_tf32 = False
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


def _dense(tab: dict, flat: torch.Tensor) -> torch.Tensor:
    """[5, S, S] from the flat per-entry transition mass."""
    S, off = tab["S"], tab["off"]
    CT = torch.zeros((5, S, S), dtype=torch.float32, device=flat.device)
    for c, (src, dst, _) in enumerate(tab["edges"]):
        CT[c, src, dst] = flat[off[c] : off[c + 1]]
    return CT


def _expected_lattice_counts(engine, seqs: torch.Tensor, lens: torch.Tensor,
                             stack=None, tables=None):
    """Baum-Welch expectations in lattice state space of the reads ``seqs``
    [B, Lp] uint8 / ``lens`` [B] int32 -> (CT [5, S, S] f32, E [5, S] f32,
    n) on the engine's device: the posterior transition mass per (base,
    src, dst), the posterior emission mass per (base, state), and the bases
    scored, sum(lens).  E.sum() == CT.sum() == n: every emitted base carries
    mass 1 and crosses one A[c] edge.

    The reads, on the host or on the engine's device, run in sub-batches
    whose buffers stay inside the engine's STACK_BYTES (``estep_bytes``),
    each moved to the device, then K1 (``engine.scorer.backward``), then the
    forward recurrence; the Kahan sums run on across sub-batches.  With
    ``stack`` (K1's ``(bstack, blstack, logpb)`` of these reads, e.g.
    computed on the card and copied to the host) K1 is not run, the batch
    is not cut, and the counts are taken on the reads' device.  ``tables``:
    ``count_tables`` on that device."""
    dev = seqs.device if stack is not None else engine.device
    tab = tables if tables is not None else count_tables(engine.lat, dev)
    ct = Kahan(tab["off"][-1], dev)
    e = Kahan((5, tab["S"]), dev)
    n = lens.long().sum().to(dev)
    if stack is not None:
        _forward_counts(tab, seqs, lens, *stack, ct, e)
        return _dense(tab, ct.sum), e.sum, n
    B, Lp = seqs.shape
    step = engine.STACK_BYTES // estep_bytes(engine, 1, Lp)
    if step == 0:
        raise RuntimeError(
            f"a read padded to {Lp}nt needs {estep_bytes(engine, 1, Lp)} bytes of "
            f"E-step buffers, over the {engine.STACK_BYTES}-byte budget "
            "(CudaEngine.STACK_BYTES)")
    for s in range(0, B, step):
        sq, ln = seqs[s : s + step].to(dev), lens[s : s + step].to(dev)
        t0 = time.perf_counter()
        stack = engine.scorer.backward(sq, ln)
        _sync(dev)
        t1 = time.perf_counter()
        _forward_counts(tab, sq, ln, *stack, ct, e)
        del stack
        _sync(dev)
        TIMINGS["backward_s"] += t1 - t0
        TIMINGS["estep_s"] += time.perf_counter() - t1
    return _dense(tab, ct.sum), e.sum, n


def _same(d: torch.device, e: torch.device) -> bool:
    return d.type == e.type and (d.index is None or e.index is None or d.index == e.index)


class DistributedTrainer:
    """MODE_TRAIN over local shards: per-shard Baum-Welch expected counts in
    lattice space, summed in shard order.

    ``devices`` (default ``[engine.device]``) names one device per shard;
    every one must be the engine's, so an engine built for the card trains
    on the card and nowhere else (no fallback to the CPU), and one built
    for ``"cpu"`` trains on the CPU through the plain K1.  Shards run in
    turn."""

    def __init__(self, engine, devices=None):
        devices = [torch.device(d) for d in (devices or [engine.device])]
        for d in devices:
            if not _same(d, engine.device):
                raise ValueError(f"a shard on {d}, the engine on {engine.device}")
        if engine.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: an engine built for the card "
                               "trains on the card")
        self.engine = engine
        self.shards = len(devices)
        self.tables = count_tables(engine.lat, engine.device)

    def run(self, seqs: np.ndarray, lens: np.ndarray):
        """-> (CT [5, S, S] f32, E [5, S] f32, total) as numpy: the counts of
        ``seqs`` [B, Lp] / ``lens`` [B], padded to a multiple of the shard
        count with zero-length reads and cut into contiguous shards.  The
        reads stay on the host until their sub-batch runs."""
        n = self.shards
        pad = (-seqs.shape[0]) % n
        if pad:
            seqs = np.concatenate([seqs, np.zeros((pad, seqs.shape[1]), seqs.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
        per = seqs.shape[0] // n
        dev = self.engine.device
        CT = E = None
        total = 0
        for i in range(n):
            part = slice(i * per, (i + 1) * per)
            s = torch.from_numpy(np.ascontiguousarray(seqs[part], np.uint8))
            ln = torch.from_numpy(np.ascontiguousarray(lens[part], np.int32))
            ct, e, m = _expected_lattice_counts(self.engine, s, ln, tables=self.tables)
            if CT is None:
                CT, E = Kahan(ct.shape, dev), Kahan(e.shape, dev)
            CT.add(ct)
            E.add(e)
            total += int(m)
        return CT.sum.cpu().numpy(), E.sum.cpu().numpy(), total

    def expected_segment_counts(self, seqs: np.ndarray, lens: np.ndarray):
        """The whole MODE_TRAIN E-step: the counts of ``run``, mapped back to
        the reference's per-segment count arrays (``train.Counts``); feed
        them to ``engine.train.reestimate``."""
        from ..engine.train import lattice_counts_to_counts

        CT, E, _ = self.run(seqs, lens)
        t0 = time.perf_counter()
        out = lattice_counts_to_counts(self.engine.mb, CT, E)
        TIMINGS["map_s"] += time.perf_counter() - t0
        return out
