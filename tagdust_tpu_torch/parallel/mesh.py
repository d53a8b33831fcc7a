"""Data-parallel scoring over this process's cards, and Baum-Welch training
(the reference's MODE_TRAIN) over shards, cards and processes.

The counterpart of ``tagdust_tpu/parallel/mesh.py``: ``ShardedScorer``, the
E-step ``_expected_lattice_counts`` and ``DistributedTrainer`` (per-thread
count merge ``copy_estimated_parameter``, barcode_hmm.c:5694-5744, reduced
at :1977-1992):

* ``local_devices`` is this process's CUDA devices and nothing else: the
  JAX mesh takes the global ``jax.devices()`` (its ``make_mesh``), which
  under ``-multihost`` names other hosts' chips; the port does not copy
  that.  Under a process group the host's processes split its cards
  (``multihost.card_layout``);
* ``ShardedScorer`` cuts a window into contiguous shards of whole batch
  tiles, one per entry of its devices (a card may repeat), and dispatches
  each on its card (``CudaEngine.on``: the compiled model placed there)
  from one thread: the launches are asynchronous, so the cards overlap.
  The same per-read kernels run on every shard, so its rows are the
  one-engine rows.  Two shards on one card share this process's share of
  that card's ``STACK_BYTES`` (``per_card``; the runner divides
  ``CudaEngine.stack_budget`` by it);

* ``_expected_lattice_counts`` is the E-step in lattice state space.  It
  reads K1's stack (``FusedScorer.backward``: ``td_bwd`` on the card, its
  plain version ``scan.backward_pass`` on CPU tensors), so the counts see
  the backward values that production scores see, and runs no second
  backward recurrence.  The forward recurrence and the counts run over the
  non-zero entries of the step matrix ``A[c]`` that each read's base
  selects (``engine/estep.py``): the kernel ``td_estep`` on CUDA tensors,
  its plain version (torch ops per base and position) on CPU tensors.
  Nothing is multiplied over the one-hot expansion of the carry or over
  A[c]'s zeros;
* ``DistributedTrainer`` cuts a batch into contiguous shards, one per
  entry of ``devices`` (any of this process's cards, or the CPU for an
  engine built there), and sums the shards' counts in shard order on the
  first shard's device: ``psum``'s counterpart.  Under a
  ``torch.distributed`` group of several processes every process passes
  the same batch, process p takes the p-th contiguous block of shards,
  and the sums are ``all_reduce``d on the host (gloo).  Each shard is cut
  into sub-batches whose buffers, its reads included, stay inside this
  process's share of ``CudaEngine.STACK_BYTES`` (``estep_bytes`` of the
  shard's route, ``estep_reads``): a sub-batch's reads go up to the card
  only when it runs.

Sums over positions, sub-batches and shards are Kahan-compensated f32, as
in the JAX package.  Every product runs in full float32 (TF32 off).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from ..engine import estep
from ..engine.cuda import BatchResult, _indexed
from ..engine.estep import forward_counts
from ..engine.tables import estep_tables
from ..spans import span


def local_devices() -> list:
    """This process's CUDA devices, none without a card: every visible card
    without a process group, else this process's cards of its host's
    (``multihost.card_layout``)."""
    from .multihost import local_cards

    return [torch.device("cuda", i) for i in local_cards()[0]]


class ShardedScorer:
    """The engine's scorer over ``devices`` (the counterpart of the JAX
    ``ShardedScorer``, shard_map over a ``reads`` mesh axis): a window of
    B reads, B a multiple of ``n`` batch tiles, is cut into ``n`` contiguous
    shards, shard i scored on ``devices[i]`` by the engine placed there, and
    the rows come back in shard order, so they are the window's rows."""

    def __init__(self, engine, devices):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a ShardedScorer needs at least one device")
        for d in self.devices:
            if d.type != engine.device.type:
                raise ValueError(f"a shard on {d}, the engine on {engine.device}")
        self.engine = engine
        self.n = len(self.devices)
        self.engines = [engine.on(d) for d in self.devices]
        # the most shards on one card: each gets that card's budget / per_card
        self.per_card = max(Counter(self.devices).values())

    def shard_reads(self, Lp: int, budget: int, packed: bool = False) -> int:
        """The most reads of a shard whose launch, beside the other shards
        on its card, stays inside ``budget`` bytes of that card."""
        return self.engine.reads_within(Lp, budget // self.per_card, packed)

    def _shards(self, B: int):
        tile = self.engine.default_batch_tile()
        if B % (self.n * tile):
            raise ValueError(
                f"window {B} not a multiple of {self.n} shards x tile {tile}")
        per = B // self.n
        return [(eng, slice(i * per, (i + 1) * per))
                for i, eng in enumerate(self.engines)]

    def dispatch_decided(self, seqs: np.ndarray, lens: np.ndarray, thr32,
                         minlen: int) -> list:
        """``CudaEngine.dispatch_decided`` on every shard: the shards' rows
        on their devices, in shard order, without waiting."""
        return [eng.dispatch_decided(seqs[p], lens[p], thr32, minlen)
                for eng, p in self._shards(seqs.shape[0])]

    def dispatch_packed(self, seqs: np.ndarray, lens: np.ndarray) -> list:
        """``CudaEngine.dispatch_packed`` on every shard, in shard order."""
        return [eng.dispatch_packed(seqs[p], lens[p])
                for eng, p in self._shards(seqs.shape[0])]

    def run(self, seqs: np.ndarray, lens: np.ndarray, threshold: float = 0.0,
            want_labels: bool = True):
        """One-shot scoring: (``BatchResult`` of the ``len(seqs)`` reads,
        [accepted, rejected] int64: the reads with Q >= ``threshold`` and
        with Q < it, pads masked).  Pads the batch to ``n`` tiles with
        copies of read 0; every shard is enqueued before any is fetched."""
        B = seqs.shape[0]
        gran = self.n * self.engine.default_batch_tile()
        seqs, lens = self.engine._pad(seqs, lens, gran)
        outs = [eng._full(eng._upload(seqs[p].astype(np.uint8)),
                          eng._upload(lens[p].astype(np.int32)))
                for eng, p in self._shards(seqs.shape[0])]
        fields = [
            None if i == 3 and not want_labels
            else torch.cat([o[i].cpu() for o in outs]).numpy()[:B]
            for i in range(5)
        ]
        q = fields[4]
        counts = np.array([(q >= threshold).sum(), (q < threshold).sum()],
                          dtype=np.int64)
        return BatchResult(*fields), counts


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
    per base ``(src, dst, val)`` on ``device`` (int64, int64, f32), the
    plain E-step's tables; ``off``, the offsets of each base's entries in
    the flat transition mass; and ``estep``, the same entries as the
    kernel ``td_estep`` reads them (``tables.estep_tables``, grouped by
    destination, with each entry's index in the flat mass)."""
    A = np.asarray(lat.A, dtype=np.float32)
    edges, off = [], [0]
    for c in range(5):
        s, t = np.nonzero(A[c])
        edges.append((torch.from_numpy(s.astype(np.int64)).to(device),
                      torch.from_numpy(t.astype(np.int64)).to(device),
                      torch.from_numpy(np.ascontiguousarray(A[c, s, t])).to(device)))
        off.append(off[-1] + int(s.size))
    estep = {k: torch.from_numpy(v).to(device) for k, v in estep_tables(A).items()}
    return {"S": int(lat.S), "begin": int(lat.begin), "edges": edges, "off": off,
            "estep": estep}


def estep_bytes(engine, B: int, Lp: int) -> int:
    """Device bytes of one E-step over B reads padded to Lp on the engine's
    route.  Both: K1's stack and log scales ((Lp+1) * (S+1) * 4 a read),
    logP and the reads with their lengths.  The kernel (a card engine):
    its f64 partials, one row of the entries a cluster it launches
    (``estep.clusters``), the mass and E.  The plain version (the CPU): the reads' codes and order by base
    (int64), the carries and scales, and the worst case of the per-base
    temporaries (every read under the base with the most entries, nnz): the
    gathered flows, backward values and their product (3 nnz floats), and
    the carry, backward values and new carry sorted by base and the new
    carry in read order (4 S)."""
    S = engine.lat.S
    nnz = [int(np.count_nonzero(engine.lat.A[c])) for c in range(5)]
    per_read = (Lp + 1) * (S + 1) * 4 + 4 + Lp + 4
    if engine.device.type == "cuda":
        rows = estep.clusters(engine)
        return B * per_read + 8 * rows * sum(nnz) + 4 * sum(nnz) + 4 * 5 * S
    per_read += 16 * Lp + 4 * (2 * S + 4) + 4 * (3 * max(nnz) + 4 * S)
    return B * per_read


def estep_reads(engine, Lp: int) -> int:
    """The most reads of Lp whose E-step stays inside this process's share
    of ``STACK_BYTES`` (``CudaEngine.stack_budget``), 0 if one read's does
    not."""
    fixed = estep_bytes(engine, 0, Lp)
    return max(engine.stack_budget() - fixed, 0) // (estep_bytes(engine, 1, Lp) - fixed)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    whose buffers stay inside this process's share of the engine's
    STACK_BYTES (``estep_reads``), each moved to the device, then K1
    (``engine.scorer.backward``), then the forward recurrence
    (``estep.forward_counts``); the Kahan sums run on across sub-batches.  With
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
        forward_counts(tab, seqs, lens, *stack, ct, e)
        return _dense(tab, ct.sum), e.sum, n
    B, Lp = seqs.shape
    step = estep_reads(engine, Lp)
    if step == 0:
        raise RuntimeError(
            f"a read padded to {Lp}nt needs {estep_bytes(engine, 1, Lp)} bytes of "
            f"E-step buffers, over the {engine.stack_budget()}-byte budget "
            "(CudaEngine.STACK_BYTES, this process's share)")
    for s in range(0, B, step):
        sq, ln = seqs[s : s + step].to(dev), lens[s : s + step].to(dev)
        with span("mesh.backward"):
            stack = engine.scorer.backward(sq, ln)
            _sync(dev)
        with span("mesh.estep"):
            forward_counts(tab, sq, ln, *stack, ct, e)
            del stack
            _sync(dev)
    return _dense(tab, ct.sum), e.sum, n


class DistributedTrainer:
    """MODE_TRAIN over shards: per-shard Baum-Welch expected counts in
    lattice space, summed in shard order.

    ``devices`` (default ``[engine.device]``) names one device per shard, of
    the engine's type: an engine built for the card trains on this
    process's cards and nowhere else (no fallback to the CPU), one built
    for ``"cpu"`` on the CPU through the plain K1.  Each shard's card gets
    the engine placed there (``CudaEngine.on``) and its ``count_tables``.
    Shards run in turn, from one thread."""

    def __init__(self, engine, devices=None):
        devices = [torch.device(d) for d in (devices or [engine.device])]
        for d in devices:
            if d.type != engine.device.type:
                raise ValueError(f"a shard on {d}, the engine on {engine.device}")
        if engine.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: an engine built for the card "
                               "trains on the card")
        self.engine = engine
        self.shards = len(devices)
        self.engines = [engine.on(d) for d in devices]
        self.tables = {}
        for e in self.engines:
            if e.device not in self.tables:
                self.tables[e.device] = count_tables(engine.lat, e.device)

    def run(self, seqs: np.ndarray, lens: np.ndarray):
        """-> (CT [5, S, S] f32, E [5, S] f32, total) as numpy: the counts of
        ``seqs`` [B, Lp] / ``lens`` [B], padded to a multiple of the shard
        count with zero-length reads and cut into contiguous shards.  The
        reads stay on the host until their sub-batch runs.  In a process
        group of P processes, each passing the same batch, the batch is cut
        into P blocks of this trainer's shards, process p counts block p, and
        every process returns the sums over all of them.  Such a group has
        run ``multihost.init_multihost`` in every process (or set torchrun's
        LOCAL_*), so that each knows its cards and budget share."""
        from .multihost import rank_and_world

        rank, world = rank_and_world()
        n = self.shards * world
        pad = (-seqs.shape[0]) % n
        if pad:
            seqs = np.concatenate([seqs, np.zeros((pad, seqs.shape[1]), seqs.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
        per = seqs.shape[0] // n
        dev = self.engines[0].device
        CT = E = None
        total = 0
        for i, eng in enumerate(self.engines):
            k = rank * self.shards + i
            part = slice(k * per, (k + 1) * per)
            s = torch.from_numpy(np.ascontiguousarray(seqs[part], np.uint8))
            ln = torch.from_numpy(np.ascontiguousarray(lens[part], np.int32))
            ct, e, m = _expected_lattice_counts(eng, s, ln,
                                                tables=self.tables[eng.device])
            if CT is None:
                CT, E = Kahan(ct.shape, dev), Kahan(e.shape, dev)
            CT.add(ct.to(dev))
            E.add(e.to(dev))
            total += int(m)
        CT, E = CT.sum.cpu(), E.sum.cpu()
        if world > 1:
            # the blocks' sums, added on the host: float64 keeps the f32
            # partials exact, int64 the bases
            flat = torch.cat([CT.double().flatten(), E.double().flatten()])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            CT = flat[: CT.numel()].reshape(CT.shape).float()
            E = flat[CT.numel():].reshape(E.shape).float()
            t = torch.tensor([total], dtype=torch.int64)
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            total = int(t[0])
        return CT.numpy(), E.numpy(), total

    def expected_segment_counts(self, seqs: np.ndarray, lens: np.ndarray):
        """The whole MODE_TRAIN E-step: the counts of ``run``, mapped back to
        the reference's per-segment count arrays (``train.Counts``); feed
        them to ``engine.train.reestimate``."""
        from ..engine.train import lattice_counts_to_counts

        CT, E, _ = self.run(seqs, lens)
        with span("mesh.map"):
            return lattice_counts_to_counts(self.engine.mb, CT, E)
