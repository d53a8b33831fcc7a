"""Several coordinated processes, one per host, over ``torch.distributed``.

The counterpart of ``tagdust_tpu/parallel/multihost.py``.  ``tagdust
-multihost`` runs as N processes: each owns the read chunks with
``chunk_index % N == rank``, boundary-skips the rest
(``SeqReader.skip_chunk``: no arena copies, no encoding), labels its own on
its local cards and writes its own output shard (``<out>.h<rank>_...``) with
a sidecar of per-chunk byte ranges.  Rank 0 resolves the architecture,
computes the stats and calibrates once and broadcasts the result
(``controller._once_on_host0``); at the end it interleaves the shards back
into the reference's single file set, byte for byte a single-process run's
(:func:`merge_output_shards`), and every process reports the global counters
(:func:`global_counter_sum`).

Only host objects cross processes (counters, pickled thresholds, barriers),
so the process group is ``gloo`` over TCP: it needs no card, and NCCL would
refuse two ranks on one card.  Every collective is bounded by the group's
timeout, ``TAGDUST_TPU_BARRIER_TIMEOUT_S`` (default 900 s), and the shard
barrier by the same value: no collective waits without a limit.
"""

from __future__ import annotations

import json
import os
import sys
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def barrier_timeout_s() -> float:
    return float(os.environ.get("TAGDUST_TPU_BARRIER_TIMEOUT_S", "900"))


def rank_and_world() -> tuple:
    """(rank, world size) of this process's group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Join the process group (idempotent) and return (rank, world size).

    With ``coordinator`` (``host:port``) the group meets at
    ``tcp://<coordinator>`` with ``num_processes`` and ``process_id``;
    without it at ``env://`` (torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``).  A world size other than the one asked
    for is refused."""
    if not dist.is_initialized():
        kwargs = {"timeout": timedelta(seconds=barrier_timeout_s())}
        if coordinator is not None:
            if num_processes is None or process_id is None:
                raise SystemExit(
                    "ERROR: -coordinator needs -nprocs and -procid")
            kwargs.update(init_method=f"tcp://{coordinator}",
                          world_size=num_processes, rank=process_id)
        else:
            kwargs["init_method"] = "env://"
        dist.init_process_group("gloo", **kwargs)
    if num_processes is not None and dist.get_world_size() != num_processes:
        raise SystemExit(
            f"ERROR: multi-host init requested {num_processes} processes but "
            f"the process group has {dist.get_world_size()} (a group was "
            "initialised before tagdust started, or WORLD_SIZE disagrees)"
        )
    return dist.get_rank(), dist.get_world_size()


def global_counter_sum(counters: dict) -> dict:
    """Sum an int-counter dict over all processes: one ``all_reduce`` of an
    int64 tensor, which gloo sums exactly (the cross-host counterpart of
    the reference's join-then-reduce, barcode_hmm.c:354-385).  The identity
    in a single process."""
    if rank_and_world()[1] == 1:
        return dict(counters)
    keys = sorted(counters)
    t = torch.tensor([int(counters[k]) for k in keys], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(keys, t.tolist())}


def broadcast_obj(obj, is_source: bool):
    """Rank 0's ``obj`` on every process (``broadcast_object_list``): the
    stats, thresholds and architectures computed once on host 0."""
    if rank_and_world()[1] == 1:
        return obj
    box = [obj if is_source else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _barrier_with_timeout(name: str, timeout_s: float) -> None:
    """A cross-host barrier that fails loudly instead of waiting for ever: a
    peer that died (an output error kills only its own host) or never
    arrives ends every process in ``SystemExit(1)`` naming the barrier."""
    if rank_and_world()[1] == 1:
        return
    try:
        dist.monitored_barrier(timeout=timedelta(seconds=timeout_s))
    except RuntimeError as e:  # a timeout or a dead peer
        sys.stderr.write(
            f"[ERROR]\tcross-host barrier '{name}' failed after "
            f"{timeout_s:.0f}s — a peer process likely died "
            f"(its logfile has the original error): {e}\n"
        )
        raise SystemExit(1)


def merge_output_shards(base_outfile: str, pid: int, nproc: int) -> None:
    """Interleave the per-host output shards back into the reference's
    single demultiplexed file set (io.c:757-1029 contract).

    Every host wrote ``<base>.h<p><suffix>`` shard files plus a sidecar
    index of per-chunk byte ranges (io/writer.py:mark_chunk).  After a
    cross-host barrier, host 0 concatenates each output file's chunks in
    GLOBAL chunk order — chunk c lives in host ``c % nproc``'s shard — so
    the merged bytes equal a single-process run's exactly, then removes
    the shards.  Requires the hosts to share a filesystem.

    The barrier times out (``TAGDUST_TPU_BARRIER_TIMEOUT_S``, default
    900 s) so an asymmetric host death fails the run loudly rather than
    hanging it."""
    _barrier_with_timeout("tagdust:shards-written", barrier_timeout_s())
    if pid != 0:
        return
    shards = []
    for p in range(nproc):
        sc = f"{base_outfile}.h{p}.chunks.json"
        try:
            with open(sc) as fh:
                shards.append(json.load(fh)["files"])
        except FileNotFoundError:
            shards.append({})  # host owned no chunks
    suffixes = sorted({s for sh in shards for s in sh})
    for suffix in suffixes:
        segs = []  # (chunk_idx, host, start, end)
        for p, sh in enumerate(shards):
            for ci, a, b in sh.get(suffix, []):
                segs.append((ci, p, a, b))
        segs.sort()
        handles = {}
        try:
            with open(base_outfile + suffix, "wb") as out:
                for ci, p, a, b in segs:
                    fh = handles.get(p)
                    if fh is None:
                        fh = handles[p] = open(
                            f"{base_outfile}.h{p}{suffix}", "rb"
                        )
                    fh.seek(a)
                    out.write(fh.read(b - a))
        finally:
            for fh in handles.values():
                fh.close()
    for p, sh in enumerate(shards):
        for suffix in sh:
            try:
                os.remove(f"{base_outfile}.h{p}{suffix}")
            except FileNotFoundError:
                pass
        try:
            os.remove(f"{base_outfile}.h{p}.chunks.json")
        except FileNotFoundError:
            pass
