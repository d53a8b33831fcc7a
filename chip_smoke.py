#!/usr/bin/env python3
"""Smoke run of tagdust_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--reads N] [--only PHASE,...]

Phases, each fatal on failure (no phase catches its own error):

1. device: the card's name and power limit, torch / CUDA / nvcc / Triton
   versions; exits non-zero without a CUDA device;
2. build: nvcc builds the kernels from ``tagdust_tpu_torch/engine/csrc``;
3. kernels: every kernel against its plain PyTorch version on the same CUDA
   tensors, B=16384, Lp=64, read lengths 40-64, median of 5 timed runs of
   each (CUDA events, each run behind a device-side spin that keeps the
   host's launch overhead out of the time; K3 is also timed without it,
   the host's launch work included): K1-K4 dense on the 8 x 6nt library, the flagship
   model (20 x 6nt barcodes + R:N), the 96 x 8nt plate and the plate's
   barcodes + a 140nt spacer + R:N (S = 2115, no grouped form), the
   lattices of the main paths; K1-K4 grouped (the mode forced) on the
   flagship and the plate; K1/K4 dense on ``R:N`` alone (K = 0, an
   ``-arch`` candidate); K4's logP_b must equal K1's bit for bit;
   where K1/K4 or K2 stage step tables in shared memory, K1 or K2 is timed
   at each lower staging level too, down to every step table left in L2
   (at the same reads per block, and at those that level would allow),
   outputs equal at each; K3 at long reads (B=1024, Lp=4224, the
   flagship lattice) against the plain traceback, exact;
   ``td_myers`` (the artifact filter's edit distance) over 1,048,576 seeded
   patterns of 1-63 symbols with 15% spacers (``m = 1``, ``m = 63`` and an
   all-spacer pattern among them), forward and reverse-complement, in seeded
   texts of 20, 157, 1,869 and 5,070nt (the lengths of an adapter and of
   human 5.8S, 18S and 28S rRNA): equal to the plain lanes on the card on
   every lane and to the host uint64 lanes on the first 20,000;
4. digest: a sha256 of every output of dense K1 (``bstack``, ``blstack``,
   ``logpb``), K4 (``logpb``) and K2 (``path``, ``dpfin``, ``f_log``,
   ``tp``) on the kernels phase's seeded inputs, per lattice (8 x 6nt,
   flagship, plate, plate + spacer; K1 and K4 on ``R:N``), one ``digest``
   line each: run ``--only digest`` on two checkouts on one card and
   compare the lines to show that two versions of the kernels give the
   same bits;
5. gate: dense against grouped K1, K2 and K4 at 8, 20, 48 and 96
   barcodes; the engine runs every kernel dense unless grouped is forced,
   so dense must be the faster mode of each; the dense kernels alone on
   the plate + spacer;
6. main paths, each through the port's entry points (a-e the CLI, f the
   trainer) with the launch counts set to 0 just before it and read just
   after; every kernel of the path must have launched, no plain version
   may run on CUDA tensors; a-e: every read must be written, barcode
   precision >= 0.99:
   a. a default-flag ``tagdust -engine cuda`` run over a generated 1M-read
      flagship FASTQ (per-run calibration, streaming decided labelling),
      with ``-seed`` fixed so that g and h select its threshold;
   b. the same over 200k reads of an 8 x 6nt library (dense step mode);
   c. ``tagdust -arch`` over a generated 1M-read 96-plex FASTQ with the
      flagship, the plate and R:N as candidates: detection on the card
      (K4), then the plate's demultiplex; the plate must win;
   d. ``-ref``: the flagship library over 1M reads of which 5% carry, after
      their barcode, a piece of one of the four contaminants (half
      reverse-complemented, 0-2 substitutions), default flags but ``-fe 8``
      (the extracted read keeps its 6 barcode positions as spacers, which
      cost one edit each, so the default ``-fe 2`` cannot hit on a barcoded
      architecture); ``td_myers`` must launch, the planted reads must leave
      the barcode files and be counted under their contaminant, and the
      first 20,000 reads must give ``-engine exact``'s artifact counts but
      for reads that already decide apart without ``-ref``;
   e. the label-carrying rows: the flagship's 1M reads with ``-start 1
      -end 46`` (the barcode and 40nt of the read) at ``-Q 20``, and its
      20,000-read cross-check against ``-engine exact``;
   f. training (``train``): the Baum-Welch E-step
      (``parallel/mesh.py:_expected_lattice_counts``: ``td_estep`` reading
      K1's stack) on the kernels phase's reads of the flagship and the
      plate: ``td_estep``'s geometry (its cluster size C, reads a tile R,
      shared bytes a block and clusters launched), its CT and E against its
      plain version on the same
      CUDA stack (rtol 1e-4, atol 1e-6) and a second launch's bits against
      the first's, its time and the plain version's beside K1's and its
      bound, K1's whole output (the
      stack the E-step reads, its log scales and logP) against its plain
      version, the card's counts against the same E-step on the host fed
      the card's stack and, apart, fed the stack of K1's plain version run
      on the host (first 2,048 reads, rtol 1e-4, atol 1e-6: K1 and the
      E-step held together), E.sum and CT.sum against the bases scored
      (1e-4), 4 shards on the card against 1 (rtol 1e-5, atol 1e-6); the
      plate + spacer (S = 2115) the same way but for the host, shard and
      EM checks, over 4,096 reads it can emit (its barcode, the spacer and
      up to 44nt, 160-192nt: shorter reads have no path); then
      one EM iteration over 1M generated flagship reads
      (``DistributedTrainer.expected_segment_counts``, ``reestimate``):
      its wall and split (K1, E-step, host mapping, reestimate), K1 and
      ``td_estep`` launched, every re-estimated emission row summing to 1
      within 1e-3,
      and sum logP before and after (reported); then K1's whole output at
      the shape the iteration gave it (its first sub-batch) against its
      plain version;
      the phase's JSON line comes before the card's line;
   g. ``multihost``: a's command as ``-multihost`` with two processes on the
      one card (gloo on 127.0.0.1), each this script in its child mode
      (``--child``: the CLI in-process, then one JSON line of its wall,
      launches, streaming counters, plain calls on CUDA tensors and
      ``max_memory_allocated``); the card must be in the Default compute
      mode; every merged file must have the sha256 of a's, the shards and
      sidecars must be gone, both logfiles must give a's threshold and
      totals, each process must launch K1, K2 and K3, host 1 must stream in
      >= 3 windows, each host must parse exactly the records of the
      chunks it owns (``TAGDUST_TPU_IO_STATS``), skipping the rest, and
      the two processes' peak allocations on the shared card must sum to
      at most one ``STACK_BYTES`` (each sizes by its half);
   h. ``mesh``: ``ShardedScorer`` over [cuda:0, cuda:0]: its decided and
      label-carrying rows against ``CudaEngine``'s (sha256) at B = 16,384,
      Lp = 64 on the flagship and the plate, ``DistributedTrainer`` over
      the two shards against one (rtol 1e-5, atol 1e-6; E.sum = CT.sum =
      the bases scored, 1e-4), then a's command with
      ``runner.local_devices`` replaced in-process by the two shards: a's
      output bytes, >= 3 windows through the shards, K1-K3 launched, and
      the card's peak allocation above what the run found allocated inside
      ``STACK_BYTES``;
   i. ``entry``: the entry points and the benches
      (``tagdust_tpu_torch/entry.py``, ``tagdust_tpu_torch/bench/``):
      ``entry()`` on the card against ``entry(device="cpu")`` (labels equal,
      f within 1e-4, Q within 1e-2); ``dryrun_multichip(2)`` (K1-K3 and
      ``td_estep`` launched); ``bench.kernels`` at full size (its JSON line,
      beside the kernels phase's flagship B / (K1+K2+K3)); ``bench.e2e``
      over 200,000 simreads reads (made by a child process started with the
      script), one trial after the warm-up, at ``-Q 10`` and at default
      flags; ``bench.multichip`` at 1 and 2 shards; the A/B switches: the
      decided rows and ``run_batch_fused``'s Q and labels at B = 16,384 bit
      for bit equal under ``TAGDUST_TPU_NIBBLE=0`` and ``1``, and the
      flagship CLI over the 200,000 reads at ``-Q 10`` under
      ``TAGDUST_TPU_DEVICE_DECISIONS=0`` (label-carrying rows, the host
      extractor) with the decided run's output sha256s; every step but the
      first with no plain version on CUDA tensors;
   a-e each print their step mode and the launches of each kernel; a path
   that streams in fewer than 3 windows, or that re-labelled a chunk
   one-shot after a failed window, fails;
7. cross-checks against ``-engine exact`` on the first 20,000 reads, at
   ``-Q 20`` (a threshold of 0.0: with ``-Q`` the reference does not
   calibrate): the flagship, the 8-plex, and the ``-arch`` run (the same
   winner and confidence); per-read outcomes must agree on >= 99.9%, and
   the reads that differ are listed with Q on both engines; the flagship
   and the 8-plex also run ``-engine torch`` (the plain versions, on the
   CPU), and at most 0.01% of the reads may decide apart from the card on
   the label path;
8. long reads: 200 reads of the plate library, 5,410-5,470nt (padded to
   5,472), through the CLI on ``-engine cuda`` and ``-engine exact`` at
   ``-Q 20``: every read written, K1-K3 launched and no plain version on
   CUDA tensors, no launch's buffers over ``CudaEngine.STACK_BYTES``; it
   prints the largest sub-batch and ``torch.cuda.max_memory_allocated()``
   and lists the reads that decide apart from the exact engine.

The line before the last is the kernels' JSON record: per kernel its
times, its launches on the main paths, and its bound on this card (the
larger of the bytes it must move over 3.35 TB/s and the f32 operations the
inputs need over 67 TFLOP/s, ``bound``; K3's path reads at 32-byte sector
granularity; ``td_myers`` by its 32-bit integer instructions over 64 lanes
an SM and clock, ``myers_bound``; ``td_estep`` from the train phase on the
plate, ``estep_bound``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SOURCE = "tagdust_tpu_torch/engine/csrc/fused_dp.cu"
# the kernels of their own sources; every other counter is fused_dp.cu's
SOURCES = {"myers": "tagdust_tpu_torch/engine/csrc/myers.cu",
           "estep": "tagdust_tpu_torch/engine/csrc/estep.cu"}
PK = "tagdust_tpu/engine/pallas_kernel.py"
# (counter, name, Pallas kernel it replaces, model whose kernels-phase run
# gives the row its numbers: the plate, the lattice of the main path with
# the most device time; the grouped rows from the plate in the forced mode)
KERNELS = [
    ("bwd", "td_bwd", f"{PK}:350", "plate"),
    ("fwd", "td_fwd", f"{PK}:384", "plate"),
    ("tb", "td_tb", f"{PK}:535", "plate"),
    ("bwd_grouped", "td_bwd_grouped", f"{PK}:350", "plate"),
    ("fwd_grouped", "td_fwd_grouped", f"{PK}:384", "plate"),
    ("score", "td_bwd_score", f"{PK}:369", "plate"),
    ("score_grouped", "td_bwd_score_grouped", f"{PK}:369", "plate"),
    # the JAX package leaves this scan to XLA; its numbers come from the
    # myers phase (every contaminant and both orientations in one launch)
    ("myers", "td_myers", "tagdust_tpu/engine/myers_tpu.py:39", "myers"),
    # the E-step, an XLA scan in the JAX package too; its numbers come from
    # the train phase on the plate
    ("estep", "td_estep", "tagdust_tpu/parallel/mesh.py:251", "plate"),
]
# kernels-phase runs (model, grouped, full); K3 does not depend on the mode,
# and the dense run, the main paths' mode, is the later one.  "spacer" is
# the plate's barcodes + a 140nt spacer + R:N, which has no grouped form
KERNEL_RUNS = (("flagship", True, True), ("plate", True, True),
               ("8", False, True), ("flagship", False, True),
               ("plate", False, True), ("R:N", False, False),
               ("spacer", False, True))
# the H100 SXM's published rates: HBM bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12
F32_RATE = 67e12
# reads of the 8-barcode run (5b)
SMALL_READS = 200_000
PHASES = ("kernels", "myers", "digest", "gate", "flagship", "8-plex", "arch", "ref", "sub",
          "train", "multihost", "mesh", "entry", "cross", "long")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def library_model(barcodes, max_len: int = 64, spacer: str = ""):
    """``-1 B:<barcodes> -2 R:N`` (``-1 R:N`` without barcodes; ``-1
    B:<barcodes> -2 S:<spacer> -3 R:N`` with a spacer) with the flagship's
    sequence stats."""
    from tagdust_tpu_torch.arch import build_read_structure
    from tagdust_tpu_torch.logsum import p2sp
    from tagdust_tpu_torch.model import init_model_bag
    from tagdust_tpu_torch.stats import SequenceStats

    ssi = SequenceStats()
    ssi.average_length = 50
    ssi.max_seq_len = max_len
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    segs = ([f"B:{','.join(barcodes)}"] if barcodes else []) + (
        [f"S:{spacer}"] if spacer else []) + ["R:N"]
    rs = build_read_structure(segs)
    return init_model_bag(rs, ssi, 0.05, 0.1)


def barcode_sets() -> dict:
    from tagdust_tpu_torch.flagship import (
        PLATE_PATH,
        generate_barcodes,
        load_barcodes,
    )

    return {"8": generate_barcodes(8, 6, 3), "flagship": load_barcodes(),
            "48": generate_barcodes(48, 8, 3), "plate": load_barcodes(PLATE_PATH)}


# cycles of the device-side spin that each timed run is enqueued behind
SPIN_CYCLES = 2_000_000


def timed(fn, reps: int = 5, spin: bool = True) -> float:
    """Median milliseconds of ``reps`` runs, CUDA events, after one warm-up.
    With ``spin`` each run is enqueued behind a device-side spin
    (``torch.cuda._sleep``, about a millisecond) that outlasts the host's
    work of launching it, so the events time the device alone; without it
    they also take in the host's launch overhead (tens of microseconds)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def close(a, b, atol, rtol) -> tuple:
    """(max |a-b|, ok) with |a-b| <= atol + rtol*|b| elementwise."""
    a = a.double().cpu()
    b = b.double().cpu()
    d = (a - b).abs()
    return float(d.max()), bool((d <= atol + rtol * b.abs()).all())


def phase_kernels(eng, grouped: bool, seed: int, full: bool = True,
                  device: str = "cuda", B: int = 16384, Lp: int = 64) -> dict:
    """K1-K4 of one step mode against the plain versions on identical
    inputs (``full=False``: K4 and K1 only).
    Returns {counter: {"ms", "plain_ms", "max_abs_err"}}."""
    import torch

    from tagdust_tpu_torch.engine import scan
    from tagdust_tpu_torch.engine.fused_kernel import FusedScorer
    from tagdust_tpu_torch.engine.tables import grouped_tables_from_lattice

    g = grouped_tables_from_lattice(eng.mb, eng.lat) if grouped else None
    if grouped and g is None:
        fail("the lattice has no grouped form")
    sc = FusedScorer(eng.tables, g).to(device)
    gt = sc.grouped_tables()
    if device == "cuda":
        print(f"[S={sc.S} {'grouped' if grouped else 'dense'}] reads per block, "
              "staged (0 none, 1 label tables, 2 and heavy outputs, 3 and light slices), "
              "blocks per SM: "
              f"K1 {sc.reads_per_block('bwd')}, {sc.staged('bwd')}, "
              f"{sc.blocks_per_sm('bwd')}; K4 {sc.blocks_per_sm('bwd', spill=False)}; "
              f"K2 {sc.reads_per_block('fwd')}, {sc.staged('fwd')}, "
              f"{sc.blocks_per_sm('fwd')}", flush=True)
    sfx = "_grouped" if grouped else ""
    tag = f"S={sc.S} {'grouped' if grouped else 'dense'}"
    rng = np.random.default_rng(seed)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).to(device)
    lens = torch.from_numpy(rng.integers(40, Lp + 1, B).astype(np.int32)).to(device)

    def k1():
        return sc.backward(seqs, lens)

    def p1():
        return scan.backward_pass(seqs, lens, sc.Abwd, sc.end, sc.begin, grouped=gt)

    def k4():
        return sc.score(seqs, lens)

    def p4():
        return scan.backward_scores(seqs, lens, sc.Abwd, sc.end, sc.begin, grouped=gt)

    bst, blst, logpb = k1()
    score = k4()
    pscore = p4()
    e4, ok4 = close(score, pscore, 1e-4, 1e-5)
    print(f"[{tag}] K4 logpb max|d|={e4:.3g} against its plain version; "
          f"K4 == K1 bitwise: {bool(torch.equal(score, logpb))}", flush=True)
    if not ok4:
        fail("K4 logpb outside its tolerance")
    if not torch.equal(score, logpb):
        fail("K4 logpb differs from K1's")
    if device == "cuda":
        staging(sc, "bwd", k1, lambda out: torch.equal(out[2], logpb), tag)
    res = {}
    bounds = bound(eng, seqs, lens)
    if device == "cuda":
        res["score" + sfx] = {"ms": timed(k4), "plain_ms": timed(p4), "max_abs_err": e4,
                              **bounds["score"]}
    if not full:
        del bst, blst
        e1, ok1 = close(logpb, p1()[2], 1e-4, 1e-5)
        print(f"[{tag}] K1 logpb max|d|={e1:.3g}", flush=True)
        if not ok1:
            fail("logpb outside its tolerance")
        if device == "cuda":
            res["bwd" + sfx] = {"ms": timed(k1), "plain_ms": timed(p1), "max_abs_err": e1,
                                **bounds["bwd"]}
        report(tag, res, B, Lp)
        return res

    pbst, pblst, plogpb = p1()

    def k2():
        return sc.forward_decode(seqs, lens, bst, blst, logpb)

    def p2():
        return scan.forward_decode(seqs, lens, sc.Afwd, sc.end, sc.Lmap,
                                   sc.ent_state, sc.tmat, sc.begin, bst, blst,
                                   logpb, grouped=gt)

    path, dpfin, flog, tp = k2()
    ppath, pdpfin, pflog, ptp = p2()
    if device == "cuda":
        staging(sc, "fwd", k2, lambda out: all(
            torch.equal(a, b) for a, b in zip(out, (path, dpfin, flog, tp))), tag)

    def k3():
        return sc.traceback(path, dpfin)

    def p3():
        return scan.traceback(path, dpfin)

    labels = k3()
    plabels = p3()

    e1, ok1 = close(logpb, plogpb, 1e-4, 1e-5)
    ef, okf = close(flog, pflog, 1e-4, 1e-5)
    et, okt = close(tp, ptp, 1e-6, 1e-4)
    ed, okd = close(dpfin, pdpfin, 1e-6, 1e-4)
    print(f"[{tag}] K1 logpb max|d|={e1:.3g}  K2 f_log max|d|={ef:.3g} "
          f"tp={et:.3g} dpfin={ed:.3g}", flush=True)
    for name, ok in (("logpb", ok1), ("f_log", okf), ("tp", okt), ("dpfin", okd)):
        if not ok:
            fail(f"{name} outside its tolerance")
    # K3 on identical path/dpfin is exact
    n_tb = int((labels != plabels).any(dim=1).sum())
    print(f"[{tag}] K3 reads whose labels differ from the plain traceback: {n_tb}")
    if n_tb:
        fail("traceback kernel disagrees with its plain version")

    # whole chain, kernels vs plain versions end to end: labels at 1..len
    # and Q (f32 sums over S states in another order across 64 rescaled
    # steps; a near-tie in the label DP can flip a backpointer)
    chain = sc(seqs, lens)
    pchain_labels = scan.traceback(ppath, pdpfin)
    pos = torch.arange(Lp + 1, device=device)[None, :]
    valid = (pos >= 1) & (pos <= lens[:, None])
    ndiff = int(((chain[2] != pchain_labels) & valid).any(dim=1).sum())
    # plain chain from its own backward pass
    ppath2, pdp2, pflog2, ptp2 = scan.forward_decode(
        seqs, lens, sc.Afwd, sc.end, sc.Lmap, sc.ent_state, sc.tmat, sc.begin,
        pbst, pblst, plogpb, grouped=gt)
    plab2 = scan.traceback(ppath2, pdp2)
    ndiff2 = int(((chain[2] != plab2) & valid).any(dim=1).sum())
    print(f"[{tag}] labels differing at 1..len: {ndiff} (plain K2+K3 on the K1 "
          f"stack), {ndiff2} (plain K1-K3) of {B}")
    if max(ndiff, ndiff2) > B * 1e-4:
        fail("labels differ on more than 0.01% of reads")
    rlog = scan.random_log(seqs, lens, eng._bg_log, eng._avg_len)
    q = scan.q_from_scores(chain[0], rlog, scan.bar_log(chain[3], eng._bar_segments))
    pq = scan.q_from_scores(pflog2, rlog, scan.bar_log(ptp2, eng._bar_segments))
    fin = torch.isfinite(pq)
    if not bool((torch.isfinite(q) == fin).all()):
        fail("Q finiteness differs")
    eq = float((q[fin] - pq[fin]).abs().max())
    print(f"[{tag}] Q max|d| = {eq:.3g}")
    if eq > 1e-2:
        fail("Q differs by more than 1e-2")
    del pbst, pblst, ppath, ppath2

    if device == "cuda":
        for key, kfn, pfn, err in (("bwd", k1, p1, e1), ("fwd", k2, p2, ef),
                                   ("tb", k3, p3, float(n_tb))):
            res[key if key == "tb" else key + sfx] = {
                "ms": timed(kfn), "plain_ms": timed(pfn), "max_abs_err": err,
                **bounds[key]}
        print(f"[{tag}] K3 {timed(k3, spin=False):.4f} ms with the host's launch "
              "overhead (CUDA events without the spin); bound "
              f"{bounds['tb_element']['bound_ms']:.4f} ms at one path element a "
              "position", flush=True)
    report(tag, res, B, Lp)
    return res


def phase_k3_long(eng, seed: int, B: int = 1024, Lp: int = 4224) -> None:
    """K3 at long reads (lengths Lp-200..Lp): K1 and K2 on the card, then K3
    against the plain traceback on the same path and dpfin, exact."""
    import torch

    from tagdust_tpu_torch.engine import scan

    sc = eng.scorer
    rng = np.random.default_rng(seed)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(Lp - 200, Lp + 1, B).astype(np.int32)).cuda()
    bst, blst, logpb = sc.backward(seqs, lens)
    path, dpfin, _, _ = sc.forward_decode(seqs, lens, bst, blst, logpb)
    del bst, blst
    labels = sc.traceback(path, dpfin)
    plabels = scan.traceback(path, dpfin)
    n_tb = int((labels != plabels).any(dim=1).sum())
    ms = timed(lambda: sc.traceback(path, dpfin))
    plain = timed(lambda: scan.traceback(path, dpfin), reps=1)
    print(f"[S={sc.S} long] K3 at B={B}, Lp={Lp}: reads whose labels differ from the "
          f"plain traceback {n_tb}; kernel {ms:.4f} ms, plain {plain:.3f} ms", flush=True)
    if n_tb:
        fail("K3 disagrees with its plain version on long reads")


def staging(sc, kernel: str, fn, same, tag: str) -> None:
    """Where ``kernel`` ("bwd" or "fwd") stages step tables in shared memory
    (level 2: the heavy outputs, 3: and the light slices), time ``fn`` at
    each lower level down to no step table staged (level 0 for K1, 1 for
    K2, whose label tables stay staged) at the reads per block it runs,
    and with no step table staged at the reads per block that level alone
    would allow (what td_reads_per_block weighs staging against);
    ``same(fn())`` must hold in each run."""
    level, rt = sc.staged(kernel), sc.reads_per_block(kernel)
    if level < 2:
        return
    base = int(kernel == "fwd")
    runs = [(lv, rt) for lv in range(level, 1, -1)] + [(base, rt)]
    if sc._rt_base[kernel] != rt:
        runs.append((base, sc._rt_base[kernel]))
    what = {3: "heavy + light in shared memory", 2: "heavy in shared memory, light in L2",
            base: "both in L2"}
    parts = []
    try:
        for lv, r in runs:
            sc._stage[kernel], sc._rt[kernel] = lv, r
            ms = timed(fn)
            if not same(fn()):
                fail(f"{kernel} differs at staging level {lv}, {r} reads per block")
            parts.append(f"{what[lv]} ({r} reads a block) {ms:.3f} ms")
    finally:
        sc._stage[kernel], sc._rt[kernel] = level, rt
    print(f"[{tag}] {'K2' if kernel == 'fwd' else 'K1'} step tables: " + "; ".join(parts),
          flush=True)


def bound(eng, seqs, lens) -> dict:
    """{counter stem: {"bound_ms", "bound_by"}}: the least time the card
    could take for each kernel's function on these inputs, the larger of
    the bytes it must move (each input read once, each output written once)
    over HBM_RATE and the f32 operations these reads need over F32_RATE.
    Operations per (read, position) inside the read, under its base c: K1
    and K4 2 * nnz(A[c]) for the step's FMAs and 2 S for the rescale; K2 2
    * nnz(Af[c]) for the step and its entry columns, 4 S for the
    posteriors and the rescale, 3 K for the entry posteriors, 2 * nnz(tmat)
    + 2 H for the label DP.  Both step modes compute the same function and
    share the bound.  K3 follows one backpointer per (read, position), and a
    load whose address depends on the last value moves a whole 32-byte
    sector: min(32, H * path bytes) of the path each ("tb"; "tb_element"
    counts one element each)."""
    import torch

    t = eng.tables
    S, K, H = int(t["S"]), int(t["K"]), int(t["tmat"].shape[0])
    B, Lp = seqs.shape
    pos = torch.arange(Lp, device=seqs.device)[None, :] < lens[:, None]
    steps = torch.bincount(seqs.long()[pos], minlength=6)[:5].double().cpu().numpy()
    nnz_b = np.count_nonzero(t["Ab"].reshape(5, -1), axis=1)
    nnz_f = np.count_nonzero(t["Af"].reshape(5, -1), axis=1)
    n_steps = steps.sum()
    inputs = B * Lp + 4 * B
    stack = (Lp + 1) * B * (S + 1) * 4 + 4 * B
    tables_b = 8 * nnz_b.sum() + 4 * 5 * (S + 1)
    tables_f = 8 * nnz_f.sum() + 4 * 5 * (S + K + 1) + 12 * np.count_nonzero(t["tmat"])
    pb = 1 if H <= 127 else 4
    path = Lp * B * H * pb
    ops_b = 2 * (steps @ nnz_b) + 2 * S * n_steps
    ops_f = (2 * (steps @ nnz_f) + (4 * S + 3 * K + 2 * H
             + 2 * np.count_nonzero(t["tmat"])) * n_steps)
    work = {
        "bwd": (inputs + tables_b + stack, ops_b),
        "score": (inputs + tables_b + 4 * B, ops_b),
        "fwd": (inputs + tables_f + stack + path + 4 * B * (H + K + 1), ops_f),
        "tb": (B * Lp * min(32, H * pb) + 4 * B * H + 4 * B * (Lp + 1), B * H),
        "tb_element": (B * Lp * pb + 4 * B * H + 4 * B * (Lp + 1), B * H),
    }
    out = {}
    for key, (nbytes, ops) in work.items():
        tb, to = 1e3 * nbytes / HBM_RATE, 1e3 * ops / F32_RATE
        out[key] = {"bound_ms": float(max(tb, to)),
                    "bound_by": "bytes" if tb >= to else "operations"}
    return out


def report(tag: str, res: dict, B: int, Lp: int) -> None:
    for key, r in res.items():
        print(f"[{tag}] {key}: kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}) (B={B}, Lp={Lp})",
              flush=True)


def digest(t) -> str:
    """sha256 of a tensor's bytes (contiguous, on the host)."""
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy()).hexdigest()


# lattices of the digest phase: K1, K4 and K2 on the first four, K1 and K4
# on R:N (the kernels phase's dense runs)
DIGEST_RUNS = (("8", True), ("flagship", True), ("plate", True), ("spacer", True),
               ("R:N", False))


def phase_digest(models: dict, seed: int, B: int = 16384, Lp: int = 64) -> None:
    """One ``digest <lattice> <kernel> <output> <sha256>`` line for every
    output of dense K1, K4 and K2 on the kernels phase's seeded inputs."""
    import torch

    from tagdust_tpu_torch.engine.fused_kernel import FusedScorer

    rng = np.random.default_rng(seed)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(40, Lp + 1, B).astype(np.int32)).cuda()
    for name, full in DIGEST_RUNS:
        sc = FusedScorer(models[name].tables).cuda()
        out = {}
        bst, blst, logpb = sc.backward(seqs, lens)
        out["K1"] = {"bstack": bst, "blstack": blst, "logpb": logpb}
        out["K4"] = {"logpb": sc.score(seqs, lens)}
        if full:
            path, dpfin, flog, tp = sc.forward_decode(seqs, lens, bst, blst, logpb)
            out["K2"] = {"path": path, "dpfin": dpfin, "f_log": flog, "tp": tp}
        for kern, outs in out.items():
            for k, t in outs.items():
                print(f"digest {name} {kern} {k} {digest(t)}", flush=True)
        del sc, bst, blst, logpb, out
        torch.cuda.empty_cache()


def phase_gate(models: dict, seed: int, B: int = 16384, Lp: int = 64) -> None:
    """Dense against grouped K1, K2 and K4 (median of 5, CUDA events) at each
    library size.  The engine runs every kernel dense unless
    TAGDUST_TPU_GROUPED=1 forces grouped, so dense must be the faster mode of
    each kernel.  Libraries without a grouped form run the dense kernels
    alone."""
    import torch

    from tagdust_tpu_torch.engine.fused_kernel import FusedScorer
    from tagdust_tpu_torch.engine.tables import grouped_tables_from_lattice

    rng = np.random.default_rng(seed)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(40, Lp + 1, B).astype(np.int32)).cuda()
    print(f"gate (B={B}, Lp={Lp}): per library S, K, spans, K1, K2 and K4 ms "
          "dense and grouped", flush=True)
    for name, eng in models.items():
        g = grouped_tables_from_lattice(eng.mb, eng.lat)
        ms = {}
        for mode, gg in (("dense", None), ("grouped", g)):
            if gg is None and mode == "grouped":
                continue
            sc = FusedScorer(eng.tables, gg).cuda()
            bst, blst, lp = sc.backward(seqs, lens)
            ms["K1", mode] = timed(lambda: sc.backward(seqs, lens))
            ms["K2", mode] = timed(lambda: sc.forward_decode(seqs, lens, bst, blst, lp))
            ms["K4", mode] = timed(lambda: sc.score(seqs, lens))
            del sc, bst, blst, lp
            torch.cuda.empty_cache()
        times = ", ".join(f"{k} {m} {v:.3f}" for (k, m), v in ms.items())
        if g is None:
            print(f"gate {name}: S={eng.lat.S} no grouped form; ms {times}", flush=True)
            continue
        slower = [k for k in ("K1", "K2", "K4") if ms[k, "grouped"] < ms[k, "dense"]]
        print(f"gate {name}: S={eng.lat.S} K={int(eng.tables['K'])} "
              f"spans={len(g['span'])}; ms {times}; dense faster for every kernel: "
              f"{not slower}", flush=True)
        if slower:
            fail(f"gate {name}: grouped measured faster for {slower}")


# td_myers: texts of the myers phase and contaminants of the -ref path (the
# lengths of an adapter and of human 5.8S, 18S and 28S rRNA; the sequences
# are not in the repository, so they are seeded), the patterns' count, and
# the 32-bit integer instructions of one (read, text symbol) step, counted in
# the SASS of ``myers_kernel``'s inner loop (``cuobjdump -sass`` of the sm_90a
# build, nvcc 12.9): its four unrolled steps hold 72 LOP3, 16 SEL, 16 SHF, 8
# IADD3, 5 ISETP, 4 VIMNMX and 2 VIADD, 123 in all.  Left out: 12 IMAD forms
# (the shifts by one and the 64-bit add's high word), which run on the FMA
# pipe beside the integer one, and 4 LDS, 3 uniform-datapath instructions
# and the branch
MYERS_TEXTS = (20, 157, 1869, 5070)
MYERS_READS = 1 << 20
MYERS_HOST_LANES = 20000
MYERS_STEP_INSTRUCTIONS = 123 / 4
INT32_LANES = 64 * 132  # 32-bit integer lanes of an SM, SMs of the card


def sm_clock_hz() -> float:
    """The card's highest SM clock as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def contaminant_texts(seed: int) -> list:
    rng = np.random.default_rng(seed + 77)
    return [rng.integers(0, 4, n).astype(np.uint8) for n in MYERS_TEXTS]


def myers_bound(B: int, n_orient: int, texts) -> dict:
    """The least time the card could take for ``td_myers`` on these inputs:
    the larger of its bytes (32 bytes of masks per read and orientation, 4
    of length, the texts, 4 per distance written) over HBM_RATE and its
    integer work, MYERS_STEP_INSTRUCTIONS 32-bit instructions per (read,
    orientation, text symbol), over the 64 integer lanes of each of the 132
    SMs at the card's highest clock."""
    total = sum(int(t.shape[0]) for t in texts)
    nbytes = B * (32 * n_orient + 4) + total + 4 * len(texts) * n_orient * B
    ops = MYERS_STEP_INSTRUCTIONS * n_orient * B * total
    tb = 1e3 * nbytes / HBM_RATE
    to = 1e3 * ops / (INT32_LANES * sm_clock_hz())
    return {"bound_ms": float(max(tb, to)),
            "bound_by": "bytes" if tb >= to else "operations"}


def myers_patterns(seed: int, B: int):
    """(fwd, rev, lens): seeded patterns [B, 63] of 1-63 symbols with 15%
    spacers and their reverse-complements; lane 0 has ``m = 1``, lane 1
    ``m = 63``, lane 2 is all spacers."""
    from tagdust_tpu_torch.constants import REV_NUC_CODE, SPACER

    rng = np.random.default_rng(seed + 31)
    W = 63
    lens = rng.integers(1, W + 1, B).astype(np.int32)
    lens[:2] = (1, W)
    fwd = rng.integers(0, 5, (B, W)).astype(np.uint8)
    fwd[rng.random((B, W), dtype=np.float32) < 0.15] = SPACER
    fwd[2] = SPACER
    pos = np.arange(W, dtype=np.int32)[None, :]
    valid = pos < lens[:, None]
    fwd[~valid] = SPACER
    rv = np.take_along_axis(fwd, np.clip(lens[:, None] - 1 - pos, 0, W - 1), axis=1)
    rev = np.where(rv >= 5, SPACER, REV_NUC_CODE[np.minimum(rv, 4)]).astype(np.uint8)
    rev[~valid] = SPACER
    return fwd, rev, lens


def phase_myers(seed: int, B: int = MYERS_READS) -> dict:
    """``td_myers`` against the plain lanes on the card (every lane, every
    text, both orientations) and the host uint64 lanes (the first
    MYERS_HOST_LANES); times one launch over all texts and orientations, the
    shape the ``-ref`` path gives it (median of 5), each text alone, and the
    plain lanes (one pass)."""
    import torch

    from tagdust_tpu_torch import filters
    from tagdust_tpu_torch.engine import myers

    t0 = time.perf_counter()
    fwd, rev, lens = myers_patterns(seed, B)
    B4 = np.stack([filters._pattern_masks(fwd, lens), filters._pattern_masks(rev, lens)])
    print(f"[myers] {B} patterns and their masks built on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    texts = contaminant_texts(seed)
    dev = torch.device("cuda")
    masks = myers.masks_tensor(B4, dev)
    m = torch.from_numpy(lens).to(dev)
    k = myers.bpm_batch(texts, masks, m)
    torch.cuda.synchronize()

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    plain = torch.stack([
        torch.stack([myers.bpm_batch_plain(t, masks[o], m) for o in range(2)])
        for t in texts])
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    err = int((k - plain).abs().max())
    lanes = int((k != plain).sum())
    n = MYERS_HOST_LANES
    host_apart = 0
    for c, t in enumerate(texts):
        for o in range(2):
            host = filters._bpm_batch(t, B4[o, :n], lens[:n])
            host_apart += int((k[c, o, :n].cpu().numpy() != host).sum())
    print(f"[myers] td_myers against the plain lanes on the card: {lanes} of "
          f"{k.numel()} distances differ (max |d| {err}); against the host uint64 "
          f"lanes on the first {n} reads: {host_apart} differ; m=1, m=63 and "
          f"all-spacer lanes at {MYERS_TEXTS[-1]}nt: "
          f"{k[-1, 0, :3].tolist()}", flush=True)
    if lanes or host_apart:
        fail("td_myers disagrees with its plain version or the host lanes")

    text, offs = myers.text_tensors(texts, dev)
    ms = timed(lambda: myers.bpm_batch_cuda(text, offs, masks, m))
    res = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": float(err),
           **myers_bound(B, 2, texts)}
    for t in texts:
        one, o1 = myers.text_tensors([t], dev)
        bd = myers_bound(B, 2, [t])
        print(f"[myers] text of {t.shape[0]}nt, both orientations: kernel "
              f"{timed(lambda: myers.bpm_batch_cuda(one, o1, masks, m)):.3f} ms, "
              f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']})", flush=True)
    print(f"[myers] all {len(texts)} texts x 2 orientations over B={B} in one launch: "
          f"kernel {ms:.3f} ms  plain {plain_ms:.1f} ms (one pass)  bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']}: {MYERS_STEP_INSTRUCTIONS:.2f} "
          f"32-bit integer instructions a step at {sm_clock_hz() / 1e6:.0f} MHz)",
          flush=True)
    return res


BARCODE_SUB = 0.05


def generate_reads(n: int, seed: int, barcodes, lengths: tuple = (50, 60),
                   plant=None):
    """The reads of ``write_fastq``: (seq [n, max length] ASCII, lens, truth,
    planted)."""
    rng = np.random.default_rng(seed)
    L = lengths[1]
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = alpha[rng.integers(0, 4, (n, L))]
    lens = rng.integers(lengths[0], L + 1, n)
    truth = rng.integers(0, len(barcodes), n)
    truth[rng.random(n) < 0.1] = -1
    bc = np.array([np.frombuffer(b.encode(), dtype=np.uint8) for b in barcodes])
    has = truth >= 0
    head = bc[truth[has]]
    noise = rng.random(head.shape) < BARCODE_SUB
    head[noise] = alpha[rng.integers(0, 4, int(noise.sum()))]
    seq[has, : bc.shape[1]] = head
    planted = np.full(n, -1, dtype=np.int64)
    if plant is not None:
        nb = bc.shape[1]
        fits = [j for j, t in enumerate(plant) if t.shape[0] >= L - nb]
        comp = np.frombuffer(b"TGCA", dtype=np.uint8)
        for i in np.nonzero(has & (rng.random(n) < 0.05 / 0.9))[0]:
            j = fits[int(rng.integers(len(fits)))]
            w = int(lens[i]) - nb
            s0 = int(rng.integers(0, plant[j].shape[0] - w + 1))
            piece = plant[j][s0 : s0 + w]
            piece = comp[piece[::-1]] if rng.random() < 0.5 else alpha[piece]
            for _ in range(int(rng.integers(0, 3))):
                piece[int(rng.integers(w))] = alpha[int(rng.integers(4))]
            seq[i, nb : nb + w] = piece
            planted[i] = j
    return seq, lens, truth, planted


def read_codes(n: int, seed: int, barcodes) -> tuple:
    """(seqs [n, 60] base codes 0-3, lens int32) of ``generate_reads``."""
    seq, lens, _, _ = generate_reads(n, seed, barcodes)
    codes = np.zeros(256, dtype=np.uint8)
    codes[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    return codes[seq], lens.astype(np.int32)


def write_fastq(path: str, n: int, seed: int, barcodes,
                lengths: tuple = (50, 60), plant=None):
    """90% of reads: a barcode of the set (5% substitutions) then a random
    insert, ``lengths`` (50-60nt) in all; 10% random reads.  Returns the
    true barcode index of each read (-1 for random reads).  With ``plant``
    (texts), 5% of the reads, all barcoded, carry after their barcode a
    piece of one of the texts long enough to hold it (half
    reverse-complemented, 0-2 substitutions); then returns (truth, planted)
    with the text's index per read, -1 for none."""
    seq, lens, truth, planted = generate_reads(n, seed, barcodes, lengths, plant)
    with open(path, "wb", buffering=1 << 24) as fh:
        step = 100000
        for s in range(0, n, step):
            parts = []
            for i in range(s, min(s + step, n)):
                r = seq[i, : lens[i]].tobytes()
                parts.append(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * lens[i]))
            fh.write(b"".join(parts))
    return truth if plant is None else (truth, planted)


def read_names(path: str) -> np.ndarray:
    """Read indices (from ``@r<i>``) of every record of a FASTQ file."""
    out = []
    with open(path, "rb") as fh:
        for k, line in enumerate(fh):
            if k % 4 == 0:
                out.append(int(line[2:].split()[0].split(b";")[0]))
    return np.asarray(out, dtype=np.int64)


def read_q(prefix: str, barcodes) -> dict:
    """{read index: Q} from the ``;RQ:`` headers (two decimals) of a run's
    output files."""
    out = {}
    for f in [f"{prefix}_BC_{b}.fq" for b in barcodes] + [f"{prefix}_un.fq"]:
        with open(f, "rb") as fh:
            for k, line in enumerate(fh):
                if k % 4 == 0:
                    name, _, q = line[1:].strip().partition(b";RQ:")
                    out[int(name[1:].split(b";")[0])] = float(q)
    return out


def outcomes(prefix: str, barcodes, n: int) -> np.ndarray:
    """Per-read outcome: barcode index, -1 for the unassigned file, -2 absent."""
    got = np.full(n, -2, dtype=np.int64)
    for j, b in enumerate(barcodes):
        got[read_names(f"{prefix}_BC_{b}.fq")] = j
    un = read_names(f"{prefix}_un.fq")
    got[un] = -1
    return got


def run_tagdust(args) -> float:
    from tagdust_tpu_torch.cli.tagdust import main

    t0 = time.perf_counter()
    main(args)
    return time.perf_counter() - t0


def run_path(name: str, args, expect) -> dict:
    """Drive one main path through the CLI, with the launch counts set to 0
    just before it and read just after; every kernel in ``expect`` (the
    counters of the kernels the path runs, in the engine's step mode) must
    have launched, and no plain version may have run on CUDA tensors."""
    from tagdust_tpu_torch import controller, filters
    from tagdust_tpu_torch.engine import fused_kernel, runner, scan

    for k in fused_kernel.LAUNCHES:
        fused_kernel.LAUNCHES[k] = 0
    scan.PLAIN_CUDA_CALLS["count"] = 0
    runner.STREAM_STATS.update(windows=0, oneshot_after_failure=0)
    filters.REF_TIMINGS.update(calls=0, gather_s=0.0, masks_s=0.0, lanes_s=0.0)
    wall = run_tagdust(args)
    launches = dict(fused_kernel.LAUNCHES)
    windows = runner.STREAM_STATS["windows"]
    oneshot = runner.STREAM_STATS["oneshot_after_failure"]
    plain = scan.PLAIN_CUDA_CALLS["count"]
    cal = controller.TIMINGS["calibration"]
    det = controller.TIMINGS["detection"]
    print(f"[{name}] {wall:.2f} s wall, detection {det:.2f} s, calibration "
          f"{cal:.2f} s; the path's kernels and launches "
          f"{ {k: launches[k] for k in expect} }, all launches {launches}, "
          f"streaming windows {windows}, plain-on-CUDA calls {plain}", flush=True)
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        fail(f"{name}: kernels of the path never launched: {missing}")
    if windows < 3:
        fail(f"{name}: only {windows} streaming windows")
    if oneshot:
        fail(f"{name}: {oneshot} chunks were re-labelled one-shot after a streaming "
             "window failed")
    if plain:
        fail(f"{name}: plain versions ran {plain} times on CUDA tensors")
    return {"wall_s": wall, "detection_s": det, "calibration_s": cal,
            "launches": launches, "ref": dict(filters.REF_TIMINGS)}


def check_output(name: str, out: str, bcs, truth) -> None:
    """Every read written; barcode precision >= 0.99 over the reads
    generated with a barcode."""
    got = outcomes(out, bcs, truth.shape[0])
    if (got == -2).any():
        fail(f"{name}: {int((got == -2).sum())} reads missing from the output")
    # a random read that happens to begin within an edit or two of a
    # barcode is as barcoded as any read can be, and is reported apart
    assigned = got >= 0
    bar = truth >= 0
    correct = assigned & (got == truth)
    precision = correct.sum() / max((assigned & bar).sum(), 1)
    recall = correct.sum() / max(bar.sum(), 1)
    rnd = assigned & ~bar
    print(f"[{name}] barcode precision {precision:.5f}, recall {recall:.5f} "
          f"({int(assigned.sum())} reads assigned; {int(rnd.sum())} of "
          f"{int((~bar).sum())} random reads assigned to a barcode)", flush=True)
    if precision < 0.99:
        fail(f"{name}: barcode precision {precision:.4f} < 0.99")


def mode(bcs) -> str:
    """The counter suffix of the step mode the engine takes for ``-1
    B:<bcs> -2 R:N`` (``-1 R:N`` without barcodes)."""
    from tagdust_tpu_torch.engine.cuda import grouped_step_mode
    from tagdust_tpu_torch.engine.lattice import compile_lattice

    mb = library_model(bcs)
    return "" if grouped_step_mode(mb, compile_lattice(mb)) is None else "_grouped"


def path_kernels(name: str, bcs) -> list:
    """The counters of the kernels a demultiplex of ``bcs`` runs: K1 and K2
    in the engine's step mode, and K3."""
    m = mode(bcs)
    print(f"[{name}] step mode: {m[1:] or 'dense'}", flush=True)
    return ["bwd" + m, "fwd" + m, "tb"]


def phase_main(name: str, bcs, seed: int, n_reads: int, tmp: str,
               flags=(), plant=None) -> dict:
    """A ``tagdust -1 B:<bcs> -2 R:N -engine cuda`` run over a generated
    FASTQ: default flags, or with ``flags`` added."""
    fq = os.path.join(tmp, f"{name}.fq")
    t0 = time.perf_counter()
    truth = write_fastq(fq, n_reads, seed, bcs, plant=plant)
    truth, planted = truth if plant is not None else (truth, None)
    print(f"[{name}] generated {n_reads} reads in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = os.path.join(tmp, f"{name}_out")
    args = ["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-engine", "cuda", *flags]
    res = run_path(name, args + ["-o", out],
                   path_kernels(name, bcs) + (["myers"] if plant is not None else []))
    print(f"[{name}] {n_reads / res['wall_s']:.0f} reads/s", flush=True)
    check_output(name, out, bcs, truth)
    return dict(res, fq=fq, out=out, truth=truth, planted=planted, args=args)


# -fe of the -ref path: the extracted read keeps its barcode positions as
# spacers, which match nothing and cost an edit each (6 here), and the
# planted pieces carry up to 2 substitutions
REF_FE = 8


def write_contaminants(tmp: str, texts) -> tuple:
    """(path of a FASTA file of ``texts``, their names)."""
    names = [f"contaminant{j}_{t.shape[0]}nt" for j, t in enumerate(texts)]
    fa = os.path.join(tmp, "contam.fa")
    with open(fa, "w") as fh:
        for nm, t in zip(names, texts):
            fh.write(f">{nm}\n{''.join('ACGT'[c] for c in t)}\n")
    return fa, names


def artifact_counts(prefix: str, names) -> dict:
    """{contaminant name: reads counted under it} and the total ("all"),
    from a run's log."""
    out = {n: 0 for n in names}
    with open(f"{prefix}_logfile.txt") as fh:
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            if len(f) >= 3 and f[2].startswith("match artifacts"):
                out["all"] = int(f[1])
            elif len(f) >= 3 and f[2] in out and f[1].isdigit():
                out[f[2]] = int(f[1])
    return out


def phase_ref(bcs, seed: int, n_reads: int, tmp: str) -> dict:
    """The ``-ref`` path (5d): the flagship library over reads of which 5%
    carry a piece of a contaminant, default flags but ``-fe 8``; then the
    first 20,000 reads on ``-engine cuda`` and ``-engine exact``, with and
    without ``-ref``, at ``-Q 20``."""
    texts = contaminant_texts(seed)
    fa, names = write_contaminants(tmp, texts)
    flags = ["-ref", fa, "-fe", str(REF_FE)]
    r = phase_main("ref", bcs, seed + 3, n_reads, tmp, flags, plant=texts)
    rt = r["ref"]
    inside = rt["gather_s"] + rt["masks_s"] + rt["lanes_s"]
    print(f"[ref] {r['wall_s']:.2f} s wall; inside match_to_reference_columnar "
          f"{inside:.2f} s over {rt['calls']} calls: host gather of the patterns "
          f"{rt['gather_s']:.2f} s, host mask building {rt['masks_s']:.2f} s, device "
          f"(upload, td_myers, fetch) {rt['lanes_s']:.2f} s; td_myers launches "
          f"{r['launches']['myers']}", flush=True)
    planted = r["planted"]
    got = outcomes(r["out"], bcs, n_reads)
    counts = artifact_counts(r["out"], names)
    n_planted = np.bincount(planted[planted >= 0], minlength=len(texts))
    kept = int(((planted >= 0) & (got >= 0)).sum())
    print(f"[ref] planted reads per contaminant {dict(zip(names, n_planted.tolist()))}; "
          f"counted as artifacts {counts}; planted reads left in a barcode file: "
          f"{kept} of {int((planted >= 0).sum())}", flush=True)
    if kept > 1e-3 * (planted >= 0).sum():
        fail("ref: more than 0.1% of the planted reads stayed in a barcode file")
    for nm, want in zip(names, n_planted):
        # a planted read is counted once its barcode was extracted; none else
        if counts[nm] > want or counts[nm] < 0.9 * want:
            fail(f"ref: {counts[nm]} reads counted under {nm}, {want} planted")
    if counts["all"] != sum(counts[nm] for nm in names):
        fail(f"ref: artifact counts do not add up: {counts}")

    n = 20000
    head = head_fastq(r["fq"], os.path.join(tmp, "ref_head.fq"), n)
    res, cnt = {}, {}
    for eng in ("cuda", "exact"):
        for ref in (True, False):
            prefix = os.path.join(tmp, f"ref_x_{eng}_{int(ref)}")
            run_tagdust(["-1", f"B:{','.join(bcs)}", "-2", "R:N", head, "-o", prefix,
                         "-Q", str(CROSS_Q), "-engine", eng, *(flags if ref else [])])
            res[eng, ref] = outcomes(prefix, bcs, n)
            if ref:
                cnt[eng] = artifact_counts(prefix, names)
    apart = {ref: set(np.nonzero(res["cuda", ref] != res["exact", ref])[0].tolist())
             for ref in (True, False)}
    print(f"[ref] cross-check on {n} reads at -Q {CROSS_Q}: artifact counts cuda "
          f"{cnt['cuda']}, exact {cnt['exact']}; reads that decide apart with -ref "
          f"{sorted(apart[True])}, without {sorted(apart[False])}", flush=True)
    if not apart[True] <= apart[False]:
        fail("ref: reads decide apart from -engine exact only with -ref: "
             f"{sorted(apart[True] - apart[False])}")
    for nm in names + ["all"]:
        if abs(cnt["cuda"][nm] - cnt["exact"][nm]) > len(apart[False]):
            fail(f"ref: {nm} counts differ from -engine exact by more than the reads "
                 "that decide apart without -ref")
    if cnt["cuda"]["all"] < 0.03 * n:
        fail("ref: the cross-check's reads hold too few artifacts to compare")
    return r


# the label-carrying path: -start/-end over the barcode and 40nt of the read
SUB_FLAGS = ("-start", "1", "-end", "46")


def phase_sub(bcs, fq: str, truth, n_reads: int, tmp: str) -> dict:
    """The label-carrying rows (5e): the flagship's FASTQ with ``-start 1
    -end 46`` at ``-Q 20``."""
    out = os.path.join(tmp, "sub_out")
    res = run_path("sub", ["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-o", out,
                           "-engine", "cuda", *SUB_FLAGS, "-Q", str(CROSS_Q)],
                   path_kernels("sub", bcs))
    print(f"[sub] {n_reads / res['wall_s']:.0f} reads/s", flush=True)
    check_output("sub", out, bcs, truth)
    return res


def write_candidates(tmp: str, sets: dict) -> str:
    path = os.path.join(tmp, "candidates.txt")
    with open(path, "w") as fh:
        for name in ("flagship", "plate"):
            fh.write(f"tagdust -1 B:{','.join(sets[name])} -2 R:N\n")
        fh.write("tagdust -1 R:N\n")
    return path


def brief(lines) -> list:
    return [ln if len(ln) < 64 else f"{ln[:60]}..." for ln in lines]


def detection_lines(prefix: str) -> list:
    """The "Using:" and confidence lines of a run's log, without stamps."""
    with open(f"{prefix}_logfile.txt") as fh:
        return [ln.split("\t", 1)[-1].strip() for ln in fh
                if "Using:" in ln or "Confidence" in ln]


def phase_arch(sets: dict, seed: int, n_reads: int, tmp: str) -> dict:
    """``tagdust -arch`` over a 96-plex FASTQ: detection (K4) then the
    plate's demultiplex; the plate must win."""
    bcs = sets["plate"]
    fq = os.path.join(tmp, "plate.fq")
    t0 = time.perf_counter()
    truth = write_fastq(fq, n_reads, seed + 1, bcs)
    print(f"[arch] generated {n_reads} reads in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cands = write_candidates(tmp, sets)
    out = os.path.join(tmp, "arch_out")
    # K4 of each candidate in its step mode, then the plate's K1-K3
    expect = {"score" + mode(b) for b in (sets["flagship"], bcs, [])}
    res = run_path("arch", ["-arch", cands, fq, "-o", out, "-engine", "cuda"],
                   sorted(expect) + path_kernels("arch", bcs))
    lines = detection_lines(out)
    print(f"[arch] detection: {brief(lines)}; {n_reads / res['wall_s']:.0f} reads/s",
          flush=True)
    if not lines or f"B:{','.join(bcs)}" not in lines[0]:
        fail(f"arch: the 96-plex candidate did not win: {brief(lines)}")
    check_output("arch", out, bcs, truth)
    return dict(res, fq=fq, cands=cands, detection=lines)


def head_fastq(fq: str, path: str, n: int) -> str:
    with open(fq, "rb") as src, open(path, "wb") as dst:
        for k, line in enumerate(src):
            if k >= 4 * n:
                break
            dst.write(line)
    return path


# the cross-checks' -Q (with -Q given, the reference labels at a threshold
# of 0.0: no calibration), how near the threshold a read on which the card
# and the plain versions decide apart must score to count as a threshold
# flip (Q is read from the headers' two decimals, so half their step is
# added), and the share of reads that may decide apart on the label path
# instead (the kernels phase's bound on reads whose labels differ)
CROSS_Q = 20
NEAR_Q = 1e-2 + 5e-3
PATH_FLIPS = 1e-4


def differing(res: dict, qs: dict, a: str, b: str) -> list:
    """[(read, outcome a, Q a, outcome b, Q b)] where engines a and b decide
    apart (outcome: barcode index, -1 unassigned)."""
    return [(int(i), int(res[a][i]), qs[a][int(i)], int(res[b][i]), qs[b][int(i)])
            for i in np.nonzero(res[a] != res[b])[0]]


def show(rows: list) -> str:
    return ", ".join("r%d %d Q %.2f / %d Q %.2f" % r for r in rows) or "none"


def run_threshold(prefix: str) -> float:
    """The threshold a run labelled with, from its log."""
    with open(f"{prefix}_logfile.txt") as fh:
        for ln in fh:
            if "selected threshold" in ln:
                return float(ln.split("\t")[-2])
    fail(f"no threshold in {prefix}_logfile.txt")


def phase_cross(name: str, fq: str, tmp: str, arch_args, bcs, torch_leg: bool = False,
                n: int = 20000) -> None:
    """The first ``n`` reads at ``-Q 20`` on ``-engine cuda`` and ``-engine
    exact`` (and ``-engine torch``, the plain versions on the CPU, with
    ``torch_leg``): per-read outcomes of cuda and exact agree on >= 99.9%,
    and any ``-arch`` detection picks the same winner with the same
    confidence.  A read on which cuda and torch decide apart is a threshold
    flip if it scores within 1e-2 of the run's threshold on one of them, and
    else a label-path flip (a near-tie of the label DP, as the kernels
    phase counts them), of which at most ``PATH_FLIPS`` of the reads may
    occur."""
    head = head_fastq(fq, os.path.join(tmp, f"{name}_head.fq"), n)
    from tagdust_tpu_torch import controller

    res, det, qs = {}, {}, {}
    for eng in ("cuda", "exact") + (("torch",) if torch_leg else ()):
        prefix = os.path.join(tmp, f"{name}_x_{eng}")
        t = run_tagdust([*arch_args, head, "-o", prefix, "-Q", str(CROSS_Q),
                         "-engine", eng])
        res[eng] = outcomes(prefix, bcs, n)
        qs[eng] = read_q(prefix, bcs)
        det[eng] = detection_lines(prefix)
        print(f"[{name}] cross-check {eng}: {t:.2f} s wall, detection "
              f"{controller.TIMINGS['detection']:.2f} s {brief(det[eng])}", flush=True)
    rows = differing(res, qs, "cuda", "exact")
    print(f"[{name}] cross-check: {len(rows)} of {n} reads disagree with the exact "
          f"engine (read, outcome and Q on cuda / on exact): {show(rows)}", flush=True)
    if len(rows) > n * 1e-3:
        fail(f"{name}: device and exact engine disagree on more than 0.1% of reads")
    if det["cuda"] != det["exact"]:
        fail(f"{name}: detection differs from the exact engine")
    if torch_leg:
        thr = run_threshold(os.path.join(tmp, f"{name}_x_cuda"))
        rows = differing(res, qs, "cuda", "torch")
        paths = [r for r in rows if min(abs(r[2] - thr), abs(r[4] - thr)) > NEAR_Q]
        print(f"[{name}] cross-check: {len(rows)} of {n} reads disagree between the "
              f"card and the plain versions (-engine torch; on cuda / on torch) at a "
              f"threshold of {thr}: {show(rows)}; of them label-path flips (Q away "
              f"from the threshold): {len(paths)}", flush=True)
        if len(paths) > n * PATH_FLIPS:
            fail(f"{name}: the card and the plain versions decide apart on the label "
                 f"path of more than {PATH_FLIPS:.2%} of the reads: {show(paths)}")


# the long-read phase: reads of the plate library padded past 5,400nt
LONG_READS = 200
LONG_LENGTHS = (5410, 5470)


def phase_long(bcs, seed: int, tmp: str) -> dict:
    """``LONG_READS`` reads of the plate library, 5,410-5,470nt (padded to
    5,472), through the CLI on ``-engine cuda`` at ``-Q 20``, then on
    ``-engine exact``.  Every read must be written, K1-K3 must have
    launched and no plain version run on CUDA tensors, and no launch's
    buffers may exceed ``CudaEngine.STACK_BYTES``; the reads on which the
    engines decide apart are listed with their Q on both (more than 5% of
    them fails)."""
    import torch

    from tagdust_tpu_torch.engine import cuda as cuda_mod
    from tagdust_tpu_torch.engine import fused_kernel, scan

    fq = os.path.join(tmp, "long.fq")
    write_fastq(fq, LONG_READS, seed + 2, bcs, LONG_LENGTHS)
    args = ["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-Q", str(CROSS_Q)]
    for k in fused_kernel.LAUNCHES:
        fused_kernel.LAUNCHES[k] = 0
    scan.PLAIN_CUDA_CALLS["count"] = 0
    cuda_mod.LAUNCH_STATS.update(reads=0, bytes=0)
    torch.cuda.reset_peak_memory_stats()
    res, qs = {}, {}
    for eng in ("cuda", "exact"):
        prefix = os.path.join(tmp, f"long_{eng}")
        t = run_tagdust([*args, "-o", prefix, "-engine", eng])
        res[eng] = outcomes(prefix, bcs, LONG_READS)
        qs[eng] = read_q(prefix, bcs)
        print(f"[long] {eng}: {t:.2f} s wall", flush=True)
        if eng == "cuda":
            launches = dict(fused_kernel.LAUNCHES)
            plain = scan.PLAIN_CUDA_CALLS["count"]
            peak = torch.cuda.max_memory_allocated()
    stats = dict(cuda_mod.LAUNCH_STATS)
    budget = cuda_mod.CudaEngine.STACK_BYTES
    print(f"[long] {LONG_READS} reads of {LONG_LENGTHS[0]}-{LONG_LENGTHS[1]}nt on the "
          f"plate: largest sub-batch {stats['reads']} reads, {stats['bytes']} bytes of "
          f"buffers (budget {budget}); max_memory_allocated {peak} bytes; launches "
          f"{ {k: launches[k] for k in ('bwd', 'fwd', 'tb')} }, plain-on-CUDA calls "
          f"{plain}", flush=True)
    if min(launches[k] for k in ("bwd", "fwd", "tb")) <= 0:
        fail(f"long: kernels of the path never launched: {launches}")
    if plain:
        fail(f"long: plain versions ran {plain} times on CUDA tensors")
    if stats["bytes"] > budget:
        fail(f"long: a launch's buffers ({stats['bytes']} bytes) exceeded {budget}")
    for eng in res:
        if (res[eng] == -2).any():
            fail(f"long: {int((res[eng] == -2).sum())} reads missing on {eng}")
    rows = differing(res, qs, "cuda", "exact")
    print(f"[long] {len(rows)} of {LONG_READS} reads decide apart from the exact "
          f"engine (read, outcome and Q on cuda / on exact): {show(rows)}", flush=True)
    if len(rows) > LONG_READS * 0.05:
        fail("long: more than 5% of the reads decide apart from the exact engine")
    return dict(stats, peak=peak, differ=len(rows))


# the train phase: the E-step (td_estep) at the kernels phase's shape on the
# flagship and the plate, held against its plain version on the same CUDA
# stack and, on the first TRAIN_HOST_READS reads, against the plain E-step
# on the host fed the card's stack and fed the host's plain K1's stack
# (rtol 1e-4, atol 1e-6: the same sums in another order, the kernel's f64
# partials against f32 sums with index_add_'s atomics, and the host's exp
# and log, over 64 rescaled positions), TRAIN_SHARDS shards against one
# within the CPU
# tests' rtol 1e-5 / atol 1e-6; then one EM iteration over TRAIN_READS
# generated flagship reads.  K1's output, wherever the E-step reads it,
# is held against its plain version on the same tensors: the stack within
# atol 1e-6 / rtol 1e-4 (rescaled values of at most 1, the tolerance of
# K2's posteriors), log scales and logP within atol 1e-4 / rtol 1e-5 (the
# kernels phase's logpb tolerance)
TRAIN_HOST_READS = 2048
TRAIN_SHARDS = 4
TRAIN_READS = 1_000_000
HOST_RTOL, HOST_ATOL = 1e-4, 1e-6
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6
MASS_RTOL = 1e-4
STACK_ATOL, STACK_RTOL = 1e-6, 1e-4
LOG_ATOL, LOG_RTOL = 1e-4, 1e-5


def k1_against_plain(tag: str, sc, seqs, lens, got) -> dict:
    """K1's output ``got`` = ``(bstack, blstack, logpb)`` of ``seqs`` /
    ``lens`` against its plain version on the same tensors, slot by slot on
    their device; fails outside STACK_* / LOG_*.  -> the max |d| of each."""
    from tagdust_tpu_torch.engine import scan

    want = scan.backward_pass(seqs, lens, sc.Abwd, sc.end, sc.begin)
    err, ok = {}, True
    for name, a, b, atol, rtol in (
            ("bstack", got[0], want[0], STACK_ATOL, STACK_RTOL),
            ("blstack", got[1], want[1], LOG_ATOL, LOG_RTOL),
            ("logpb", got[2][None], want[2][None], LOG_ATOL, LOG_RTOL)):
        err[name] = 0.0
        for x, y in zip(a, b):  # slot by slot: no whole-stack temporaries
            d = (x.double() - y.double()).abs()
            err[name] = max(err[name], float(d.max()))
            ok = ok and bool((d <= atol + rtol * y.double().abs()).all())
    print(f"[{tag}] K1 against its plain version at {tuple(seqs.shape)}: max|d| "
          + ", ".join(f"{k} {v:.3g}" for k, v in err.items()), flush=True)
    if not ok:
        fail(f"{tag}: K1's stack, log scales or logP outside their tolerance")
    return err


def estep_bound(eng, seqs, lens) -> dict:
    """The least time the card could take for the E-step on these inputs:
    the larger of its bytes over HBM_RATE and its f32 operations over
    F32_RATE.  The bytes are what this run's data needs, each read once:
    per step (a read's position k < len with a base 0-4) its stack row
    ``bstack[k+1]`` (S floats) and log scale ``blstack[k+1]``; per read its
    logP and length and its len bases; the non-zero entries of A as (src,
    dst, value); and the per-entry mass [nnz] and E [5, S] written once.
    The operations: per step under its base c, 2 nnz(A[c]) for ``vn = v
    A[c]`` and 2 nnz(A[c]) for the transition mass, and 5 S for the
    emission mass (3) and the rescale (2)."""
    import torch

    S = eng.lat.S
    B, Lp = seqs.shape
    pos = torch.arange(Lp, device=seqs.device)[None, :] < lens[:, None]
    steps = torch.bincount(seqs.long()[pos], minlength=6)[:5].double().cpu().numpy()
    bases = float(lens.double().sum())
    nnz = np.array([np.count_nonzero(eng.lat.A[c]) for c in range(5)])
    nbytes = (steps.sum() * (S + 1) * 4 + B * (4 + 4) + bases + 12 * nnz.sum()
              + 4 * nnz.sum() + 4 * 5 * S)
    ops = 4 * (steps @ nnz) + 5 * S * steps.sum()
    tb, to = 1e3 * nbytes / HBM_RATE, 1e3 * ops / F32_RATE
    return {"bound_ms": float(max(tb, to)),
            "bound_by": "bytes" if tb >= to else "operations"}


def estep_against_plain(tag: str, tab: dict, seqs, lens, stack, got) -> dict:
    """The E-step's counts ``got`` = (CT, E) of ``seqs`` / ``lens`` from
    K1's ``stack`` (``td_estep`` on CUDA tensors) against its plain version
    on the same tensors (HOST_RTOL / HOST_ATOL: the same sums in another
    order), and a second launch against the first, bit for bit; on the card
    the kernel (``estep.forward_counts_cuda``) and the plain version are
    timed.  -> max |d|, both errors in units of the tolerance, ms, plain
    ms."""
    import torch

    from tagdust_tpu_torch.engine import estep
    from tagdust_tpu_torch.parallel import mesh

    dev, S = seqs.device, tab["S"]

    def counts(fn):
        ct, e = mesh.Kahan(tab["off"][-1], dev), mesh.Kahan((5, S), dev)
        fn(tab, seqs, lens, *stack, ct, e)
        return mesh._dense(tab, ct.sum), e.sum

    plain = counts(estep.forward_counts_plain)
    again = counts(estep.forward_counts)
    err = [rel_err(a.cpu().numpy(), b.cpu().numpy(), HOST_ATOL, HOST_RTOL)
           for a, b in zip(got, plain)]
    dmax = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, plain))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ms = plain_ms = float("nan")
    if seqs.is_cuda:
        ms = timed(lambda: estep.forward_counts_cuda(tab, seqs, lens, *stack))
        plain_ms = timed(lambda: estep.forward_counts_plain(
            tab, seqs, lens, *stack, mesh.Kahan(tab["off"][-1], dev),
            mesh.Kahan((5, S), dev)))
    print(f"[{tag}] td_estep against its plain version on the same stack: CT "
          f"{err[0][0]:.3g}, E {err[1][0]:.3g} of the tolerance, max|d| {dmax:.3g}; "
          f"a second launch {'equal' if same else 'DIFFERENT'} bit for bit; "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    if not all(ok for _, ok in err):
        fail(f"{tag}: td_estep's counts differ from its plain version's")
    if not same:
        fail(f"{tag}: two launches of td_estep gave different bits")
    return {"max_abs_err": dmax, "err": err[0][0], "err_E": err[1][0], "ms": ms,
            "plain_ms": plain_ms}


def estep_geometry(tag: str, tab: dict, device) -> dict:
    """``td_estep``'s geometry for ``tab`` on ``device`` (``estep.launch_plan``),
    printed: the cluster size C, the reads of a tile R, the shared bytes of a
    block (dynamic, and the static part's bound) and the clusters launched."""
    from tagdust_tpu_torch.engine import estep

    g = estep.launch_plan(tab, device)
    print(f"[{tag}] td_estep geometry: C={g['C']} blocks a cluster, R={g['R']} reads "
          f"a tile, {g['smem']} bytes of dynamic shared memory a block (static <= "
          f"{estep.STATIC_SMEM}), {g['clusters']} clusters launched "
          f"({g['clusters'] * g['C']} blocks); states a block "
          f"{np.diff(g['t0']).tolist()}", flush=True)
    return {k: g[k] for k in ("C", "R", "smem", "clusters")}


def spacer_reads(n: int, seed: int, barcodes, insert: str, lengths: tuple) -> tuple:
    """(seqs [n, lengths[1]] base codes, lens int32): a barcode of the set
    (5% substitutions), then ``insert`` (2% substitutions), then random
    bases, ``lengths`` in all: reads that the barcodes + spacer lattice can
    emit (a read shorter than its barcode and spacer cannot be)."""
    rng = np.random.default_rng(seed)
    Lp = lengths[1]
    seqs = rng.integers(0, 4, (n, Lp)).astype(np.uint8)
    codes = np.zeros(256, dtype=np.uint8)
    codes[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    head = np.stack([codes[np.frombuffer((b + insert).encode(), np.uint8)]
                     for b in barcodes])[rng.integers(0, len(barcodes), n)]
    nb = len(barcodes[0])
    noise = rng.random(head.shape) < np.where(np.arange(head.shape[1]) < nb,
                                              BARCODE_SUB, 0.02)
    head[noise] = rng.integers(0, 4, int(noise.sum()))
    seqs[:, : head.shape[1]] = head
    return seqs, rng.integers(lengths[0], Lp + 1, n).astype(np.int32)


# the plate + spacer E-step's reads: the barcode, the 140nt spacer and up
# to 44nt of insert
SPACER_READS = 4096
SPACER_LENGTHS = (160, 192)


def train_estep_only(name: str, eng, barcodes, insert: str, seed: int,
                     B: int = SPACER_READS, lengths: tuple = SPACER_LENGTHS) -> dict:
    """The E-step alone on a lattice that no training path runs (the plate +
    spacer), over reads it can emit (``spacer_reads``): its geometry,
    ``td_estep`` against its plain version on the same CUDA stack and
    against a second launch, its time and its bound; no host, shard or EM
    checks.  |E.sum - n| / n is printed, not gated: over 192 positions of
    this lattice the f32 recurrences (K1's and the E-step's, the plain
    versions' too) lose about 1e-4 of the mass."""
    import torch

    from tagdust_tpu_torch.parallel import mesh

    tag = f"train {name} S={eng.lat.S}"
    seqs_np, lens_np = spacer_reads(B, seed, barcodes, insert, lengths)
    seqs, lens = torch.from_numpy(seqs_np).cuda(), torch.from_numpy(lens_np).cuda()
    stack = eng.scorer.backward(seqs, lens)
    tab = mesh.count_tables(eng.lat, "cuda")
    geo = estep_geometry(tag, tab, seqs.device)
    CT, E, n = mesh._expected_lattice_counts(eng, seqs, lens, stack=stack, tables=tab)
    n = int(n)
    kern = estep_against_plain(tag, tab, seqs, lens, stack, (CT, E))
    bd = estep_bound(eng, seqs, lens)
    e_mass = abs(float(E.double().sum()) - n) / n
    ct_mass = abs(float(CT.double().sum()) - n) / n
    print(f"[{tag}] B={B}, Lp={lengths[1]}, lengths {lengths[0]}-{lengths[1]}: E-step "
          f"(td_estep) {kern['ms']:.3f} ms, its plain version {kern['plain_ms']:.3f} ms, "
          f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}); |E.sum - n| / n "
          f"{e_mass:.3g}, |CT.sum - n| / n {ct_mass:.3g} (n {n})", flush=True)
    del stack
    torch.cuda.empty_cache()
    return {"estep_ms": kern["ms"], "estep_plain_ms": kern["plain_ms"],
            "estep_max_abs_err": kern["max_abs_err"], "estep_err": kern["err"],
            "estep_err_E": kern["err_E"], **bd, "e_mass": e_mass, "ct_mass": ct_mass,
            "geometry": geo}


def rel_err(a, b, atol: float, rtol: float) -> tuple:
    """(max |a-b| / (atol + rtol |b|), ok): ok when that is <= 1."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    r = float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())
    return r, r <= 1.0


def train_lattice(name: str, eng, seed: int, B: int = 16384, Lp: int = 64,
                  device: str = "cuda") -> dict:
    """The E-step on the kernels phase's reads: its time beside K1's and its
    bound, K1's output against its plain version, the card against the host
    on the first TRAIN_HOST_READS reads (fed the card's stack, and fed the
    stack of K1's plain version on the host), the mass invariants over all
    reads, TRAIN_SHARDS shards against one (``device="cpu"``: the same
    checks on the host, untimed)."""
    import torch

    from tagdust_tpu_torch.engine import scan
    from tagdust_tpu_torch.parallel import mesh
    from tagdust_tpu_torch.parallel.mesh import DistributedTrainer

    tag = f"train {name} S={eng.lat.S}"
    rng = np.random.default_rng(seed)
    seqs_np = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    lens_np = rng.integers(40, Lp + 1, B).astype(np.int32)
    seqs = torch.from_numpy(seqs_np).to(device)
    lens = torch.from_numpy(lens_np).to(device)
    sc = eng.scorer
    stack = sc.backward(seqs, lens)
    tab = mesh.count_tables(eng.lat, device)
    cuda = device == "cuda"
    geo = estep_geometry(tag, tab, seqs.device) if cuda else None
    CT, E, n = mesh._expected_lattice_counts(eng, seqs, lens, stack=stack, tables=tab)
    n = int(n)
    k1_ms = timed(lambda: sc.backward(seqs, lens)) if cuda else float("nan")
    kern = estep_against_plain(tag, tab, seqs, lens, stack, (CT, E))
    bd = estep_bound(eng, seqs, lens)
    k1 = k1_against_plain(tag, sc, seqs, lens, stack)

    h = TRAIN_HOST_READS
    sub = (stack[0][:, :h], stack[1][:, :h], stack[2][:h])
    hs, hl = seqs[:h].cpu(), lens[:h].cpu()
    t0 = time.perf_counter()
    hc = mesh._expected_lattice_counts(eng, hs, hl, stack=tuple(x.cpu() for x in sub))
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pstack = scan.backward_pass(hs, hl, sc.Abwd.cpu(), sc.end.cpu(), sc.begin)
    pc = mesh._expected_lattice_counts(eng, hs, hl, stack=pstack)
    plain_s = time.perf_counter() - t0
    cc = mesh._expected_lattice_counts(eng, seqs[:h], lens[:h], stack=sub, tables=tab)
    host = [rel_err(a.cpu().numpy(), b.numpy(), HOST_ATOL, HOST_RTOL)
            for a, b in zip(cc[:2], hc[:2])]
    plain = [rel_err(a.cpu().numpy(), b.numpy(), HOST_ATOL, HOST_RTOL)
             for a, b in zip(cc[:2], pc[:2])]
    del stack, sub, pstack
    if cuda:
        torch.cuda.empty_cache()

    e_mass = abs(float(E.double().sum()) - n) / n
    ct_mass = abs(float(CT.double().sum()) - n) / n
    one = DistributedTrainer(eng).run(seqs_np, lens_np)
    many = DistributedTrainer(eng, [device] * TRAIN_SHARDS).run(seqs_np, lens_np)
    shards = [rel_err(a, b, SHARD_ATOL, SHARD_RTOL) for a, b in zip(many[:2], one[:2])]
    print(f"[{tag}] B={B}, Lp={Lp}: E-step (td_estep) {kern['ms']:.3f} ms, its plain "
          f"version {kern['plain_ms']:.3f} ms, K1 {k1_ms:.3f} ms, bound "
          f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}); card against host on "
          f"{h} reads (host E-step {host_s:.1f} s): CT {host[0][0]:.3g}, E "
          f"{host[1][0]:.3g} of the tolerance on the card's stack, CT "
          f"{plain[0][0]:.3g}, E {plain[1][0]:.3g} on the host's plain K1 "
          f"({plain_s:.1f} s); |E.sum - n| / n {e_mass:.3g}, "
          f"|CT.sum - n| / n {ct_mass:.3g} (n {n}); {TRAIN_SHARDS} shards against "
          f"1: CT {shards[0][0]:.3g}, E {shards[1][0]:.3g} of the tolerance, "
          f"n {many[2]} / {one[2]}", flush=True)
    if not all(ok for _, ok in host):
        fail(f"{tag}: the card's counts differ from the host's on the same stack")
    if not all(ok for _, ok in plain):
        fail(f"{tag}: the card's K1 and E-step differ from the host's plain K1 "
             "and E-step")
    if max(e_mass, ct_mass) > MASS_RTOL:
        fail(f"{tag}: E.sum or CT.sum is not the bases scored")
    if not all(ok for _, ok in shards) or len({many[2], one[2], n}) != 1:
        fail(f"{tag}: {TRAIN_SHARDS} shards differ from 1")
    return {"estep_ms": kern["ms"], "estep_plain_ms": kern["plain_ms"],
            "estep_max_abs_err": kern["max_abs_err"], "estep_err": kern["err"],
            "estep_err_E": kern["err_E"], "k1_ms": k1_ms, **bd, "host_err": host[0][0],
            "host_err_E": host[1][0], "plain_err": plain[0][0],
            "plain_err_E": plain[1][0], "k1_stack_err": k1["bstack"],
            "k1_log_err": max(k1["blstack"], k1["logpb"]),
            "e_mass": e_mass, "ct_mass": ct_mass,
            "shard_err": shards[0][0], "shard_err_E": shards[1][0], "geometry": geo}


def phase_train(sets: dict, seed: int, n_reads: int = TRAIN_READS,
                device: str = "cuda", **shape) -> dict:
    """The training path: ``train_lattice`` on the flagship and the plate,
    ``train_estep_only`` on the plate + spacer (on the card), then one EM
    iteration over ``n_reads`` generated flagship reads
    (``DistributedTrainer.expected_segment_counts``, then ``reestimate``)
    with the launch counts set to 0 just before it and read just after:
    K1 must have launched and no plain version run on CUDA tensors, and
    every re-estimated emission row must sum to 1 within 1e-3.  Sum logP
    (K4) before and after is reported, not gated.  ``device="cpu"`` and a
    smaller ``shape`` (B, Lp) run the same on the host."""
    import torch

    from tagdust_tpu_torch.engine import fused_kernel, scan
    from tagdust_tpu_torch.engine.cuda import CudaEngine
    from tagdust_tpu_torch.engine.train import reestimate
    from tagdust_tpu_torch.flagship import spacer
    from tagdust_tpu_torch.parallel import mesh
    from tagdust_tpu_torch.parallel.mesh import DistributedTrainer

    out = {}
    for name in ("flagship", "plate"):
        eng = CudaEngine(library_model(sets[name]), device)
        out[name] = train_lattice(name, eng, seed, device=device, **shape)
        del eng
        if device == "cuda":
            torch.cuda.empty_cache()
    if device == "cuda":
        eng = CudaEngine(library_model(sets["plate"], spacer=spacer()), device)
        out["spacer"] = train_estep_only("spacer", eng, sets["plate"], spacer(), seed)
        del eng
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    seqs, lens = read_codes(n_reads, seed + 5, sets["flagship"])
    eng = CudaEngine(library_model(sets["flagship"]), device)
    print(f"[train em] {n_reads} flagship reads generated and the engine built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    trainer = DistributedTrainer(eng)
    for k in fused_kernel.LAUNCHES:
        fused_kernel.LAUNCHES[k] = 0
    scan.PLAIN_CUDA_CALLS["count"] = 0
    mesh.TIMINGS.update(backward_s=0.0, estep_s=0.0, map_s=0.0)
    t0 = time.perf_counter()
    counts = trainer.expected_segment_counts(seqs, lens)
    t1 = time.perf_counter()
    mb2 = reestimate(eng.mb, counts)
    t2 = time.perf_counter()
    launches = dict(fused_kernel.LAUNCHES)
    plain = scan.PLAIN_CUDA_CALLS["count"]
    split = dict(mesh.TIMINGS, reestimate_s=t2 - t1)
    worst = 0.0
    for m in mb2.models:
        for em in (m.m_emit, m.i_emit):
            rows = np.exp(np.asarray(em, np.float64)).sum(axis=-1)
            worst = max(worst, float(np.abs(rows - 1.0).max()))
    before = float(eng.backward_scores(seqs, lens).astype(np.float64).sum())
    after = float(CudaEngine(mb2, device).backward_scores(seqs, lens)
                  .astype(np.float64).sum())
    print(f"[train em] one EM iteration over {n_reads} flagship reads in sub-batches "
          f"of {mesh.estep_reads(eng, seqs.shape[1])}: "
          f"{t2 - t0:.2f} s wall; K1 {split['backward_s']:.2f} s, E-step "
          f"{split['estep_s']:.2f} s, host mapping {split['map_s']:.2f} s, "
          f"reestimate {split['reestimate_s']:.3f} s; launches {launches}, "
          f"plain-on-CUDA calls {plain}; emission rows sum to 1 within {worst:.3g}; "
          f"sum logP before {before:.1f}, after {after:.1f}", flush=True)
    if device == "cuda" and min(launches["bwd"], launches["estep"]) <= 0:
        fail(f"train: K1 or td_estep never launched on the EM iteration: {launches}")
    if plain:
        fail(f"train: plain versions ran {plain} times on CUDA tensors")
    if worst > 1e-3:
        fail(f"train: a re-estimated emission row sums to 1 +- {worst:.3g}")

    # K1's whole output at the shape the EM iteration gave it (its first
    # sub-batch) against its plain version on the same tensors, after the
    # counts were read
    step = min(n_reads, mesh.estep_reads(eng, seqs.shape[1]))
    s = torch.from_numpy(seqs[:step]).to(device)
    ln = torch.from_numpy(lens[:step]).to(device)
    got = eng.scorer.backward(s, ln)
    k1 = k1_against_plain("train em", eng.scorer, s, ln, got)
    del got
    if device == "cuda":
        torch.cuda.empty_cache()
    out["em"] = {"reads": n_reads, "wall_s": t2 - t0, **split,
                 "logP_before": before, "logP_after": after, "row_err": worst,
                 "k1_stack_err": k1["bstack"],
                 "k1_log_err": max(k1["blstack"], k1["logpb"]), "launches": launches}
    return out


# the multihost phase: two processes of ``-multihost`` on the one card, each
# this script in its child mode (``--child``), the CLI in-process; and the
# mesh phase: ShardedScorer over two shards on the card
MH_TIMEOUT = 300
MESH_Q = 10.0
MESH_MINLEN = 16


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def sha256_file(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


SUMMARY_KEYS = ("total input reads", "selected threshold", "successfully extracted",
                "problems with architecture", "barcode / UMI not found", "too short",
                "low complexity", "match artifacts:")


def summary(logfile: str) -> dict:
    """The end-of-run totals and the selected threshold of a logfile."""
    out = {}
    with open(logfile) as fh:
        for line in fh:
            for key in SUMMARY_KEYS:
                if line.rstrip("\n").endswith("\t" + key):
                    out[key] = line.split("]", 1)[1].strip().split("\t")[0]
    return out


def same_outputs(name: str, single: str, other: str) -> int:
    """Every ``<single>_*.fq`` has the sha256 of ``<other>`` with the same
    suffix; -> the files compared."""
    d, base = os.path.split(single)
    files = sorted(f for f in os.listdir(d) if f.startswith(base + "_") and f.endswith(".fq"))
    if not files:
        fail(f"{name}: no output of the single-process run to compare")
    for f in files:
        got = other + f[len(base):]
        if not os.path.exists(got) or sha256_file(got) != sha256_file(os.path.join(d, f)):
            fail(f"{name}: {os.path.basename(got)} differs from the single-process {f}")
    return len(files)


def owned_records(n: int, nproc: int, pid: int) -> int:
    """Records of n in the chunks process ``pid`` of ``nproc`` owns, under
    the controller's chunk schedule (``TAGDUST_TPU_CHUNK``,
    ``TAGDUST_TPU_FIRST_CHUNK``)."""
    chunk = int(os.environ.get("TAGDUST_TPU_CHUNK") or 1000000)
    first = min(chunk, int(os.environ.get("TAGDUST_TPU_FIRST_CHUNK", "131072")))
    owned = start = c = 0
    while start < n:
        size = min(first if c == 0 else chunk, n - start)
        owned += size if c % nproc == pid else 0
        start += size
        c += 1
    return owned


def child(cli_args) -> int:
    """``--child``: one process of the multihost phase.  Creates the CUDA
    context and loads the kernels first (``setup_s``: the parent has paid
    both before its single-process run), then runs the CLI in-process and
    prints one JSON line: its wall, calibration, the launches, the
    streaming counters, the plain versions' calls on CUDA tensors and
    ``max_memory_allocated``."""
    import torch

    cuda = cli_args[cli_args.index("-engine") + 1] == "cuda"
    if cuda and not torch.cuda.is_available():
        fail("no CUDA device")
    from tagdust_tpu_torch import controller
    from tagdust_tpu_torch.engine import build, fused_kernel, runner, scan

    t0 = time.perf_counter()
    if cuda:
        torch.zeros(1, device="cuda")  # the context is created lazily
        torch.cuda.synchronize()
        build.lib()
    setup = time.perf_counter() - t0
    wall = run_tagdust(cli_args)
    print(json.dumps({"wall_s": wall, "setup_s": setup,
                      "calibration_s": controller.TIMINGS["calibration"],
                      "launches": dict(fused_kernel.LAUNCHES),
                      "stream": dict(runner.STREAM_STATS),
                      "plain_cuda": scan.PLAIN_CUDA_CALLS["count"],
                      "max_mem": torch.cuda.max_memory_allocated() if cuda else 0}),
          flush=True)
    return 0


def phase_multihost(single: dict, tmp: str) -> dict:
    """``tagdust -multihost`` as two processes on the one card, each the
    flagship phase's command (``single["args"]``): every merged file must have the
    sha256 of the flagship phase's, the shards and sidecars must be gone,
    both logfiles must give the single run's threshold and totals, each
    process must launch K1, K2 and K3 with no plain version on CUDA tensors,
    host 1 must stream in >= 3 windows with no one-shot after a failure, and
    each host must parse exactly the records of the chunks it owns, skipping
    the rest.  A command with ``-engine torch`` rehearses the same on the
    host's CPU (no card, no launches)."""
    cuda = single["args"][single["args"].index("-engine") + 1] == "cuda"
    if cuda:
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"[multihost] compute mode: {mode}", flush=True)
        if mode != "Default":
            fail(f"multihost: the card's compute mode is {mode}, not Default: two "
                 "processes cannot share it")
    n = int(single["truth"].shape[0])
    out = os.path.join(tmp, "mh_out")
    args = single["args"] + ["-o", out, "-multihost", "-coordinator",
                             f"127.0.0.1:{free_port()}", "-nprocs", "2"]
    env = dict(os.environ, TAGDUST_TPU_IO_STATS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         json.dumps(args + ["-procid", str(pid)])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    try:
        res = [p.communicate(timeout=MH_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, (_, err)) in enumerate(zip(procs, res)):
        if p.returncode != 0:
            fail(f"multihost: host {pid} exited with {p.returncode}:\n{err[-4000:]}")
    hosts = [json.loads(o.strip().splitlines()[-1]) for o, _ in res]
    for pid, h in enumerate(hosts):
        with open(f"{out}.h{pid}.iostats.json") as fh:
            h["io"] = json.load(fh)
        cal = h["calibration_s"]
        print(f"[multihost] host {pid}: {h['setup_s']:.2f} s to create its CUDA "
              f"context and load the kernels, then {h['wall_s']:.2f} s in the CLI "
              f"(calibration {'-' if cal is None else f'{cal:.2f} s'}), launches "
              f"{h['launches']}, streaming {h['stream']}, plain-on-CUDA calls "
              f"{h['plain_cuda']}, max_memory_allocated {h['max_mem']} bytes, records "
              f"parsed {h['io']['parsed']} / skipped {h['io']['skipped']}", flush=True)
    print(f"[multihost] 2 processes on one card: {wall:.2f} s wall (the flagship "
          f"phase's single process: {single['wall_s']:.2f} s in the CLI)", flush=True)
    files = same_outputs("multihost", single["out"], out)
    left = [f for f in os.listdir(tmp) if f.startswith("mh_out.h")
            and not f.endswith(("_logfile.txt", ".iostats.json"))]
    if left:
        fail(f"multihost: shards or sidecars left: {left}")
    want = summary(single["out"] + "_logfile.txt")
    for lf in (out + "_logfile.txt", out + ".h1_logfile.txt"):
        if summary(lf) != want:
            fail(f"multihost: {os.path.basename(lf)} reports {summary(lf)}, the "
                 f"single run {want}")
    for pid, h in enumerate(hosts):
        missing = [k for k in ("bwd", "fwd", "tb") if cuda and h["launches"][k] <= 0]
        if missing:
            fail(f"multihost: host {pid} never launched {missing}")
        if h["plain_cuda"]:
            fail(f"multihost: host {pid} ran plain versions {h['plain_cuda']} times "
                 "on CUDA tensors")
        own = owned_records(n, 2, pid)
        if h["io"]["parsed"] != own or h["io"]["parsed"] + h["io"]["skipped"] != n:
            fail(f"multihost: host {pid} parsed {h['io']['parsed']} and skipped "
                 f"{h['io']['skipped']} records; it owns {own} of {n}")
    if hosts[1]["stream"]["windows"] < 3 or hosts[1]["stream"]["oneshot_after_failure"]:
        fail(f"multihost: host 1 streamed {hosts[1]['stream']}")
    if cuda:
        from tagdust_tpu_torch.engine.cuda import CudaEngine

        # both processes use the one card: each gets half its budget
        peaks = [h["max_mem"] for h in hosts]
        print(f"[multihost] peak allocations on the shared card: host 0 {peaks[0]}, "
              f"host 1 {peaks[1]} bytes, together {sum(peaks)} of STACK_BYTES "
              f"{CudaEngine.STACK_BYTES}", flush=True)
        if sum(peaks) > CudaEngine.STACK_BYTES:
            fail(f"multihost: the two processes' peaks {peaks} sum past one card's "
                 f"STACK_BYTES {CudaEngine.STACK_BYTES}")
    print(f"[multihost] {files} merged files equal the single run's, the logfiles "
          f"its totals ({want})", flush=True)
    return {"wall_s": wall, "hosts": hosts, "launches": {
        k: sum(h["launches"][k] for h in hosts) for k in hosts[0]["launches"]}}


def mesh_rows(name: str, eng, seed: int, device: str = "cuda", B: int = 16384,
              Lp: int = 64) -> None:
    """ShardedScorer over two shards on ``device``: its decided and
    label-carrying rows have the sha256 of the engine's on the kernels
    phase's reads."""
    import torch

    from tagdust_tpu_torch.parallel.mesh import ShardedScorer

    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    lens = rng.integers(40, Lp + 1, B).astype(np.int32)
    sc = ShardedScorer(eng, [device, device])
    thr32 = eng.threshold_f32_ceil(MESH_Q)
    got = {}
    for mode, one, two in (
            ("decided", lambda: [eng.dispatch_decided(seqs, lens, thr32, MESH_MINLEN)],
             lambda: sc.dispatch_decided(seqs, lens, thr32, MESH_MINLEN)),
            ("label-carrying", lambda: [eng.dispatch_packed(seqs, lens)],
             lambda: sc.dispatch_packed(seqs, lens))):
        got[mode] = [digest(torch.cat(f())) for f in (one, two)]
    print(f"[mesh {name}] 2 shards on {device} against one engine, B={B}, Lp={Lp}: "
          + ", ".join(f"{m} rows {a[:16]} / {b[:16]}" for m, (a, b) in got.items()),
          flush=True)
    if any(a != b for a, b in got.values()):
        fail(f"mesh {name}: the sharded rows differ from the engine's")


def mesh_trainer(eng, seed: int, device: str = "cuda", B: int = 16384,
                 Lp: int = 64) -> dict:
    """DistributedTrainer over two shards on ``device`` against one shard
    (rtol 1e-5, atol 1e-6), E.sum and CT.sum against the bases scored
    (1e-4)."""
    from tagdust_tpu_torch.parallel.mesh import DistributedTrainer

    rng = np.random.default_rng(seed + 1)
    seqs = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    lens = rng.integers(40, Lp + 1, B).astype(np.int32)
    one = DistributedTrainer(eng).run(seqs, lens)
    two = DistributedTrainer(eng, [device, device]).run(seqs, lens)
    errs = [rel_err(a, b, SHARD_ATOL, SHARD_RTOL) for a, b in zip(two[:2], one[:2])]
    n = int(lens.sum())
    mass = [abs(float(x.astype(np.float64).sum()) - n) / n for x in two[:2]]
    print(f"[mesh trainer] 2 shards on {device} against 1: CT {errs[0][0]:.3g}, E "
          f"{errs[1][0]:.3g} of the tolerance; |CT.sum - n| / n {mass[0]:.3g}, "
          f"|E.sum - n| / n {mass[1]:.3g} (n {n}, {two[2]} / {one[2]})", flush=True)
    if not all(ok for _, ok in errs) or two[2] != one[2] or one[2] != n:
        fail("mesh: the trainer's two shards differ from one")
    if max(mass) > MASS_RTOL:
        fail("mesh: E.sum or CT.sum is not the bases scored")
    return {"shard_err": errs[0][0], "shard_err_E": errs[1][0], "ct_mass": mass[0],
            "e_mass": mass[1]}


def phase_mesh(sets: dict, single: dict, seed: int, tmp: str) -> dict:
    """``ShardedScorer`` over [cuda:0, cuda:0] (``runner.local_devices``
    replaced in-process): ``mesh_rows`` on the flagship and the plate,
    ``mesh_trainer`` on the flagship, then the flagship phase's reads through
    the CLI with the mesh engaged: the same output bytes, K1-K3 launched,
    >= 3 windows, every window sharded, and the card's peak allocation above
    what the run found allocated inside ``STACK_BYTES``."""
    import torch

    from tagdust_tpu_torch.engine import runner
    from tagdust_tpu_torch.engine.cuda import CudaEngine
    from tagdust_tpu_torch.parallel.mesh import ShardedScorer

    trainer = None
    for name in ("flagship", "plate"):
        eng = CudaEngine(library_model(sets[name]), "cuda")
        mesh_rows(name, eng, seed)
        if name == "flagship":
            trainer = mesh_trainer(eng, seed)
        del eng
        torch.cuda.empty_cache()

    devs = [torch.device("cuda", 0)] * 2
    sharded = [0]
    real_devices, real_dispatch = runner.local_devices, ShardedScorer.dispatch_decided

    def dispatch(self, *a):
        sharded[0] += 1
        return real_dispatch(self, *a)

    runner.local_devices = lambda: list(devs)
    ShardedScorer.dispatch_decided = dispatch
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = os.path.join(tmp, "mesh_out")
        res = run_path("mesh", single["args"] + ["-o", out],
                       path_kernels("mesh", sets["flagship"]))
        peak = torch.cuda.max_memory_allocated()
    finally:
        runner.local_devices, ShardedScorer.dispatch_decided = real_devices, real_dispatch
    budget = CudaEngine.STACK_BYTES
    print(f"[mesh] the CLI over 2 shards on cuda:0: {res['wall_s']:.2f} s (one engine: "
          f"{single['wall_s']:.2f} s), {sharded[0]} sharded windows; peak allocation "
          f"{peak} bytes, {before} allocated when the run started, budget {budget}",
          flush=True)
    if sharded[0] < 3:
        fail(f"mesh: only {sharded[0]} windows went through the shards")
    if peak - before > budget:
        fail(f"mesh: the card's peak allocation grew {peak - before} bytes, over "
             f"STACK_BYTES {budget}")
    files = same_outputs("mesh", single["out"], out)
    print(f"[mesh] {files} output files equal the single engine's", flush=True)
    return dict(res, sharded_windows=sharded[0], peak_bytes=peak, trainer=trainer)


# the entry phase: the entry points (tagdust_tpu_torch/entry.py) and the
# benches (tagdust_tpu_torch/bench/); reads of the e2e bench's input,
# made by cli.simreads in a child process started with the script
ENTRY_E2E_READS = 200_000
ENTRY_F_ATOL = 1e-4
ENTRY_Q_ATOL = 1e-2


def start_e2e_input() -> subprocess.Popen:
    """Start making the e2e bench's cached input (``bench.e2e
    --make-input``: ``cli.simreads`` of ``ENTRY_E2E_READS`` reads, a
    single-threaded host loop) in a child process, so that it overlaps the
    phases before the entry phase."""
    return subprocess.Popen(
        [sys.executable, "-m", "tagdust_tpu_torch.bench.e2e", "--make-input",
         "--reads", str(ENTRY_E2E_READS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.DEVNULL)


@contextlib.contextmanager
def environ(**values):
    """The environment with ``values`` set, restored afterwards."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def counted(fn):
    """(``fn()``, its kernel launches, its plain calls on CUDA tensors), the
    counts set to 0 just before and read just after."""
    from tagdust_tpu_torch.engine import fused_kernel, scan

    for k in fused_kernel.LAUNCHES:
        fused_kernel.LAUNCHES[k] = 0
    scan.PLAIN_CUDA_CALLS["count"] = 0
    out = fn()
    return out, dict(fused_kernel.LAUNCHES), scan.PLAIN_CUDA_CALLS["count"]


def entry_against_plain(device: str = "cuda") -> dict:
    """``entry()`` on ``device`` against ``entry(device="cpu")`` (the plain
    versions) on the same inputs: labels equal, f within ENTRY_F_ATOL, Q
    within ENTRY_Q_ATOL."""
    import torch

    from tagdust_tpu_torch.entry import entry

    fn, args = entry(device)
    got = [t.cpu() for t in fn(*args)]
    fn, args = entry("cpu")
    ref = fn(*args)
    f_err, f_ok = close(got[0], ref[0], ENTRY_F_ATOL, 0.0)
    q_err, q_ok = close(got[4], ref[4], ENTRY_Q_ATOL, 0.0)
    same = torch.equal(got[3], ref[3])
    print(f"[entry] entry() on {device} against the plain versions, B={args[0].shape[0]}, "
          f"L={args[0].shape[1]}: labels {'equal' if same else 'DIFFER'}, max |f| "
          f"{f_err:.3g} (atol {ENTRY_F_ATOL}), max |Q| {q_err:.3g} (atol {ENTRY_Q_ATOL})",
          flush=True)
    if not (same and f_ok and q_ok):
        fail("entry: the scoring step disagrees with its plain versions")
    return {"f_err": f_err, "q_err": q_err}


def entry_nibble_rows(eng, seed: int, B: int = 16384, Lp: int = 64) -> None:
    """``dispatch_decided``'s rows, and ``run_batch_fused``'s Q and labels, bit
    for bit equal under TAGDUST_TPU_NIBBLE=1 and 0 on seeded reads with N
    codes."""
    import torch

    rng = np.random.default_rng(seed + 5)
    seqs = rng.integers(0, 5, (B, Lp)).astype(np.uint8)
    lens = rng.integers(Lp * 5 // 8, Lp + 1, B).astype(np.int32)  # 40-64 at 64
    thr32 = eng.threshold_f32_ceil(MESH_Q)
    rows, fused = {}, {}
    for nib in ("1", "0"):
        with environ(TAGDUST_TPU_NIBBLE=nib):
            rows[nib] = eng.dispatch_decided(seqs, lens, thr32, MESH_MINLEN).cpu()
            res = eng.run_batch_fused(seqs, lens)
            fused[nib] = (res.mapq.tobytes(), res.labels.tobytes())
    print(f"[entry] decided rows at B={B}, Lp={Lp} under TAGDUST_TPU_NIBBLE=1 / 0: "
          f"{digest(rows['1'])[:16]} / {digest(rows['0'])[:16]}; run_batch_fused's Q "
          f"and labels {'equal' if fused['1'] == fused['0'] else 'DIFFER'}", flush=True)
    if not torch.equal(rows["1"], rows["0"]) or fused["1"] != fused["0"]:
        fail("entry: the nibble-packed upload changed the rows")


def entry_decisions(fq: str, bcs, tmp: str, device: str = "cuda") -> dict:
    """The flagship library over ``fq`` through the CLI at ``-Q 10``, decided
    (the default) and under TAGDUST_TPU_DEVICE_DECISIONS=0: every output file
    with the decided run's sha256, the first run's windows all decided rows
    and the second's all label-carrying rows.  -> the two runs' launches."""
    from tagdust_tpu_torch.engine.cuda import CudaEngine

    calls = {"dispatch_decided": 0, "dispatch_packed": 0}
    real = {name: getattr(CudaEngine, name) for name in calls}

    def spy(name):
        def call(self, *a, **k):
            calls[name] += 1
            return real[name](self, *a, **k)

        return call

    expect = path_kernels("entry", bcs) if device == "cuda" else []
    engine = "cuda" if device == "cuda" else "torch"
    outs, runs = {}, {}
    for name in calls:
        setattr(CudaEngine, name, spy(name))
    try:
        for mode in ("1", "0"):
            outs[mode] = os.path.join(tmp, f"entry_decisions{mode}")
            for name in calls:
                calls[name] = 0
            with environ(TAGDUST_TPU_DEVICE_DECISIONS=mode):
                runs[mode] = run_path(
                    f"entry DEVICE_DECISIONS={mode}",
                    ["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-Q", "10",
                     "-engine", engine, "-o", outs[mode]], expect)
            runs[mode]["calls"] = dict(calls)
    finally:
        for name, fn in real.items():
            setattr(CudaEngine, name, fn)
    print(f"[entry] windows decided / label-carrying: DEVICE_DECISIONS=1 "
          f"{runs['1']['calls']}, =0 {runs['0']['calls']}; walls "
          f"{runs['1']['wall_s']:.2f} / {runs['0']['wall_s']:.2f} s", flush=True)
    if runs["1"]["calls"]["dispatch_packed"] or runs["0"]["calls"]["dispatch_decided"]:
        fail("entry: TAGDUST_TPU_DEVICE_DECISIONS did not choose the rows")
    files = same_outputs("entry DEVICE_DECISIONS=0", outs["1"], outs["0"])
    print(f"[entry] {files} output files under DEVICE_DECISIONS=0 equal the decided "
          "run's (sha256)", flush=True)
    return runs


def phase_entry(sets: dict, timing: dict, seed: int, tmp: str, maker) -> dict:
    """The entry points and the benches on the card (each step
    fatal): ``entry()`` against its plain versions; ``dryrun_multichip(2)``
    with K1-K3 and ``td_estep`` launched and no plain version on CUDA
    tensors; ``bench.kernels`` at full size beside the kernels phase's
    flagship B / (K1+K2+K3); ``bench.e2e`` over ``ENTRY_E2E_READS`` reads,
    one trial after the warm-up, at ``-Q 10`` and at default flags;
    ``bench.multichip`` at 1 and 2 shards; the A/B switches
    (``entry_nibble_rows``, ``entry_decisions``).  The launches of every
    step but the first (a comparison with the plain versions) count."""
    import torch

    from tagdust_tpu_torch.bench import card, e2e, kernels, multichip
    from tagdust_tpu_torch.engine.fused_kernel import LAUNCHES
    from tagdust_tpu_torch.entry import dryrun_multichip, flagship_engine

    t0 = time.perf_counter()
    entry_against_plain()
    launches = dict.fromkeys(LAUNCHES, 0)

    def step(name: str, fn, need=()):
        out, got, plain = counted(fn)
        for k in launches:
            launches[k] += got[k]
        missing = [k for k in need if got[k] <= 0]
        if missing or plain:
            fail(f"entry {name}: kernels not launched {missing}, plain versions on "
                 f"CUDA tensors {plain}")
        return out

    step("dryrun_multichip", lambda: dryrun_multichip(2), ("bwd", "fwd", "tb", "estep"))
    rec = step("bench.kernels", kernels.measure, ("bwd", "fwd", "tb"))
    print(json.dumps(rec), flush=True)
    if all((k, "flagship") in timing for k in ("bwd", "fwd", "tb")):
        ms = sum(timing[k, "flagship"]["ms"] for k in ("bwd", "fwd", "tb"))
        print(f"[entry] bench.kernels {rec['value']:.0f} reads/s beside the kernels "
              f"phase's flagship B / (K1+K2+K3) = {16384 / ms * 1e3:.0f} reads/s "
              f"({ms:.3f} ms, lengths 40-64)", flush=True)
    if maker.wait(timeout=600):
        fail(f"entry: the e2e input was not made (exit {maker.returncode})")
    fq = e2e.make_input(ENTRY_E2E_READS)
    where = card(torch.device("cuda", torch.cuda.current_device()))
    for calibration in (False, True):
        rec = step("bench.e2e", lambda: e2e.bench(fq, "cuda", 1, calibration),
                   ("bwd", "fwd", "tb"))
        print(json.dumps({**rec, **where}), flush=True)
    for rec in step("bench.multichip", lambda: list(multichip.measure(shards=(1, 2))),
                    ("bwd", "fwd", "tb")):
        print(json.dumps(rec), flush=True)
    eng = flagship_engine()
    step("TAGDUST_TPU_NIBBLE", lambda: entry_nibble_rows(eng, seed), ("bwd", "fwd", "tb"))
    del eng
    runs = entry_decisions(fq, sets["flagship"], tmp)
    for r in runs.values():
        for k in launches:
            launches[k] += r["launches"][k]
    wall = time.perf_counter() - t0
    print(f"[entry] {wall:.1f} s; launches {launches}", flush=True)
    return {"launches": launches, "wall_s": wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run instead of all of them ("
                    + ", ".join(PHASES) + "); the last line then says so")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(json.loads(args.child))
    only = [p for p in args.only.split(",") if p]
    if set(only) - set(PHASES):
        ap.error(f"--only takes {', '.join(PHASES)}")
    on = lambda phase: not only or phase in only  # noqa: E731

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    # the entry phase's input is made meanwhile, and the child ends with the script
    maker = start_e2e_input() if on("entry") else None
    try:
        return run(args, only, on, maker)
    finally:
        if maker is not None and maker.poll() is None:
            maker.kill()
            maker.wait()


def run(args, only: list, on, maker) -> int:
    """The phases of ``main``."""
    import torch

    from tagdust_tpu_torch.engine import build
    from tagdust_tpu_torch.engine.cuda import CudaEngine
    from tagdust_tpu_torch.flagship import spacer

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")
    try:
        import triton

        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")

    t0 = time.perf_counter()
    build.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.init()

    sets = barcode_sets()
    timing = {}  # (counter, model) -> measurements
    if on("kernels") or on("gate") or on("digest"):
        models = {name: CudaEngine(library_model(b), "cuda") for name, b in sets.items()}
        kmodels = dict(models, **{
            "R:N": CudaEngine(library_model([]), "cuda"),
            "spacer": CudaEngine(library_model(sets["plate"], spacer=spacer()), "cuda")})
    if on("kernels"):
        for name, grouped, full in KERNEL_RUNS:
            for key, r in phase_kernels(kmodels[name], grouped, args.seed, full).items():
                timing[key, name] = r
        phase_k3_long(kmodels["flagship"], args.seed)
    if on("myers"):
        timing["myers", "myers"] = phase_myers(args.seed)
    print(f"kernel times above on: {card}", flush=True)
    if on("digest"):
        phase_digest(kmodels, args.seed)
    if on("gate"):
        phase_gate(dict(models, spacer=kmodels["spacer"]), args.seed)
        print(f"gate times above on: {card}", flush=True)
    models = kmodels = None
    torch.cuda.empty_cache()

    launches = {k: 0 for k, *_ in KERNELS}
    paths = {}
    tmp = tempfile.mkdtemp(prefix="tagdust_smoke_")
    try:
        if on("flagship") or on("sub") or on("multihost") or on("mesh"):
            # a fixed calibration seed (-seed; 0 seeds from the clock): the
            # multihost and mesh phases rerun this command and must select
            # the same threshold
            paths["flagship"] = phase_main("flagship", sets["flagship"], args.seed,
                                           args.reads, tmp,
                                           flags=("-seed", str(args.seed + 1)))
        if on("8-plex"):
            paths["8-plex"] = phase_main("8-plex", sets["8"], args.seed, SMALL_READS, tmp)
        if on("arch"):
            paths["arch"] = phase_arch(sets, args.seed, args.reads, tmp)
        if on("ref"):
            paths["ref"] = phase_ref(sets["flagship"], args.seed, args.reads, tmp)
        if on("sub"):
            m = paths["flagship"]
            paths["sub"] = phase_sub(sets["flagship"], m["fq"], m["truth"], args.reads,
                                     tmp)
        if on("train"):
            train = phase_train(sets, args.seed)
            paths["train"] = {"launches": train["em"]["launches"]}
            p = train["plate"]
            timing["estep", "plate"] = {
                "max_abs_err": p["estep_max_abs_err"], "ms": p["estep_ms"],
                "plain_ms": p["estep_plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": p["bound_by"]}
            print(f"train times above on: {card}", flush=True)
        if on("multihost"):
            paths["multihost"] = phase_multihost(paths["flagship"], tmp)
        if on("mesh"):
            paths["mesh"] = phase_mesh(sets, paths["flagship"], args.seed, tmp)
        if on("entry"):
            paths["entry"] = phase_entry(sets, timing, args.seed, tmp, maker)
            print(f"entry times above on: {card}", flush=True)
        for r in paths.values():
            for k in launches:
                launches[k] += r["launches"][k]
        print(f"launches on the main paths {list(paths)}: {launches}", flush=True)
        print(f"main path times above on: {card}", flush=True)
        if on("cross"):
            for name in ("flagship", "8-plex"):
                if name in paths:
                    bcs = sets["flagship" if name == "flagship" else "8"]
                    phase_cross(name, paths[name]["fq"], tmp,
                                ["-1", f"B:{','.join(bcs)}", "-2", "R:N"], bcs,
                                torch_leg=True)
            if "arch" in paths:
                phase_cross("arch", paths["arch"]["fq"], tmp,
                            ["-arch", paths["arch"]["cands"]], sets["plate"])
            if "sub" in paths:
                bcs = sets["flagship"]
                phase_cross("sub", paths["flagship"]["fq"], tmp,
                            ["-1", f"B:{','.join(bcs)}", "-2", "R:N", *SUB_FLAGS], bcs)
        if on("long"):
            phase_long(sets["plate"], args.seed, tmp)
            print(f"long-read times above on: {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    need = [] if only else ["bwd", "fwd", "tb", "score", "myers"]
    if on("train"):
        need.append("estep")
    if need and min(launches[k] for k in need) <= 0:
        fail(f"a kernel launched on no main path: {launches}")

    # no single PyTorch call computes these recurrences: library_ms is null
    rec = {"kernels": [
        {"name": name, "route": "cuda",
         "source": SOURCES.get(key, SOURCE), "replaces": rep,
         "launches": launches[key], **{f: timing[key, model][f] for f in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for key, name, rep, model in KERNELS if (key, model) in timing
    ]}
    if on("train"):
        print(json.dumps({"train": train}))
    print(card_line())
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}, **({"only": only} if only else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
