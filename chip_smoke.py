#!/usr/bin/env python3
"""Smoke run of tagdust_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--reads N]

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
   where K1/K4 or K2 stage their step tables in shared memory, K1 or K2 is
   timed with them left in L2 too; K3 at long reads (B=1024, Lp=4224, the
   flagship lattice) against the plain traceback, exact;
4. gate: dense against grouped K1, K2 and K4 at 8, 20, 48 and 96
   barcodes; the engine runs every kernel dense unless grouped is forced,
   so dense must be the faster mode of each; the dense kernels alone on
   the plate + spacer;
5. main paths, each through the port's CLI entry point with the launch
   counts set to 0 just before it and read just after; every kernel of the
   path must have launched, no plain version may run on CUDA tensors,
   every read must be written, barcode precision >= 0.99:
   a. a default-flag ``tagdust -engine cuda`` run over a generated 1M-read
      flagship FASTQ (per-run calibration, streaming decided labelling);
   b. the same over 200k reads of an 8 x 6nt library (dense step mode);
   c. ``tagdust -arch`` over a generated 1M-read 96-plex FASTQ with the
      flagship, the plate and R:N as candidates: detection on the card
      (K4), then the plate's demultiplex; the plate must win;
   each prints its step mode and the launches of each kernel;
6. cross-checks against ``-engine exact`` on the first 20,000 reads, at
   ``-Q 20`` (a threshold of 0.0: with ``-Q`` the reference does not
   calibrate): the flagship, the 8-plex, and the ``-arch`` run (the same
   winner and confidence); per-read outcomes must agree on >= 99.9%, and
   the reads that differ are listed with Q on both engines; the flagship
   and the 8-plex also run ``-engine torch`` (the plain versions, on the
   CPU), and at most 0.01% of the reads may decide apart from the card on
   the label path;
7. long reads: 200 reads of the plate library, 5,410-5,470nt (padded to
   5,472), through the CLI on ``-engine cuda`` and ``-engine exact`` at
   ``-Q 20``: every read written, K1-K3 launched and no plain version on
   CUDA tensors, no launch's buffers over ``CudaEngine.STACK_BYTES``; it
   prints the largest sub-batch and ``torch.cuda.max_memory_allocated()``
   and lists the reads that decide apart from the exact engine.

The line before the last is the kernels' JSON record: per kernel its
times, its launches on the main paths, and its bound on this card (the
larger of the bytes it must move over 3.35 TB/s and the f32 operations the
inputs need over 67 TFLOP/s, ``bound``; K3's path reads at 32-byte sector
granularity); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SOURCE = "tagdust_tpu_torch/engine/csrc/fused_dp.cu"
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
              "staged (0 none, 1 label tables, 2 and step tables), blocks per SM: "
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
    """Where ``kernel`` ("bwd" or "fwd") stages its step tables in shared
    memory, time ``fn`` with them left in L2 too (the staging level forced);
    ``same(fn())`` must hold at both levels."""
    if sc.staged(kernel) != 2:
        return
    bare = int(kernel == "fwd")  # K2 keeps its label tables staged
    ms = {}
    for level in (bare, 2):
        sc._stage[kernel] = level
        ms[level] = timed(fn)
        if not same(fn()):
            fail(f"{kernel} differs at staging level {level}")
    print(f"[{tag}] {'K2' if bare else 'K1'} step tables in shared memory "
          f"{ms[2]:.3f} ms, in L2 {ms[bare]:.3f} ms", flush=True)


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


BARCODE_SUB = 0.05


def write_fastq(path: str, n: int, seed: int, barcodes,
                lengths: tuple = (50, 60)) -> np.ndarray:
    """90% of reads: a barcode of the set (5% substitutions) then a random
    insert, ``lengths`` (50-60nt) in all; 10% random reads.  Returns the
    true barcode index of each read (-1 for random reads)."""
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
    with open(path, "wb", buffering=1 << 24) as fh:
        step = 100000
        for s in range(0, n, step):
            parts = []
            for i in range(s, min(s + step, n)):
                r = seq[i, : lens[i]].tobytes()
                parts.append(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * lens[i]))
            fh.write(b"".join(parts))
    return truth


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
    from tagdust_tpu_torch import controller
    from tagdust_tpu_torch.engine import fused_kernel, runner, scan

    for k in fused_kernel.LAUNCHES:
        fused_kernel.LAUNCHES[k] = 0
    scan.PLAIN_CUDA_CALLS["count"] = 0
    runner.STREAM_STATS["windows"] = 0
    wall = run_tagdust(args)
    launches = dict(fused_kernel.LAUNCHES)
    windows = runner.STREAM_STATS["windows"]
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
    if plain:
        fail(f"{name}: plain versions ran {plain} times on CUDA tensors")
    return {"wall_s": wall, "detection_s": det, "calibration_s": cal,
            "launches": launches}


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


def phase_main(name: str, bcs, seed: int, n_reads: int, tmp: str) -> dict:
    """A default-flag ``tagdust -1 B:<bcs> -2 R:N -engine cuda`` run."""
    fq = os.path.join(tmp, f"{name}.fq")
    t0 = time.perf_counter()
    truth = write_fastq(fq, n_reads, seed, bcs)
    print(f"[{name}] generated {n_reads} reads in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = os.path.join(tmp, f"{name}_out")
    res = run_path(name, ["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-o", out,
                          "-engine", "cuda"], path_kernels(name, bcs))
    print(f"[{name}] {n_reads / res['wall_s']:.0f} reads/s", flush=True)
    check_output(name, out, bcs, truth)
    return dict(res, fq=fq)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=1_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
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
    models = {name: CudaEngine(library_model(b), "cuda") for name, b in sets.items()}
    kmodels = dict(models, **{
        "R:N": CudaEngine(library_model([]), "cuda"),
        "spacer": CudaEngine(library_model(sets["plate"], spacer=spacer()), "cuda")})
    timing = {}  # (counter, model) -> measurements
    for name, grouped, full in KERNEL_RUNS:
        for key, r in phase_kernels(kmodels[name], grouped, args.seed, full).items():
            timing[key, name] = r
    phase_k3_long(kmodels["flagship"], args.seed)
    print(f"kernel times above on: {card}", flush=True)
    phase_gate(dict(models, spacer=kmodels["spacer"]), args.seed)
    print(f"gate times above on: {card}", flush=True)
    del models, kmodels
    torch.cuda.empty_cache()

    launches = {k: 0 for k, *_ in KERNELS}
    tmp = tempfile.mkdtemp(prefix="tagdust_smoke_")
    try:
        m = phase_main("flagship", sets["flagship"], args.seed, args.reads, tmp)
        small = phase_main("8-plex", sets["8"], args.seed, SMALL_READS, tmp)
        arch = phase_arch(sets, args.seed, args.reads, tmp)
        for r in (m, small, arch):
            for k in launches:
                launches[k] += r["launches"][k]
        print(f"launches on the three main paths: {launches}", flush=True)
        print(f"main path times above on: {card}", flush=True)
        for name, r in (("flagship", m), ("8-plex", small)):
            bcs = sets["flagship" if name == "flagship" else "8"]
            phase_cross(name, r["fq"], tmp, ["-1", f"B:{','.join(bcs)}", "-2", "R:N"],
                        bcs, torch_leg=True)
        phase_cross("arch", arch["fq"], tmp, ["-arch", arch["cands"]],
                    sets["plate"])
        phase_long(sets["plate"], args.seed, tmp)
        print(f"long-read times above on: {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if min(launches[k] for k in ("bwd", "fwd", "tb", "score")) <= 0:
        fail(f"a dense kernel launched on no main path: {launches}")

    # no single PyTorch call computes these recurrences: library_ms is null
    rec = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": rep,
         "launches": launches[key], **{f: timing[key, model][f] for f in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for key, name, rep, model in KERNELS
    ]}
    print(card_line())
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
