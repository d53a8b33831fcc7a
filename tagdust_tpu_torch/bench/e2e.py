"""End-to-end CLI throughput: reads/s through the whole pipeline (read,
score, extract, filter, write), with the time of each stage.

The counterpart of ``bench_e2e.py``.  The input is made once by the port's
``cli.simreads`` over the flagship barcode file (``flagship.PATH``:
``-seed 42 -sim_barnum 8 -sim_readlen 50 -sim_random_frac 0.1``) and cached
in the temp dir with its arch file beside it.  Each trial is a complete
``controller.hmm_controller_multiple`` run with ``-arch`` on that arch file
(a fresh output directory), with the stage timers patched on for the run
and restored after it: stats prepass, calibration, labelling and
extraction, parsing, writing (cumulative seconds of threads that overlap,
not slices of the wall), beside ``controller.TIMINGS`` (detection,
calibration).  One warm-up run comes first and is excluded.

``-Q 10`` by default; ``--calibration`` runs default flags (no ``-Q``, so
each trial calibrates its threshold; ``-seed 42`` pins the simulation).
``--engine cuda`` (the default) runs the kernels on the card, ``exact`` the
C-parity host engine, ``both`` cuda then exact, and the cuda line quotes its
rate against the exact engine's on the same host (``vs_exact_engine``);
``torch`` (the plain versions on the CPU) is for the tests and needs
``--device cpu``.  Without a card, only ``--device cpu`` runs.

    python -m tagdust_tpu_torch.bench.e2e [--reads 1000000] [--trials 3]
        [--engine cuda|exact|both|torch] [--calibration] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the simulated reads: 50nt after the barcode, the first 8 barcodes of the
# flagship file (bench_e2e.py's settings), 10% random; -Q of the runs
# without calibration
READLEN = 50
BARNUM = 8
Q = 10.0


def input_path(n_reads: int) -> str:
    """The cached simreads FASTQ of ``n_reads`` reads (its arch file is
    ``<path>_tagdust_arch.txt``)."""
    key = hashlib.md5(f"{n_reads}:{READLEN}:{BARNUM}".encode()).hexdigest()[:10]
    return os.path.join(tempfile.gettempdir(), f"tagdust_torch_e2e_{key}.fq")


def make_input(n_reads: int) -> str:
    """``input_path``, made by ``cli.simreads`` unless it is there; written
    under a temporary name and renamed, so an interrupted run leaves no
    cached half."""
    from ..flagship import PATH

    fq = input_path(n_reads)
    arch = fq + "_tagdust_arch.txt"
    if os.path.exists(fq) and os.path.exists(arch):
        return fq
    part = f"{fq}.{os.getpid()}.part"
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run(
        [sys.executable, "-m", "tagdust_tpu_torch.cli.simreads", PATH,
         "-seed", "42", "-sim_barnum", str(BARNUM), "-sim_readlen", str(READLEN),
         "-sim_readlen_mod", "0", "-sim_numseq", str(n_reads), "-sim_endloss", "0",
         "-sim_random_frac", "0.1", "-o", part],
        check=True, env=env, cwd=tempfile.gettempdir(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    os.replace(part + "_tagdust_arch.txt", arch)
    for extra in ("_btrim_pattern.txt", "_fastxbarcodefile.txt"):
        if os.path.exists(part + extra):
            os.remove(part + extra)
    os.replace(part, fq)
    return fq


def run_once(fq: str, engine: str, outdir: str, calibration: bool = False) -> dict:
    """One CLI run of ``fq`` with ``-arch`` on its arch file: its wall, reads,
    stage seconds, ``controller.TIMINGS`` and kernel launches."""
    from .. import controller as ctl
    from ..config import parse_args
    from ..engine import fused_kernel
    from ..io.fastq import SeqReader
    from ..io.writer import DemuxWriter

    args = [fq, "-arch", fq + "_tagdust_arch.txt", "-o", os.path.join(outdir, "out"),
            "-engine", engine]
    args += ["-seed", "42"] if calibration else ["-Q", str(Q)]
    param = parse_args(args)
    log = ctl.MessageLog()
    stages = dict.fromkeys(
        ("stats_prepass", "calibration", "label_extract", "parse", "write"), 0.0)

    def timed(key, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stages[key] += time.perf_counter() - t0

        return wrap

    patches = [(ctl, "estimate_q_threshold", "calibration"),
               (ctl, "get_sequence_stats", "stats_prepass"),
               (ctl, "run_get_label_batch", "label_extract"),
               (SeqReader, "read_chunk_batch", "parse"),
               (DemuxWriter, "write_batch_columnar", "write")]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    launches0 = dict(fused_kernel.LAUNCHES)
    with open(os.devnull, "w") as devnull:
        old_err, sys.stderr = sys.stderr, devnull  # the run's log
        try:
            for obj, name, key in patches:
                setattr(obj, name, timed(key, getattr(obj, name)))
            t0 = time.perf_counter()
            ctl.hmm_controller_multiple(param, log=log)
            dt = time.perf_counter() - t0
        finally:
            sys.stderr = old_err
            for obj, name, orig in originals:
                setattr(obj, name, orig)
    total = 0
    for m in log.messages:
        # "[stamp]\t<N>\ttotal input reads\n"
        if "total input reads" in m:
            total = int(m.split("]", 1)[1].strip().split("\t")[0])
    return {"seconds": dt, "reads": total, "stage_seconds": stages,
            "timings": dict(ctl.TIMINGS),
            "launches": {k: v - launches0[k] for k, v in fused_kernel.LAUNCHES.items()}}


def bench(fq: str, engine: str, trials: int, calibration: bool = False) -> dict:
    """One engine's JSON record: ``trials`` runs after a warm-up run."""
    runs, warmup = [], None
    for t in range(trials + 1):
        with tempfile.TemporaryDirectory() as outdir:
            r = run_once(fq, engine, outdir, calibration)
        if t == 0:
            warmup = r["seconds"]
        else:
            runs.append(r)
    secs = [r["seconds"] for r in runs]
    reads = runs[0]["reads"]
    med_s = statistics.median(secs)
    mid = min(runs, key=lambda r: abs(r["seconds"] - med_s))
    flags = "default flags incl. calibration" if calibration else f"-Q {Q:g}"
    return {
        "metric": f"e2e CLI reads/s ({engine} engine, {flags}, -arch of {BARNUM} x 6nt "
                  f"barcodes of the flagship set, {READLEN}nt reads)",
        "value": reads / med_s, "unit": "reads/s", "best": reads / min(secs),
        "reads": reads, "trial_seconds": secs, "warmup_seconds_excluded": warmup,
        "stage_seconds": mid["stage_seconds"],
        "detection_seconds": [r["timings"]["detection"] for r in runs],
        "calibration_seconds": [r["timings"]["calibration"] for r in runs],
        "launches": mid["launches"],
    }


def main(argv=None) -> int:
    from ..entry import resolve_device
    from . import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1000000)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--engine", default="cuda",
                    choices=["cuda", "exact", "both", "torch"])
    ap.add_argument("--calibration", action="store_true",
                    help="default flags: no -Q, each trial calibrates its threshold")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; needs the card) or cpu (for "
                    "--engine torch or exact)")
    ap.add_argument("--make-input", action="store_true",
                    help="only make (or find) the cached input and print its path")
    args = ap.parse_args(argv)
    if args.make_input:
        print(make_input(args.reads), flush=True)
        return 0
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if args.engine in ("cuda", "both") and not on_card:
        ap.error(f"--engine {args.engine} runs on the card, not --device cpu")
    if args.engine == "torch" and on_card:
        ap.error("--engine torch runs the plain versions on the CPU: pass --device cpu")

    fq = make_input(args.reads)
    engines = ["cuda", "exact"] if args.engine == "both" else [args.engine]
    recs = {e: bench(fq, e, args.trials, args.calibration) for e in engines}
    if "exact" in recs and "cuda" in recs:
        recs["cuda"]["vs_exact_engine"] = recs["cuda"]["value"] / recs["exact"]["value"]
    where = card(dev)
    for rec in recs.values():
        print(json.dumps({**rec, **where}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
