#!/usr/bin/env python3
"""Where one position of the dense K1 (``td_bwd``) and K2 (``td_fwd``), and
of the E-step kernel ``td_estep``, goes, in SM cycles, on one CUDA card.

    python3 step_profile.py [--seed N] [--models flagship,plate] [--estep]

(models: 8, flagship, 48, plate, and R:N, on which only K1 runs.  With
``--estep``: ``td_estep`` on the models' K1 stacks instead, from a copy of
``csrc/estep.cu`` probed the same way, block parts only, per
CTA-tile-position, and its final flush per block.)

Builds a copy of ``tagdust_tpu_torch/engine/csrc/fused_dp.cu`` with
``clock64()`` probes written into it (under ``build/step_profile/``; the
source itself carries no probe), loads it in place of the kernel library,
and runs K1 then K2 once on each model at B = 16,384, Lp = 64, lengths
40-64 (``chip_smoke.py``'s kernels-phase inputs).  Two kinds of probe:

* block parts: thread 0 reads the clock after each ``__syncthreads()`` of
  the position loop, so a part is the time from one barrier to the next
  (its slowest warp and the barrier);
* warp parts, inside a barrier interval: lane 0 of each warp sums the
  time of its own share (light outputs, heavy outputs, spill); the table
  gives the slowest warp's sum.

Each is printed in cycles per (block, position): the sums over all
blocks and positions divided by blocks x Lp.  The probes are atomic adds
whose results go unused (``red`` instructions), a few per warp and
position.  The instrumented kernel's time (CUDA events, median of 3) is
printed beside the sum of its parts; the card's name, power limit and
highest SM clock close the output.  The probes are placed by the text of
the source: ``PROBES`` names the lines of ``fused_dp.cu`` that anchor them,
``ESTEP_PROBES`` the ``/* TD_PROBE(name) */`` comments of ``estep.cu``, and
the script fails on a source whose anchors it does not find.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

import chip_smoke as cs

SOURCE = "tagdust_tpu_torch/engine/csrc/fused_dp.cu"
ESTEP_SOURCE = "tagdust_tpu_torch/engine/csrc/estep.cu"
OUT_DIR = os.path.join("build", "step_profile")

PRELUDE = r"""
__device__ unsigned long long td_blk[16];
__device__ unsigned long long td_wrp[16 * 32];
__device__ unsigned long long td_nblk;
#define TD_BEGIN long long td_t = clock64(); \
  if (threadIdx.x == 0) atomicAdd(&td_nblk, 1ull);
#define TD_BLK(k) if (threadIdx.x == 0) { const long long t_ = clock64(); \
  atomicAdd(&td_blk[k], (unsigned long long)(t_ - td_t)); td_t = t_; }
#define TD_WSTART long long td_w = clock64();
#define TD_WRP(k) if ((threadIdx.x & 31) == 0) { const long long t_ = clock64(); \
  atomicAdd(&td_wrp[(k) * 32 + (threadIdx.x >> 5)], (unsigned long long)(t_ - td_w)); \
  td_w = t_; }
"""

EPILOGUE = r"""
extern "C" int td_prof_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, td_blk, sizeof(td_blk));
  cudaMemcpyFromSymbol(out + 16, td_wrp, sizeof(td_wrp));
  cudaMemcpyFromSymbol(out + 16 + 16 * 32, td_nblk, sizeof(td_nblk));
  return (int)cudaGetLastError();
}
extern "C" int td_prof_reset() {
  unsigned long long z[16 + 16 * 32 + 1] = {0};
  cudaMemcpyToSymbol(td_blk, z, sizeof(td_blk));
  cudaMemcpyToSymbol(td_wrp, z + 16, sizeof(td_wrp));
  cudaMemcpyToSymbol(td_nblk, z + 16 + 16 * 32, sizeof(td_nblk));
  return (int)cudaDeviceSynchronize();
}
"""

# (function, [(anchor, replacement)]) edits, applied inside the text of the
# function, each anchor exactly once ("SYNC", n: a block probe after each of
# the n barriers of the position loop); then the names of the block parts
# (TD_BLK k) and warp parts (TD_WRP k) of K1 and K2
PROBES = {
    "edits": [
        ("dense_step", [
            ("  const int items = st.nh + st.nsl;\n",
             "  const int items = st.nh + st.nsl;\n  TD_WSTART\n"),
            ("    if (it < st.nh)\n      heavy_item<HS>(st, it, src, ss, dst, ds, gr, lane);\n"
             "    else\n      light_item<LS>(st, st.nsl - 1 - (it - st.nh), src, ss, dst, ds, "
             "gr, lane);\n",
             "    if (it < st.nh) {\n      heavy_item<HS>(st, it, src, ss, dst, ds, gr, lane);\n"
             "      TD_WRP(0)\n    } else {\n      light_item<LS>(st, st.nsl - 1 - (it - st.nh), "
             "src, ss, dst, ds, gr, lane);\n      TD_WRP(1)\n    }\n"),
        ]),
        ("bwd_dense", [
            ("  const Step sp = step_of<HS, LS>(stg, blob, tab);\n",
             "  const Step sp = step_of<HS, LS>(stg, blob, tab);\n  TD_BEGIN\n"),
            ("    if (tid == 0) *ctr = 0;\n", "    if (tid == 0) *ctr = 0;\n    TD_WSTART\n"),
            ("      const float mr = m > 0.f ? m : 1.f;\n",
             "      const float mr = m > 0.f ? m : 1.f;\n      TD_WRP(2)\n"),
            ("            if (SPILL) st[s] = x[u];\n          }\n        }\n      }\n",
             "            if (SPILL) st[s] = x[u];\n          }\n        }\n      }\n      TD_WRP(3)\n"),
            ("SYNC", 2),
        ]),
        ("fwd_dense", [
            ("  const Step sp = step_of<HS, LS>(stg, blob, tab);\n",
             "  const Step sp = step_of<HS, LS>(stg, blob, tab);\n  TD_BEGIN\n"),
            ("    if (tid == 0) *ctr = 0;\n", "    if (tid == 0) *ctr = 0;\n    TD_WSTART\n"),
            ("fls[r] + bl - lp, 60.f));\n", "fls[r] + bl - lp, 60.f));\n      TD_WRP(2)\n"),
            ("          bv[u] = s < S ? ld_now(bw + s) : 0.f;\n        }\n      }\n",
             "          bv[u] = s < S ? ld_now(bw + s) : 0.f;\n        }\n      }\n      TD_WRP(3)\n"),
            ("ve * bsel * wv;\n          }\n        }\n      }\n",
             "ve * bsel * wv;\n          }\n        }\n      }\n      TD_WRP(4)\n"),
            ("        pk[j] = (P)mv;\n      }\n", "        pk[j] = (P)mv;\n      }\n      TD_WRP(5)\n"),
            ("dp[r * H + j] = ndr[j];\n", "dp[r * H + j] = ndr[j];\n      TD_WRP(6)\n"),
            ("SYNC", 2),
        ]),
    ],
    "bwd": {"blk": ["step (heavy | light)", "per-read phase"],
            "wrp": {0: "  heavy outputs (slowest warp)",
                    1: "  light slices (slowest warp)",
                    2: "  row max (slowest warp)",
                    3: "  rescale + spill (slowest warp)"}},
    "fwd": {"blk": ["step (heavy | light)", "per-read phase"],
            "wrp": {0: "  heavy outputs (slowest warp)",
                    1: "  light slices (slowest warp)",
                    2: "  row max + weight (slowest warp)",
                    3: "  posterior + rescale (slowest warp)",
                    4: "  entry posteriors (slowest warp)",
                    5: "  label posteriors + DP (slowest warp)",
                    6: "  DP copy (slowest warp)"}},
}


# td_estep: its marker comments (``/* TD_PROBE(name) */``, one after each
# barrier of the position loop, one at the top and one after the final
# flush) replaced by the same probes; the block parts per CTA-tile-position
# (the first position's grouping holds the tile's start and the launch's
# table load), then the flush, once per block
ESTEP_PROBES = {
    "edits": [
        ("estep_kernel", [
            ("/* TD_PROBE(begin) */", "TD_BEGIN"),
            ("/* TD_PROBE(group) */", "TD_BLK(0)"),
            ("/* TD_PROBE(step) */", "TD_BLK(1)"),
            ("/* TD_PROBE(max) */", "TD_BLK(2)"),
            ("/* TD_PROBE(rescale) */", "TD_BLK(3)"),
            ("/* TD_PROBE(flush) */", "TD_BLK(4)"),
        ]),
    ],
    "blk": ["A: grouping, stack rows", "B: step and mass",
            "M: row max, cluster barrier", "C: rescale, cluster barrier"],
    "once": ["final flush"],
}


def function_span(src: str, name: str) -> tuple:
    """(start, end) of the definition of device function ``name`` (None if
    the source has none): from its name's first occurrence followed by '('
    to the closing brace of its body (the first line that is exactly
    '}')."""
    m = re.search(r"\b%s\(" % re.escape(name), src)
    if not m:
        return None
    end = src.index("\n}\n", m.start()) + 3
    return m.start(), end


def instrument(src: str, probes: dict = PROBES) -> str:
    """The source with the probes of ``probes`` (PROBES, ESTEP_PROBES)
    placed in it."""
    out = src
    for fn, edits in probes["edits"]:
        span = function_span(out, fn)
        if span is None:
            raise SystemExit(f"step_profile: the source has no function {fn}")
        a, b = span
        body = out[a:b]
        for anchor, repl in edits:
            if anchor == "SYNC":
                # the position loop's barriers at loop indentation
                n = [0]

                def tag(m):
                    k = n[0]
                    n[0] += 1
                    return f"{m.group(0)}    TD_BLK({k})\n"

                body = re.sub(r"(?m)^    __syncthreads\(\);[^\n]*\n", tag, body)
                if n[0] != repl:
                    raise SystemExit(f"step_profile: {fn} has {n[0]} barriers in its "
                                     f"position loop, not {repl}")
            elif body.count(anchor) != 1:
                raise SystemExit(f"step_profile: {fn} holds the anchor {anchor!r} "
                                 f"{body.count(anchor)} times, not once")
            else:
                body = body.replace(anchor, repl)
        out = out[:a] + body + out[b:]
    ns = out.index("namespace {\n") + len("namespace {\n")
    return out[:ns] + PRELUDE + out[ns:] + EPILOGUE


def build_library(src_text: str, source: str = SOURCE) -> str:
    """Compile the instrumented copy of ``source`` beside the other sources
    into a library that ``engine.build.lib`` then loads."""
    from tagdust_tpu_torch.engine import build

    os.makedirs(OUT_DIR, exist_ok=True)
    for f in os.listdir(OUT_DIR):
        os.remove(os.path.join(OUT_DIR, f))
    name = os.path.basename(source)
    cu = os.path.join(OUT_DIR, name.replace(".cu", "_probed.cu"))
    with open(cu, "w") as fh:
        fh.write(src_text)
    srcs = [cu] + [s for s in build._sources() if not s.endswith(name)]
    objs, procs = [], []
    for s in srcs:
        obj = os.path.join(OUT_DIR, os.path.basename(s) + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", obj, s],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    for s, p in zip(srcs, procs):
        out, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {s}:\n{out}\n{err}")
    so = os.path.join(OUT_DIR, "libtd_probed.so")
    subprocess.run([build._nvcc(), "-shared", "-o", so, *objs], check=True)
    return so


def profile_estep(L, name: str, seqs, lens, buf) -> None:
    """``td_estep`` on model ``name``'s K1 stack: its geometry, its time (CUDA
    events, median of 3) and its block parts per CTA-tile-position, the
    flush per block."""
    import torch

    from tagdust_tpu_torch.engine import estep
    from tagdust_tpu_torch.engine.cuda import CudaEngine
    from tagdust_tpu_torch.parallel import mesh

    eng = CudaEngine(cs.library_model(cs.barcode_sets()[name]), "cuda")
    stack = eng.scorer.backward(seqs, lens)
    tab = mesh.count_tables(eng.lat, seqs.device)
    fn = lambda: estep.forward_counts_cuda(tab, seqs, lens, *stack)  # noqa: E731
    ms = cs.timed(fn, reps=3)
    L.td_prof_reset()
    fn()
    if L.td_prof_read(ctypes.addressof(buf)):
        raise SystemExit("step_profile: reading the probes' sums failed")
    v = np.frombuffer(buf, dtype=np.uint64).astype(np.float64)
    g = estep.launch_plan(tab, seqs.device)
    R, C = g["R"], g["C"]
    B = seqs.shape[0]
    tiles = -(-B // R)
    # each tile walks the positions of its longest read, in each of C blocks
    ln = np.zeros(tiles * R, dtype=np.int64)
    ln[:B] = lens.cpu().numpy()
    per = C * float(ln.reshape(tiles, R).max(axis=1).sum())
    parts = ESTEP_PROBES["blk"]
    blk = v[: len(parts)] / per
    total = blk.sum()
    print(f"[{name} S={eng.lat.S}] td_estep: clusters of C={C} blocks, {R} reads a "
          f"tile, {g['smem']} bytes of dynamic shared memory a block, "
          f"{g['clusters']} clusters, {tiles} tiles; probed kernel {ms:.3f} ms; "
          f"cycles per CTA-tile-position, block parts summing to {total:.0f}:",
          flush=True)
    for k, p in enumerate(parts):
        print(f"    {p:40s} {blk[k]:10.0f}  {100 * blk[k] / total:5.1f}%")
    for k, p in enumerate(ESTEP_PROBES["once"], start=len(parts)):
        print(f"    {p + ' (per block)':40s} {v[k] / v[-1]:10.0f}")
    del stack
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--models", default="flagship,plate")
    ap.add_argument("--estep", action="store_true",
                    help="profile td_estep instead of K1 and K2")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("step_profile: no CUDA device")
    from tagdust_tpu_torch.engine import build
    from tagdust_tpu_torch.engine.cuda import CudaEngine

    source = ESTEP_SOURCE if args.estep else SOURCE
    with open(source) as fh:
        text = fh.read()
    so = build_library(instrument(text, ESTEP_PROBES if args.estep else PROBES), source)
    build.build = lambda verbose=False: so  # lib() loads the probed library
    L = build.lib()
    L.td_prof_read.argtypes = [ctypes.c_void_p]
    sets = cs.barcode_sets()
    B, Lp = 16384, 64
    rng = np.random.default_rng(args.seed)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, Lp)).astype(np.uint8)).cuda()
    lens = torch.from_numpy(rng.integers(40, Lp + 1, B).astype(np.int32)).cuda()
    buf = (ctypes.c_ulonglong * (16 + 16 * 32 + 1))()
    for name in args.models.split(","):
        if args.estep:
            profile_estep(L, name, seqs, lens, buf)
            continue
        sc = CudaEngine(cs.library_model([] if name == "R:N" else sets[name]), "cuda").scorer
        out = {}
        runs = {"bwd": lambda: sc.backward(seqs, lens)}
        bst, blst, lp = sc.backward(seqs, lens)
        if name != "R:N":
            runs["fwd"] = lambda: sc.forward_decode(seqs, lens, bst, blst, lp)
        for kern, fn in runs.items():
            ms = cs.timed(fn, reps=3)
            L.td_prof_reset()
            fn()
            if L.td_prof_read(ctypes.addressof(buf)):
                raise SystemExit("step_profile: reading the probes' sums failed")
            v = np.frombuffer(buf, dtype=np.uint64).astype(np.float64)
            nblk = v[-1]
            per = nblk * Lp
            blk = v[:16] / per
            wrp = v[16:16 + 16 * 32].reshape(16, 32) / per
            parts = PROBES[kern]["blk"]
            total = blk[: len(parts)].sum()
            print(f"[{name} S={sc.S}] {'K1' if kern == 'bwd' else 'K2'}: "
                  f"{sc.reads_per_block(kern)} reads per block, {int(nblk)} blocks, "
                  f"probed kernel {ms:.3f} ms; cycles per (block, position), "
                  f"block parts summing to {total:.0f}:", flush=True)
            for k, p in enumerate(parts):
                print(f"    {p:40s} {blk[k]:10.0f}  {100 * blk[k] / total:5.1f}%")
            for k, p in PROBES[kern]["wrp"].items():
                print(f"    {p:40s} {wrp[k].max():10.0f}")
            out[kern] = ms
        del bst, blst, lp, sc
        torch.cuda.empty_cache()
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {cs.card_line()}; highest SM clock {clk}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
