"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

At first use ``nvcc`` compiles the sources for ``sm_90a`` (one ``nvcc`` per
source, all started together) and links them into a shared library with a
plain C interface under ``build/tagdust_tpu_torch/`` beside the package
(git-ignored), named by a hash of the sources so that an edit rebuilds.
``ctypes`` loads it.  Every C entry point returns ``cudaGetLastError()``;
``check`` raises on anything but 0, so a refused or failed launch never
passes silently.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "tagdust_tpu_torch"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtagdust_dp_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate() for p in procs]
    try:
        for src, p, (out, err) in zip(_sources(), procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {os.path.basename(src)} ({p.returncode}):"
                    f"\n{out}\n{err}"
                )
            if verbose and err:
                print(err, flush=True)
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link ({link.returncode}):\n{link.stdout}\n"
                f"{link.stderr}"
            )
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(build())
    P, I = ctypes.c_void_p, ctypes.c_int
    L.td_reads_per_block.argtypes = [I] * 8 + [P]
    L.td_bwd.argtypes = [P] * 14 + [I] * 9 + [P]
    L.td_bwd_score.argtypes = [P] * 12 + [I] * 9 + [P]
    L.td_fwd.argtypes = [P] * 21 + [I] * 14 + [P]
    L.td_tb.argtypes = [P, P, P] + [I] * 5 + [P]
    L.td_blocks_per_sm.argtypes = [I] * 10 + [P, I]
    L.td_myers.argtypes = [P, P, I, P, I, P, P, I, P]
    for fn in (L.td_reads_per_block, L.td_bwd, L.td_bwd_score, L.td_fwd, L.td_tb,
               L.td_blocks_per_sm, L.td_myers):
        fn.restype = I
    _lib = L
    return L


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {err})")
