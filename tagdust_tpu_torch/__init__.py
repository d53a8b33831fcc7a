"""tagdust_tpu_torch — the PyTorch and CUDA port of the tagdust_tpu demultiplexer.

The JAX package ``tagdust_tpu`` is the reference.  This package imports
nothing of it: it keeps its own copies of the host-side modules
(architecture DSL ``arch``, ``config``, ``model``, ``stats``, ``calibrate``,
``extract``, ``filters``, ``io``, the lattice compiler ``engine.lattice``
and the exact engine ``engine.exact`` with its C++ sources in ``csrc/``,
built at first use into ``build/tagdust_tpu_torch/``), and replaces every
module that runs on the device:

* ``engine.tables``       — the device tables, built from the lattice;
* ``engine.scan``         — plain PyTorch versions of the DP kernels;
* ``engine.csrc``         — the hand-written CUDA kernels (sm_90a);
* ``engine.fused_kernel`` — ``FusedScorer``, which launches the kernels for
  CUDA tensors and runs the plain versions for CPU tensors;
* ``engine.cuda``         — ``CudaEngine``, the batch scorer and epilogues;
* ``engine.decided``      — the on-device extraction decisions;
* ``engine.runner``       — engine choice, calibration scorer, streaming;
* ``controller`` / ``cli.tagdust`` / ``detect`` — the orchestration, the
  CLI and ``-arch`` detection.

The package never imports ``jax``.
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large allocations on the (warm) glibc heap instead of fresh mmaps.

    The columnar pipeline churns through ~100MB-class numpy temporaries per
    chunk.  glibc serves blocks >128KB from fresh mmap()s by default, so every
    chunk pays first-touch page faults for its whole working set; on
    virtualised hosts (nested EPT) faults can be 100x slower than warm
    memory.  Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes the heap grow
    once and stay warm.  Trades peak-RSS trimming for throughput; disable
    with TAGDUST_TPU_MALLOC_REUSE=0."""
    import os
    import sys

    if os.environ.get("TAGDUST_TPU_MALLOC_REUSE", "1") != "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass  # musl / restricted environments: default allocator behaviour


_tune_malloc()
