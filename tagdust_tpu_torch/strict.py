"""Loud, opt-out fallback handling for accelerated code paths.

Several hot paths have a slower but always-available equivalent (fused
Pallas pipeline -> XLA scan engine, device Myers -> host uint64 lanes,
native C++ emitters/codec -> pure Python).  A silent downgrade can cost
10-20x with zero diagnostics, so every fallback funnels through
:func:`fallback`:

* the first failure per site prints a WARNING with the exception to stderr
  (stderr, not stdout — bench.py's stdout is machine-parsed);
* ``TAGDUST_TPU_STRICT=1`` re-raises instead, so CI and kernel development
  catch a broken fast path immediately.
"""

from __future__ import annotations

import os
import sys

_warned: set = set()


def strict_mode() -> bool:
    return os.environ.get("TAGDUST_TPU_STRICT") == "1"


def note(site: str, message: str) -> None:
    """Loud (once per site) notice for a DOCUMENTED gate — a deliberate
    path choice, not a failure, so it never raises under strict mode.
    Used e.g. when reads longer than the fused kernels' 4096nt bound
    route to the XLA scan engine (docs/PERFORMANCE.md, Long reads)."""
    if site not in _warned:
        _warned.add(site)
        sys.stderr.write(f"[tagdust_tpu] NOTE: {site}: {message}\n")


def fallback(site: str, exc: BaseException, message: str) -> None:
    """Record that the fast path ``site`` failed and ``message`` describes
    the downgrade.  Raises under TAGDUST_TPU_STRICT=1; warns once otherwise."""
    if strict_mode():
        raise exc
    if site not in _warned:
        _warned.add(site)
        sys.stderr.write(
            f"[tagdust_tpu] WARNING: {site}: {message} "
            f"({type(exc).__name__}: {exc})\n"
        )
