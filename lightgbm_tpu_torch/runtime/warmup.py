"""The kernel build cache (counterpart of lightgbm_tpu/runtime/warmup.py,
its compile-cache half).

The JAX package points jax's persistent compilation cache at a
fingerprinted directory.  The port's compiled programs are the hand
kernels' shared libraries, which `ops/build.py` builds with nvcc into
``BUILD_DIR`` (``build/kernels/`` beside the package) keyed by a hash of
each source, the csrc headers and the nvcc flags.  This module makes that
directory a measured, bounded cache:

* `enable_compile_cache(base)` (``$LGBM_TPU_COMPILE_CACHE``) points
  ``build.BUILD_DIR`` at a FINGERPRINTED subdirectory of `base`: the
  fingerprint keys the torch and CUDA versions, the nvcc flags, the
  card's compute capability when CUDA is already initialized in this
  process (never initializing it), and the host's CPU flags.  A different
  stack lands in a different subdirectory and builds cold, never loading
  a library built for another one.
* Every build of a kernel source is classified through the program
  ledger's observer (`graph_obs.set_compile_observer`): a library found
  on disk is a hit, an nvcc run a miss, counted in
  ``lgbm_compile_cache_events_total{event}``.
* `sweep_cache` evicts the oldest libraries past a size budget
  (``$LGBM_TPU_COMPILE_CACHE_MB``, default 512; event ``evict``);
  `cache_status` is the doctor bundle's member.

The shape manifests and the serving prewarm (the JAX module's other half)
serve `runtime/serving.py` and come with it (ROADMAP queue A item 6).  No
torch at module scope.
"""
from __future__ import annotations

import hashlib
import os
import sys
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from . import graph_obs, telemetry

__all__ = [
    "CACHE_ENV", "CACHE_BUDGET_ENV", "cache_fingerprint",
    "enable_compile_cache", "maybe_enable_from_env", "sweep_cache",
    "cache_status",
]

#: base directory of the build cache (the fingerprinted subdirectory is
#: made under it)
CACHE_ENV = "LGBM_TPU_COMPILE_CACHE"

#: size budget of ONE fingerprinted subdirectory, in MB (oldest-first
#: sweep past it; 0 disables the sweep)
CACHE_BUDGET_ENV = "LGBM_TPU_COMPILE_CACHE_MB"
DEFAULT_BUDGET_MB = 512

_lock = threading.Lock()
_STATE: Dict[str, Any] = {
    "enabled": False, "dir": None, "fingerprint": None,
    "hits": 0, "misses": 0, "evictions": 0, "budget_mb": None,
}


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

def _host_fingerprint() -> str:
    """Short stable hash of this host's CPU flags and machine type."""
    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((ln for ln in fh if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    import platform
    blob = (flags + "|" + platform.machine()).encode()
    return hashlib.sha256(blob).hexdigest()[:8]


def _flags_fingerprint() -> str:
    """Hash of the nvcc flags every kernel is built with."""
    from ..ops import build
    return hashlib.sha256(" ".join(build.NVCC_FLAGS).encode()) \
        .hexdigest()[:8]


def _capability() -> str:
    """``sm<major><minor>`` of card 0 when CUDA is already initialized in
    this process, else ``uninit``: the fingerprint never initializes it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return "uninit"
    major, minor = torch.cuda.get_device_capability(0)
    return "sm%d%d" % (major, minor)


def cache_fingerprint() -> str:
    """Identity of the compiled-kernel universe this process inhabits:
    ``torch<ver>-cuda<ver>-<flags8>-<capability>-<host8>``.  Two processes
    share a cache subdirectory iff every component matches."""
    import torch
    ver = str(torch.__version__).replace(os.sep, "_").replace("+", "_")
    return "torch%s-cuda%s-%s-%s-%s" % (
        ver, torch.version.cuda or "none", _flags_fingerprint(),
        _capability(), _host_fingerprint())


# ---------------------------------------------------------------------------
# the build cache
# ---------------------------------------------------------------------------

def enable_compile_cache(base_dir: Optional[str] = None,
                         budget_mb: Optional[int] = None) -> Optional[str]:
    """Point `ops/build.py`'s BUILD_DIR at the fingerprinted subdirectory
    of `base_dir` (default ``$LGBM_TPU_COMPILE_CACHE``; None, touching
    nothing, when neither is set), classify every later build as a hit or
    a miss, and sweep the directory to its budget.  Idempotent per
    (process, directory).  Returns the directory."""
    base = base_dir if base_dir else os.environ.get(CACHE_ENV)
    if not base:
        return None
    fp = cache_fingerprint()
    cdir = os.path.join(os.path.expanduser(base), fp)
    with _lock:
        if _STATE["enabled"] and _STATE["dir"] == cdir:
            return cdir
    os.makedirs(cdir, exist_ok=True)
    from ..ops import build
    build.BUILD_DIR = Path(cdir)
    if budget_mb is None:
        budget_mb = int(os.environ.get(CACHE_BUDGET_ENV, DEFAULT_BUDGET_MB))
    with _lock:
        _STATE.update(enabled=True, dir=cdir, fingerprint=fp,
                      budget_mb=int(budget_mb))
    graph_obs.set_compile_observer(_build_observer)
    sweep_cache()
    return cdir


def maybe_enable_from_env() -> Optional[str]:
    """`enable_compile_cache()` iff ``$LGBM_TPU_COMPILE_CACHE`` is set
    (no torch import when it is not)."""
    if not os.environ.get(CACHE_ENV):
        return None
    return enable_compile_cache()


def _build_observer(source: str, event: str, wall_s: float) -> None:
    """Hears every kernel build: a library on disk is a hit, an nvcc run
    a miss."""
    with _lock:
        if not _STATE["enabled"]:
            return
        _STATE["hits" if event == "hit" else "misses"] += 1
    telemetry.counter("lgbm_compile_cache_events_total").inc(event=event)


def sweep_cache(budget_mb: Optional[int] = None) -> int:
    """Evict the oldest-mtime entries of the active cache directory until
    it fits the budget.  Returns the entries evicted (0 when disabled or
    under budget)."""
    with _lock:
        cdir = _STATE["dir"] if _STATE["enabled"] else None
        if budget_mb is None:
            budget_mb = _STATE["budget_mb"] or DEFAULT_BUDGET_MB
    if cdir is None or budget_mb <= 0:
        return 0
    entries: List[Tuple[float, int, str]] = []
    try:
        for name in os.listdir(cdir):
            p = os.path.join(cdir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p))
    except OSError:
        return 0
    total = sum(e[1] for e in entries)
    budget = int(budget_mb) << 20
    evicted = 0
    for mtime, size, p in sorted(entries):
        if total <= budget:
            break
        try:
            os.unlink(p)
        except OSError:
            continue
        total -= size
        evicted += 1
        telemetry.counter("lgbm_compile_cache_events_total").inc(
            event="evict")
    if evicted:
        with _lock:
            _STATE["evictions"] += evicted
    return evicted


def cache_status() -> Dict[str, Any]:
    """Machine-readable cache state (the doctor bundle's member)."""
    with _lock:
        st = {k: _STATE[k] for k in ("enabled", "dir", "fingerprint",
                                     "hits", "misses", "evictions",
                                     "budget_mb")}
    from ..ops import build
    st["build_dir"] = str(build.BUILD_DIR)
    files, total = 0, 0
    scan = st["dir"] or st["build_dir"]
    try:
        for name in os.listdir(scan):
            try:
                total += os.path.getsize(os.path.join(scan, name))
                files += 1
            except OSError:
                continue
    except OSError:
        pass
    st["files"] = files
    st["bytes"] = total
    return st


def _reset_for_tests() -> None:
    """Test seam: forget the enable state and the observer (BUILD_DIR is
    the caller's to put back)."""
    with _lock:
        _STATE.update(enabled=False, dir=None, fingerprint=None,
                      hits=0, misses=0, evictions=0, budget_mb=None)
    graph_obs.set_compile_observer(None)
