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

The module's other half is the shape manifest, ``warmup.json`` in a
publish dir, in the JAX package's format (`write_manifest` /
`read_manifest`, read-merge-atomic-write; sections ``serving`` and
``train_online``): the row buckets a serving process captured at the
device predictor's site (`serving_row_buckets`, read from the program
ledger's builds of ``predictor.tree_parallel``) and the shape signature
of an online trainer.  A fresh serving runtime prewarms the buckets its
manifest names before it admits a request (each bucket's CUDA graph is
captured then); every prewarm outcome counts in
``lgbm_warmup_total{kind,outcome}`` (`record_prewarm`).  No torch at
module scope.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from . import graph_obs, telemetry
from .resilience import atomic_write, wallclock

__all__ = [
    "CACHE_ENV", "CACHE_BUDGET_ENV", "MANIFEST_NAME",
    "MANIFEST_SCHEMA_VERSION", "cache_fingerprint",
    "enable_compile_cache", "maybe_enable_from_env", "sweep_cache",
    "cache_status",
    "write_manifest", "read_manifest", "manifest_path",
    "build_serving_section", "build_train_section", "params_sig",
    "classify_serving_section", "classify_train_section",
    "serving_row_buckets", "record_prewarm",
]

#: base directory of the build cache (the fingerprinted subdirectory is
#: made under it)
CACHE_ENV = "LGBM_TPU_COMPILE_CACHE"

#: size budget of ONE fingerprinted subdirectory, in MB (oldest-first
#: sweep past it; 0 disables the sweep)
CACHE_BUDGET_ENV = "LGBM_TPU_COMPILE_CACHE_MB"
DEFAULT_BUDGET_MB = 512

#: the shape manifest published beside model generations.  Not a
#: ``gen_`` file: `publish.generation_paths` never lists it and
#: `ModelPublisher._prune` never unlinks it.
MANIFEST_NAME = "warmup.json"
MANIFEST_SCHEMA_VERSION = 1

#: a serving prewarm captures at most this many manifest buckets (a
#: runaway manifest must not stall readiness).  The JAX package's bound
#: is 8; here every power-of-two bucket from 16 rows to twice the
#: default batch rows (16..8192, ten buckets) fits, so a stream of
#: requests up to `max_batch_rows` rows captures nothing after readiness.
MAX_PREWARM_BUCKETS = 16

#: sanity bound on a manifest row bucket; anything outside [1, this]
#: marks the manifest invalid
MAX_BUCKET_ROWS = 1 << 22

#: the device predictor's graph site, whose builds carry the row buckets
PREDICT_SITE = "predictor.tree_parallel"

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


# ---------------------------------------------------------------------------
# shape manifests (warmup.json in the publish dir)
# ---------------------------------------------------------------------------

def manifest_path(pub_dir: str) -> str:
    return os.path.join(pub_dir, MANIFEST_NAME)


def _doc_checksum(doc: Dict[str, Any]) -> str:
    payload = json.dumps({"schema_version": doc.get("schema_version"),
                          "sections": doc.get("sections")},
                         sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


def _read_doc(pub_dir: str) -> Tuple[Optional[Dict[str, Any]], str]:
    """(manifest document, reason): reason is "ok", "missing" (no file)
    or "torn" (unparseable / checksum-invalid / wrong schema).  The
    atomic write discipline means "torn" only ever describes a file
    written by something that is not this seam."""
    try:
        with open(manifest_path(pub_dir), "rb") as fh:
            text = fh.read().decode("utf-8", "replace")
    except OSError:
        return None, "missing"
    try:
        doc = json.loads(text)
    except ValueError:
        return None, "torn"
    if not isinstance(doc, dict) \
            or not isinstance(doc.get("sections"), dict) \
            or doc.get("schema_version") != MANIFEST_SCHEMA_VERSION \
            or doc.get("checksum") != _doc_checksum(doc):
        return None, "torn"
    return doc, "ok"


def write_manifest(pub_dir: str, kind: str,
                   section: Dict[str, Any]) -> str:
    """Merge one kind's section into the publish dir's manifest
    (read-merge-atomic-write, the `mark_rollback` pattern: the trainer
    and N serving replicas can all publish their sections concurrently
    and every writer's section lands).  Returns the path."""
    doc, _ = _read_doc(pub_dir)
    sections = dict((doc or {}).get("sections", {}))
    sections[str(kind)] = dict(section)
    out = {"schema_version": MANIFEST_SCHEMA_VERSION, "sections": sections}
    out["checksum"] = _doc_checksum(out)
    path = manifest_path(pub_dir)
    os.makedirs(pub_dir, exist_ok=True)
    atomic_write(path, json.dumps(out, indent=1) + "\n")
    return path


def read_manifest(pub_dir: str, kind: str
                  ) -> Tuple[Optional[Dict[str, Any]], str]:
    """(section, reason) for one kind: reason "ok", "missing" (no file
    or no such section) or "torn"."""
    doc, reason = _read_doc(pub_dir)
    if doc is None:
        return None, reason
    sec = doc["sections"].get(str(kind))
    if not isinstance(sec, dict):
        return None, "missing"
    return sec, "ok"


def _ledger_sites(limit: int = 32) -> List[str]:
    """Site names the program ledger saw build in this process: the
    manifest's provenance trail (what this role actually built)."""
    snap = graph_obs.snapshot()
    return sorted(name for name, n in snap.items() if n > 0)[:limit]


def build_serving_section(num_features: int, row_buckets: List[int],
                          generation: Optional[int] = None
                          ) -> Dict[str, Any]:
    return {
        "kind": "serving",
        "num_features": int(num_features),
        "row_buckets": sorted({int(b) for b in row_buckets}),
        "generation": int(generation) if generation is not None else None,
        "fingerprint": _safe_fingerprint(),
        "created": wallclock(),
        "sites": _ledger_sites(),
    }


def params_sig(params: Dict[str, Any], n_features: int) -> Dict[str, Any]:
    """The program-shape-determining parameter subset: two training
    processes with equal signatures build the same grower programs on a
    same-width window (the JAX package's keys, so either package reads
    the other's section)."""
    p = params or {}
    return {
        "objective": str(p.get("objective", "regression")),
        "num_class": int(p.get("num_class", 1)),
        "num_leaves": int(p.get("num_leaves", 31)),
        "max_bin": int(p.get("max_bin", 255)),
        "boost_window": int(p.get("boost_window", 1)),
        "n_features": int(n_features),
    }


def build_train_section(params: Dict[str, Any], n_features: int,
                        generation: Optional[int] = None
                        ) -> Dict[str, Any]:
    return {
        "kind": "train_online",
        "params_sig": params_sig(params, n_features),
        "generation": int(generation) if generation is not None else None,
        "fingerprint": _safe_fingerprint(),
        "created": wallclock(),
        "sites": _ledger_sites(),
    }


def _safe_fingerprint() -> Optional[str]:
    try:
        return cache_fingerprint()
    except Exception:    # noqa: BLE001 — provenance only, never a blocker
        return None


def classify_serving_section(sec: Dict[str, Any],
                             num_features: Optional[int],
                             newest_generation: Optional[int]) -> str:
    """"ok" when the manifest's buckets can be trusted for this model;
    otherwise the degradation outcome the metrics count:

    * ``manifest_invalid`` — buckets missing/malformed/absurd;
    * ``manifest_stale`` — written for a DIFFERENT generation whose
      shape no longer matches (the lineage moved on; its buckets
      describe a model this replica is not serving);
    * ``shape_mismatch`` — written for this very generation yet the
      feature width disagrees (a corrupt or foreign manifest).

    Buckets are shape-keyed, not generation-keyed, so an old-generation
    manifest whose feature width still matches stays "ok" — that is the
    common steady-state case."""
    buckets = sec.get("row_buckets")
    if not isinstance(buckets, list) or not buckets \
            or not all(isinstance(b, int) and 0 < b <= MAX_BUCKET_ROWS
                       for b in buckets):
        return "manifest_invalid"
    nf = sec.get("num_features")
    if num_features is not None and nf != num_features:
        gen = sec.get("generation")
        if isinstance(gen, int) and newest_generation is not None \
                and gen != newest_generation:
            return "manifest_stale"
        return "shape_mismatch"
    return "ok"


def classify_train_section(sec: Dict[str, Any],
                           params: Dict[str, Any],
                           n_features: int) -> str:
    """"ok" when the manifest was written by a training process whose
    program-shape signature matches THIS one (the same grower programs —
    prewarming pays off); "shape_mismatch" otherwise."""
    sig = sec.get("params_sig")
    if not isinstance(sig, dict):
        return "manifest_invalid"
    return "ok" if sig == params_sig(params, n_features) \
        else "shape_mismatch"


def serving_row_buckets(num_features: Optional[int] = None) -> List[int]:
    """Row buckets the tree-parallel predictor captured in this process,
    read from the program ledger (each build of site
    ``predictor.tree_parallel`` records the signature of its buffers;
    the static input is ``f32[rows,features]``)."""
    import re
    rec = graph_obs.LEDGER.register(PREDICT_SITE)
    sigs: List[List[str]] = [list(h.get("signature", []))
                             for h in rec.history]
    if rec.last_sig:
        sigs.append(list(rec.last_sig))
    pat = re.compile(r"^f32\[(\d+),(\d+)\]$")
    buckets = set()
    for sig in sigs:
        for entry in sig:
            m = pat.match(entry)
            if not m:
                continue
            rows, feats = int(m.group(1)), int(m.group(2))
            if num_features is not None and feats != num_features:
                continue
            buckets.add(rows)
    return sorted(buckets)


def record_prewarm(kind: str, outcome: str, seconds: float) -> None:
    """Count one prewarm attempt: every path — manifest-driven, degraded
    to legacy, or errored — lands in ``lgbm_warmup_total{kind,outcome}``
    so the fleet's warm-start behavior is scrapeable."""
    telemetry.counter("lgbm_warmup_total").inc(kind=kind, outcome=outcome)
    telemetry.histogram("lgbm_warmup_seconds").observe(
        max(float(seconds), 0.0), kind=kind)
