"""Blocking host-sync seam (counterpart of lightgbm_tpu/runtime/syncs.py).

Every *blocking* device-to-host read the port's training makes goes
through this module, so one counter answers "how many times per
iteration does the host wait for the card, and where?":

* `tree_fetch`: the grower's small outputs of one tree, one packed
  transfer (`gbdt._fetch_packed`);
* `eval_fetch`: scores fetched for the metrics (`raw_train_score`,
  `raw_valid_score`);
* `predict_fetch`: one micro-batch's output of the device predictor
  (`wait_event`);
* `profile_sync`: a phase timer's wait at the end of each timed phase
  (`block_until_ready`, `utils/timer.py`; profiled runs only).

Each event is recorded under its label and under whether the calling
thread sits on the tree-to-tree critical path (marked with
`critical_path`, as the JAX package's dispatch loop is).  The counters
are process-global and only grow; a consumer takes a `snapshot` before a
region and diffs with `delta` after it.  Every event also feeds the
metrics registry (`telemetry.count_sync`), as in the JAX package, so a
scrape sees the same sync profile.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch

from . import telemetry

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_critical_counts: Dict[str, int] = {}
_total = 0
_critical_total = 0

_tls = threading.local()


def _on_critical_path() -> bool:
    return getattr(_tls, "depth", 0) > 0


class critical_path:
    """Context manager marking the current thread as the device critical
    path: blocking syncs recorded while inside count as critical.  The
    marker is thread-local."""

    def __enter__(self) -> "critical_path":
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _tls.depth = getattr(_tls, "depth", 1) - 1


def record(label: str) -> None:
    """Count one blocking host sync under `label` (seam-internal; call
    sites use `device_get`)."""
    global _total, _critical_total
    crit = _on_critical_path()
    with _lock:
        _counts[label] = _counts.get(label, 0) + 1
        _total += 1
        if crit:
            _critical_counts[label] = _critical_counts.get(label, 0) + 1
            _critical_total += 1
    telemetry.count_sync(label, crit)


def device_get(x: torch.Tensor, label: str = "host_fetch") -> Any:
    """Audited fetch: ONE recorded blocking `.cpu()` of one tensor, as a
    numpy array (callers pack what they need into one tensor first)."""
    record(label)
    return x.cpu().numpy()


def block_until_ready(x: Any, label: str = "block_until_ready") -> Any:
    """Audited barrier: ONE recorded wait until the work queued so far on
    the current stream of `x`'s device (a tensor, or a dict, list or tuple
    holding some) has run.  A CPU tensor has nothing queued.  Returns `x`."""
    record(label)
    dev = _first_device(x)
    if dev is not None and dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        _synchronize(event)
    return x


def _first_device(x: Any) -> Optional[torch.device]:
    if isinstance(x, torch.Tensor):
        return x.device
    vals = x.values() if isinstance(x, dict) else \
        x if isinstance(x, (list, tuple)) else ()
    for v in vals:
        dev = _first_device(v)
        if dev is not None:
            return dev
    return None


def _synchronize(event: "torch.cuda.Event") -> None:
    """event.synchronize() with any torch.cuda.set_sync_debug_mode lifted
    for it alone: the wait is the sync its caller means to make."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        event.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def wait_event(event: "torch.cuda.Event", label: str) -> None:
    """Audited wait: ONE recorded blocking wait for `event` (a copy into
    pinned host memory recorded it).  It is the sync its caller means
    to make, so a torch.cuda.set_sync_debug_mode around the caller is
    lifted for it alone."""
    record(label)
    _synchronize(event)


def snapshot() -> Dict[str, Any]:
    """A copyable view of the counters."""
    with _lock:
        return {
            "total": _total,
            "critical_path": _critical_total,
            "by_label": dict(_counts),
            "critical_by_label": dict(_critical_counts),
        }


def delta(before: Dict[str, Any],
          after: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Counter movement since `before` (to `after`, default: now)."""
    if after is None:
        after = snapshot()
    by_label = {k: v - before["by_label"].get(k, 0)
                for k, v in after["by_label"].items()
                if v - before["by_label"].get(k, 0)}
    crit = {k: v - before["critical_by_label"].get(k, 0)
            for k, v in after["critical_by_label"].items()
            if v - before["critical_by_label"].get(k, 0)}
    return {
        "total": after["total"] - before["total"],
        "critical_path": after["critical_path"] - before["critical_path"],
        "by_label": by_label,
        "critical_by_label": crit,
    }


def reset() -> None:
    """Zero the counters (tests and measured sections)."""
    global _total, _critical_total
    with _lock:
        _counts.clear()
        _critical_counts.clear()
        _total = 0
        _critical_total = 0
