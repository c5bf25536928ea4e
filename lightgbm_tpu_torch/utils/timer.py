"""Per-phase wall timers (counterpart of lightgbm_tpu/utils/timer.py).

Role of the reference's `#ifdef TIMETAG` counters
(serial_tree_learner.cpp:14-41, gbdt.cpp init/boosting/train-score/
out-of-bag-score/valid-score/metric/bagging/tree timers): accumulate
seconds per named phase across training and report once at the end.

On the card the work is queued on a stream, so each timed phase must wait
for its outputs to be meaningful, which costs the overlap of host and
device.  The timers are therefore OFF by default and enabled with
`tpu_profile_phases=true` (the reference hides its timers behind a compile
flag).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Optional

from .log import Log


class PhaseTimer:
    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.seconds: "OrderedDict[str, float]" = OrderedDict()
        self.calls: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        """Time a phase.  Call `self.sync(outputs)` as the LAST statement of
        the with-body: queued device work is billed to whichever later
        phase waits for it first otherwise."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def sync(self, outputs) -> None:
        """Wait for a phase's outputs (no-op when timing is off), through
        the sync seam under `profile_sync`: profiled runs report their
        per-phase waits as blocking syncs."""
        if self.enabled:
            from ..runtime import syncs
            syncs.block_until_ready(outputs, label="profile_sync")

    def report(self) -> Optional[Dict[str, float]]:
        """Log the accumulated table (the reference prints it at
        shutdown)."""
        if not self.enabled or not self.seconds:
            return None
        Log.info("phase timings (tpu_profile_phases):")
        for name, sec in self.seconds.items():
            Log.info("  %-22s %9.3f s  (%d calls)", name, sec,
                     self.calls.get(name, 0))
        return dict(self.seconds)
