"""Deferred host-half assembler of the dispatch pipeline (counterpart of
lightgbm_tpu/boosting/pipeline.py).

The fused step of tree t+1 does not depend on tree t's host `Tree`: it
reads only the payload and its scratch, which never leave the device.
The one reason the per-tree loop waited once a tree was the tree's
packed fetch before its host assembly.  This module is the bounded FIFO
that takes that wait, and the host assembly behind it, off the dispatch
thread:

* `submit(fn, trees=)` enqueues one drain unit's host half and applies
  backpressure: at most `depth` units are pending or running.  A unit is
  one tree on the per-tree path (wait for the tree's record in pinned
  host memory -> `Tree` assembly -> `model.trees.append`); the boosting
  window (boost_window=J) submits one unit for its J*K trees, so `trees=`
  says how many trees a unit carries and `pending_trees` how far the
  device runs ahead of the host model in trees, not units.
* the halves run on ONE worker thread in submission order, so
  `model.trees` grows in the order the trees were dispatched, which
  byte-identical model files need.
* `flush()` drains every unit, joins the worker and re-raises the first
  deferred error.  After it returns no thread is alive, so a process
  that makes many short-lived boosters keeps no parked workers.

A host half launches nothing on the card: it waits for an event that the
dispatch thread recorded after the record's copy into pinned memory
(`Event.query`, which a CUDA graph captured by the dispatch thread, in
thread-local capture mode, does not see) and then runs on the host.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Deque, Optional, Tuple

from ..runtime import telemetry, tracing


class TreeAssembler:
    """Bounded, strictly ordered, single-worker deferred queue."""

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._cv = threading.Condition()
        self._fifo: Deque[Tuple[Callable[[], None], int]] = \
            collections.deque()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stopping = False
        #: the most units ever pending at once (the queue-depth bound's
        #: witness)
        self.max_pending = 0

    @property
    def pending(self) -> int:
        """Drain units submitted but not yet finished."""
        with self._cv:
            return len(self._fifo)

    @property
    def pending_trees(self) -> int:
        """Trees carried by the pending drain units (a boosting-window
        unit counts its whole J*K batch)."""
        with self._cv:
            return sum(n for _, n in self._fifo)

    def _raise_deferred(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn: Callable[[], None], trees: int = 1) -> None:
        """Enqueue one drain unit carrying `trees` trees; blocks while
        `depth` units are already pending (the running one counts),
        bounding how far the device runs ahead.  A deferred error of an
        earlier unit re-raises here rather than silently dropping
        trees.  The unit runs under the dispatching thread's trace
        context, as an ``assembler/drain`` span."""
        fn = tracing.bind(fn, "assembler/drain", trees=trees)
        with self._cv:
            self._raise_deferred()
            while len(self._fifo) >= self.depth:
                self._cv.wait()
                self._raise_deferred()
            self._fifo.append((fn, max(1, int(trees))))
            self.max_pending = max(self.max_pending, len(self._fifo))
            # how far the device runs ahead of the host model right now
            telemetry.gauge("lgbm_pipeline_queue_depth").set(
                len(self._fifo))
            if self._thread is None:
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._run, name="lgbm-torch-assembler",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._fifo and not self._stopping:
                    self._cv.wait()
                if not self._fifo:
                    return
                # left queued while it runs: the running unit counts
                # against the depth bound
                fn, _n = self._fifo[0]
            try:
                fn()
            except BaseException as e:  # deferred to submit() / flush()
                with self._cv:
                    if self._error is None:
                        self._error = e
            with self._cv:
                self._fifo.popleft()
                telemetry.gauge("lgbm_pipeline_queue_depth").set(
                    len(self._fifo))
                self._cv.notify_all()

    def flush(self) -> None:
        """Drain every pending unit, stop the worker and re-raise the
        first deferred error.  Idempotent; cheap when already empty."""
        with self._cv:
            while self._fifo:
                self._cv.wait()
            self._stopping = True
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        with self._cv:
            self._raise_deferred()
