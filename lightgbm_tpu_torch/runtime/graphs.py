"""CUDA graph seam: one captured function per (grower, site).

The counterpart of the JAX package's `xla_obs.jit` site seam
(lightgbm_tpu/runtime/xla_obs.py), for CUDA graphs.  A `Site` wraps a
function of no arguments that reads and writes only buffers fixed before
its first call (the grower's state, its static inputs, the payload and
its scratch).  Its first call runs the function eagerly on a side stream
(the warm-up, which is a real call: it builds the kernels and sizes
nothing anew), then captures it under a `torch.cuda.CUDAGraph`; every
later call replays the graph on the current stream.  A capture that fails
raises: nothing falls back to eager calls.

The capture is begun and ended here rather than with `torch.cuda.graph`,
whose entry synchronizes the device: a grower captures inside its first
tree, where no sync may happen.

Launch counts: the wrappers of ops/cuda_segment.py count their launches
in `<wrapper>.launches` from Python, which a replay does not run.  A Site
records what its capture added to each counted wrapper, takes it back
(the capture launched nothing), and adds it again at every replay, so
each count stays the number of launches the card ran.

The program ledger (`runtime/graph_obs.py`) counts each capture as a
build of the site, with its wall time (the warm-up run and the capture)
and the signature of the buffers it was built over (`signature`), and
each replay as a call; `counts` reads the captures and replays of the
graph sites from it.  `after_replay` lets a check read a captured tensor
after every replay.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Sequence, Set, Tuple

import torch

from . import graph_obs

#: the names of the sites that captured a graph (the ledger holds their
#: counts beside those of other programs)
_names: Set[str] = set()
_tls = threading.local()


def counts() -> Dict[str, Dict[str, int]]:
    """Captures and replays per graph site name, from the ledger."""
    builds = graph_obs.snapshot()
    calls = graph_obs.calls_snapshot()
    return {k: {"captures": builds.get(k, 0), "replays": calls.get(k, 0)}
            for k in sorted(_names)}


def after_replay(fn: Callable[[], None]) -> None:
    """During a capture: run `fn` on the host after every replay of the
    graph being captured (a check clones a tensor the graph writes)."""
    site = getattr(_tls, "capturing", None)
    if site is None:
        raise RuntimeError("after_replay outside a capture")
    site.hooks.append(fn)


class Site:
    """fn, eager with `enabled` False, else captured once and replayed.
    `counted` returns, at the capture, the objects with a `.launches`
    count that fn's launches add to; `signature`, the ledger's shape
    signature of the buffers fn reads and writes."""

    def __init__(self, name: str, fn: Callable[[], None], enabled: bool,
                 counted: Callable[[], Sequence] = tuple, pool=None,
                 signature: Callable[[], Tuple[str, ...]] = tuple):
        self.name = name
        self.fn = fn
        self.enabled = enabled
        self.counted = counted
        self.signature = signature
        # a memory pool shared with other sites (torch.cuda.
        # graph_pool_handle()), for graphs that never run at once
        self.pool = pool
        self.graph = None
        self.added = ()
        self.hooks = []

    def __call__(self) -> None:
        if not self.enabled:
            self.fn()
        elif self.graph is None:
            self._capture()
        else:
            self.replay()

    def replay(self) -> None:
        self.graph.replay()
        for obj, n in self.added:
            obj.launches += n
        graph_obs.record_replay(self.name)
        for fn in self.hooks:
            fn()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn()
        counted = list(self.counted())
        before = [obj.launches for obj in counted]
        graph = torch.cuda.CUDAGraph()
        _tls.capturing = self
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self.fn()
                finally:
                    graph.capture_end()
        finally:
            _tls.capturing = None
        self.added = tuple((obj, obj.launches - b)
                           for obj, b in zip(counted, before)
                           if obj.launches != b)
        for obj, b in zip(counted, before):
            obj.launches = b
        cur.wait_stream(side)
        self.graph = graph
        _names.add(self.name)
        graph_obs.record_build(self.name, time.perf_counter() - t0,
                               self.signature())
