"""Collectives of the distributed learners over torch.distributed.

The port's counterpart of the collectives XLA gives the JAX package
inside `shard_map` (`psum`, `psum_scatter`, `pmax`, `all_gather`) and of
the reference's `Network` (src/network/network.cpp: Allreduce,
ReduceScatter, Allgather).  The transport is a torch.distributed process
group, gloo by default: its ranks may share one card, which NCCL refuses.

A CUDA tensor is staged through pinned host memory, in this module and
one code path for both devices: the copy to the host is followed by an
event and one labelled wait through runtime/syncs (`hist_exchange`), so
`host_syncs_per_tree()` counts every exchange; the result goes back up
without a wait.  A CPU tensor skips the copies and records the same
wait, so both devices count alike.  The host collectives (`host_*`) are
what a captured step runs between its graphs (runtime/graphs.py
Site, through `exchange`); `all_reduce`, `reduce_scatter` and `all_gather` stage them
for a tensor on either device.

Every rank must call the same collectives in the same order; the
growers and the boosting loop keep their control flow replicated (every
branch reads replicated state) so they do.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch

from ..runtime import syncs

#: the label of every staged exchange in the sync seam
LABEL = "hist_exchange"

#: bytes each rank has sent through this module (the payload of every
#: collective, counted once per call), for the per-tree exchange figures
bytes_sent = 0


def _dist():
    import torch.distributed as dist
    return dist


def is_distributed(group=None) -> bool:
    """Whether a process group of more than one rank is up."""
    dist = _dist()
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size(group) > 1)


def world_size(group=None) -> int:
    """Ranks of the group (1 without one)."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in the group (0 without one)."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def stage_out(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of t, after one labelled wait: through
    pinned memory from the card (the wait also covers the work queued
    before the copy), a clone on the CPU."""
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        syncs.wait_event(done, LABEL)
        return host
    syncs.record(LABEL)
    return t.detach().clone().contiguous()


def stage_in(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """host on like's device (up without a wait)."""
    if like.is_cuda:
        return host.to(like.device, non_blocking=True)
    return host


def _count(t: torch.Tensor) -> None:
    global bytes_sent
    bytes_sent += t.numel() * t.element_size()


# -- the collectives on host tensors (what a staged exchange runs) --------

def host_all_reduce(h: torch.Tensor, op: str = "sum",
                    group=None) -> torch.Tensor:
    """The elementwise sum (or max) of h over the ranks, in place.
    Integer sums are exact, so int64 fixed-point cells and int32 quantized
    histograms cross as they are; an f32 sum of two ranks is a + b on
    every rank (gloo's ring reduces each chunk once and broadcasts it)."""
    dist = _dist()
    _count(h)
    dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return h


def host_reduce_scatter(h: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of the sum over the ranks of h along dim 0,
    zero-padded to a multiple of the world size first (the JAX grower's
    psum_scatter(tiled=True) with its padding, grower2.py:409-414): block
    r is rows [r * n, (r + 1) * n) of the padded sum.  Each rank sends
    the blocks it does not keep."""
    dist = _dist()
    w = world_size(group)
    pad = -h.shape[0] % w
    if pad:
        h = torch.cat([h, h.new_zeros((pad,) + tuple(h.shape[1:]))])
    n = h.shape[0] // w
    out = torch.empty((n,) + tuple(h.shape[1:]), dtype=h.dtype)
    dist.reduce_scatter_tensor(out, h.contiguous(), group=group)
    _count(h[:n * (w - 1)])
    return out


def host_all_gather(h: torch.Tensor, group=None) -> torch.Tensor:
    """[world, *h.shape]: every rank's h, in rank order."""
    dist = _dist()
    _count(h)
    out = [torch.empty_like(h) for _ in range(world_size(group))]
    dist.all_gather(out, h, group=group)
    return torch.stack(out)


# -- the same, staged for a tensor on either device -----------------------

def exchange(op, t: torch.Tensor) -> torch.Tensor:
    """op (a host collective above, or a partial of one) applied to t:
    staged out, exchanged, staged back to t's device."""
    return stage_in(op(stage_out(t)), t)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """`host_all_reduce` of t, on t's device."""
    return exchange(functools.partial(host_all_reduce, op=op, group=group),
                    t)


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """`host_reduce_scatter` of t, on t's device."""
    return exchange(functools.partial(host_reduce_scatter, group=group), t)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """`host_all_gather` of t, on t's device."""
    return exchange(functools.partial(host_all_gather, group=group), t)


def all_gather_object(obj, group=None) -> List:
    """Every rank's picklable obj, in rank order (one labelled wait)."""
    dist = _dist()
    syncs.record(LABEL)
    out: List[Optional[object]] = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out

