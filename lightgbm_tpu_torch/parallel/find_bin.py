"""Distributed find-bin over a torch.distributed group (counterpart of
lightgbm_tpu/parallel/find_bin.py; dataset_loader.cpp:842-924 role).

The reference's distributed loader splits features across machines, each
rank runs find-bin on its slice of the sample, and the BinMappers are
all-gathered.  Here, as in the JAX package, each rank sketches the
quantiles of EVERY feature over its own row block of the sample, one
all-gather of the sketches and their valid counts crosses the group, and
a deterministic merge gives every rank the same boundaries.

A standalone function, as in the JAX package, whose training path does
not call it: Dataset construction keeps the exact host GreedyFindBin
(io/binning.py), which this weighted-quantile merge approximates (distinct
value counting does not distribute).
"""
from __future__ import annotations

import torch

from . import comm


def _local_quantile_sketch(x: torch.Tensor, n_sketch: int):
    """[n_local, F] -> ([F, n_sketch] evenly spaced order statistics of
    each feature's finite values, [F] valid counts); NaNs sort last and
    are left out by the count."""
    finite = torch.isfinite(x)
    cnt = finite.sum(dim=0)                                     # [F]
    xs = torch.sort(torch.where(finite, x, torch.full_like(x, float("inf"))),
                    dim=0).values.T                             # [F, n]
    c = torch.clamp(cnt, min=1).to(torch.float32)[:, None]
    pos = (torch.arange(n_sketch, device=x.device, dtype=torch.float32)
           + 0.5) / n_sketch * c - 0.5
    top = torch.clamp(cnt - 1, min=0)[:, None]
    idx = torch.minimum(torch.clamp(pos.to(torch.int32), min=0), top)
    return torch.gather(xs, 1, idx.long()), cnt


def make_distributed_find_bin(max_bin: int, n_sketch: int = 1024,
                              group=None):
    """Returns find(sample_block [n_local, F]) -> bounds [F, max_bin]: each
    feature's ascending bin upper bounds, the last +inf, the same on every
    rank of the group (one all-gather).  Every rank calls it with its own
    block of the sample (`shard_sample`)."""

    def find(sample: torch.Tensor) -> torch.Tensor:
        sk, cnt = _local_quantile_sketch(sample, n_sketch)
        # one exchange: every rank's sketch points and valid counts
        both = torch.cat([sk, cnt.to(sk.dtype)[:, None]], dim=1)
        allb = comm.all_gather(both, group)                # [W, F, S + 1]
        all_sk, all_cnt = allb[..., :n_sketch], allb[..., n_sketch]
        F = sk.shape[0]
        # each rank's points weighted by its valid count; global evenly
        # spaced quantiles of the merged sorted sketch
        merged = all_sk.permute(1, 0, 2).reshape(F, -1)
        weights = torch.repeat_interleave(all_cnt.T / n_sketch, n_sketch,
                                          dim=1)
        order = torch.argsort(merged, dim=1, stable=True)
        msort = torch.gather(merged, 1, order)
        wsort = torch.gather(weights, 1, order)
        cum = torch.cumsum(wsort, dim=1)
        total = cum[:, -1:]
        targets = (torch.arange(1, max_bin, device=sample.device,
                                dtype=torch.float32) / max_bin)[None] * total
        pos = torch.searchsorted(cum.contiguous(), targets.contiguous())
        pos = torch.clamp(pos, 0, msort.shape[1] - 1)
        bounds = torch.gather(msort, 1, pos)
        # strictly ascending (repeated quantile values would make bins no
        # row reaches): each bound at least a relative epsilon above its
        # predecessor, floored inside the normal f32 range
        prev = torch.full((F,), float("-inf"), dtype=bounds.dtype,
                          device=bounds.device)
        cols = []
        for j in range(bounds.shape[1]):
            b = bounds[:, j]
            eps = torch.clamp(torch.abs(prev) * 1e-6, min=1e-30)
            nb = torch.maximum(b, torch.where(torch.isfinite(prev),
                                              prev + eps, b))
            cols.append(nb)
            prev = nb
        inf = torch.full((F, 1), float("inf"), dtype=bounds.dtype,
                         device=bounds.device)
        return torch.cat([torch.stack(cols, dim=1), inf], dim=1)

    return find


def shard_sample(sample: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of the sample's rows (their count must divide by
    the world size)."""
    n, w, r = sample.shape[0], comm.world_size(group), comm.rank(group)
    if n % w:
        raise ValueError("sample rows (%d) must divide by the world size "
                         "(%d)" % (n, w))
    return sample[r * (n // w):(r + 1) * (n // w)]
