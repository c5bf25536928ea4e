"""Shared plumbing of the standalone parallel train steps (counterpart of
lightgbm_tpu/parallel/_common.py).

The JAX package's steps run its masked grower inside `shard_map`; the
port has no masked grower, so each step lays this rank's rows out as a
partitioned grower's payload and grows it in the grower's mesh mode over
a torch.distributed group (boosting/grower2.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..boosting.grower2 import PayloadCols, make_partitioned_grower
from ..ops import segment as seg
from ..ops.split import owned_first
from ..utils.log import LightGBMError
from . import comm


def resolve_objective(objective):
    """Binary logloss by default; a multiclass objective is refused: every
    step drives ONE score plane (call it per class plane instead)."""
    if objective is None:
        from ..config import Config
        from ..objective.binary import BinaryLogloss
        objective = BinaryLogloss(Config({"objective": "binary"}))
    if objective.num_model_per_iteration > 1:
        raise LightGBMError(
            "parallel train steps handle one score plane; drive multiclass "
            "by calling them per class plane (num_model_per_iteration=%d)"
            % objective.num_model_per_iteration)
    return objective


def make_step(mode: str, meta, cfg, num_bins_max: int, learning_rate: float,
              objective=None, group=None, top_k: int = 20):
    """gradients -> grow -> score update, shared by data / voting /
    feature: step(bins [F, n], score [n], label [n], weight [n], mask [n],
    feature_mask [F]) -> (new score [n], tree arrays), every input this
    rank's (its row block under data / voting, every row under feature)."""
    objective = resolve_objective(objective)
    world, rank = comm.world_size(group), comm.rank(group)
    cache = {}

    def step(bins, score, label, weight, mask, feature_mask):
        bins = torch.as_tensor(np.asarray(bins))
        F, n = bins.shape
        dev = torch.as_tensor(score).device
        f32 = dict(dtype=torch.float32, device=dev)
        score = torch.as_tensor(score, **f32)
        mask = torch.as_tensor(mask, **f32)
        grad, hess = objective.get_gradients(
            score, torch.as_tensor(label, **f32),
            torch.as_tensor(weight, **f32))
        grad, hess = grad * mask, hess * mask
        # payload: bins (feature: owned first) | grad | hess | cnt |
        # value | row
        cols = PayloadCols(grad=F, hess=F + 1, cnt=F + 2, value=F + 3)
        pay = torch.zeros((n + seg.GUARD, F + 5), **f32)
        order = torch.arange(F)
        if mode == "feature":
            gl = -(-F // world)
            order = owned_first(gl * world, rank * gl, gl)[:F]
            order = torch.where(order < F, order, 0)
        pay[:n, :F] = bins[order].T.to(**f32)
        pay[:n, F], pay[:n, F + 1], pay[:n, F + 2] = grad, hess, mask
        pay[:n, F + 4] = torch.arange(n, **f32)
        amax = torch.stack([grad.abs().amax(), hess.abs().amax()])
        rows = n + seg.GUARD
        if mode != "feature":
            amax = comm.all_reduce(amax, "max", group)
            rows = n * world + seg.GUARD
        key = (F, n, str(dev))
        if key not in cache:
            cache.clear()
            cache[key] = make_partitioned_grower(
                meta, cfg, num_bins_max, cols, F, mode=mode, group=group,
                top_k=top_k)
        out, pay, _ = cache[key](pay, torch.zeros_like(pay),
                                 torch.as_tensor(feature_mask,
                                                 dtype=torch.bool,
                                                 device=dev),
                                 hist_scale=seg.fixed_exponents(amax, rows))
        delta = torch.empty(n, **f32)
        delta[pay[:n, F + 4].long()] = pay[:n, cols.value]
        new_score = torch.where(out["num_leaves"] > 1,
                                score + learning_rate * delta, score)
        tree = {k: v for k, v in out.items()
                if k not in ("seg_start", "seg_cnt", "host_syncs")}
        return new_score, tree

    return step


def take_block(t, group=None):
    """This rank's block of a per-row array (the last axis of a 2-D one):
    rows [r * n, (r + 1) * n) of n = rows / world."""
    t = np.asarray(t)
    w, r = comm.world_size(group), comm.rank(group)
    n = t.shape[-1] // w
    return t[..., r * n:(r + 1) * n]
