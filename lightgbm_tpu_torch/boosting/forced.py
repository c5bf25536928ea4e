"""Forced splits: forcedsplits_filename -> a static BFS schedule
(counterpart of lightgbm_tpu/boosting/forced.py).

Role of the reference's ForceSplits (serial_tree_learner.cpp:546-701): a
JSON tree {"feature": int, "threshold": float, "left": {...}, "right":
{...}} is imposed before gain-driven growth, breadth-first.  The host
compiles the JSON into per-rank tables (feature, bin, BFS child links),
and the grower carries a pending rank per leaf on the device.  Forced
leaves get gain priorities far above any real gain, so the grower's
argmax applies them first, in BFS order; an infeasible forced split
(min_data / min_sum_hessian violated) falls back on the leaf's
gain-driven best and, like the reference's aborted forcing queue, drops
its forced descendants.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.split import SplitResult, evaluate_split_at

# priority unit: forced rank j gets gain (n_forced - j) * UNIT, which
# dominates any real gain, preserves BFS order under argmax and is finite
# in f32 for any rank count a tree can hold
PRIORITY_UNIT = 1e30


class ForcedSchedule(NamedTuple):
    """Hashable (all-tuple) forced-split plan, indexed by BFS rank."""
    feat: Tuple[int, ...]    # [n] split feature per rank
    bin: Tuple[int, ...]     # [n] threshold bin per rank
    gain: Tuple[float, ...]  # [n] argmax priority per rank
    lnext: Tuple[int, ...]   # [n] rank forced on the left child, -1 if none
    rnext: Tuple[int, ...]   # [n] rank forced on the right child, -1 if none


def load_forced_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def build_forced_schedule(root_json, bin_mappers,
                          num_leaves: int) -> Optional[ForcedSchedule]:
    """Compile the forced-split JSON into a ForcedSchedule (BFS ranks).

    Thresholds are real feature values, converted through each feature's
    BinMapper (BinMapper::ValueToBin) exactly as the reference does when it
    materializes a forced SplitInfo."""
    if not root_json:
        return None
    feat, bins, lnext, rnext = [], [], [], []
    queue = [(root_json, None, 0)]   # (node, parent_rank, side)
    while queue and len(feat) < num_leaves - 1:
        node, parent, side = queue.pop(0)
        rank = len(feat)
        f = int(node["feature"])
        if not 0 <= f < len(bin_mappers):
            raise ValueError("forced split names feature %d but the dataset "
                             "has %d features" % (f, len(bin_mappers)))
        mapper = bin_mappers[f]
        b = int(mapper.value_to_bin(float(node["threshold"])))
        # a forced threshold at/above the last bin can never send rows right
        b = min(b, max(int(mapper.num_bin) - 2, 0))
        feat.append(f)
        bins.append(b)
        lnext.append(-1)
        rnext.append(-1)
        if parent is not None:
            (lnext if side == 0 else rnext)[parent] = rank
        if node.get("left"):
            queue.append((node["left"], rank, 0))
        if node.get("right"):
            queue.append((node["right"], rank, 1))

    n = len(feat)
    if n == 0:
        return None
    gain = [(n - j) * PRIORITY_UNIT for j in range(n)]
    return ForcedSchedule(feat=tuple(feat), bin=tuple(bins),
                          gain=tuple(gain), lnext=tuple(lnext),
                          rnext=tuple(rnext))


def _where(use: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with `use` ([Q]) broadcast over a's trailing axes."""
    return torch.where(use.reshape(use.shape + (1,) * (a.dim() - use.dim())),
                       a, b.to(a.dtype))


def make_forced_machinery(forced: ForcedSchedule, meta, cfg, device,
                          monotone: bool = False, evaluate=None):
    """The schedule's device tables and the override closure of the
    grower (the JAX package's make_forced_machinery).

    Returns (fc_lnext, fc_rnext, forced_override): the BFS child links
    ([n] int64 on `device`), and forced_override(rank, hists, sg, sh, sc,
    normal[, min_constraint, max_constraint]) -> (result, real gain,
    surviving rank), for Q leaves at once: rank [Q] int64 (-1: nothing
    forced), hists [Q, F, B, 3], the leaf totals and `normal` (the
    leaves' own best splits) [Q].  Where the rank is live and its split
    feasible, the forced split replaces the leaf's best, with its
    priority gain in the result and its real gain beside it.

    evaluate (the feature-parallel grower): replaces evaluate_split_at
    with a callable of the same arguments, which evaluates the forced
    split on the rank that owns its feature and syncs the result."""
    if evaluate is None:
        evaluate = evaluate_split_at
    def t(values, dtype):
        return torch.tensor(values, dtype=dtype, device=device)

    fc_feat = t(forced.feat, torch.int64)
    fc_bin = t(forced.bin, torch.int64)
    fc_gain = t(forced.gain, torch.float32)
    fc_lnext = t(forced.lnext, torch.int64)
    fc_rnext = t(forced.rnext, torch.int64)

    def forced_override(rank, hists, sg, sh, sc, normal: SplitResult,
                        min_constraint=None, max_constraint=None):
        r0 = rank.clamp(min=0)
        fres = evaluate(
            hists, sg, sh, sc, fc_feat[r0], fc_bin[r0], meta=meta,
            l1=cfg.lambda_l1, l2=cfg.lambda_l2,
            max_delta_step=cfg.max_delta_step,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            monotone=monotone, min_constraint=min_constraint,
            max_constraint=max_constraint)
        use = (rank >= 0) & torch.isfinite(fres.gain)
        real = torch.where(use, fres.gain, normal.gain)
        res = SplitResult(*[_where(use, a, b) for a, b in
                            zip(fres._replace(gain=fc_gain[r0]), normal)])
        return res, real, torch.where(use, rank, -1)

    return fc_lnext, fc_rnext, forced_override
