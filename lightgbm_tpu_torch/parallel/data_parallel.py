"""The data-parallel train step over a torch.distributed group
(counterpart of lightgbm_tpu/parallel/data_parallel.py; the reference's
DataParallelTreeLearner, data_parallel_tree_learner.cpp): rows are split
over the ranks, local histograms are reduce-scattered over the storage
columns, each rank searches its owned columns and one winner sync crosses
(the partitioned grower's "data" mode)."""
from __future__ import annotations

from ._common import make_step, take_block


def make_data_parallel_train_step(meta, cfg, num_bins_max: int,
                                  learning_rate: float, objective=None,
                                  group=None):
    """One boosting step on this rank's row block: gradients -> tree ->
    score update.  step(bins [F, n_local], score, label, weight, mask
    [n_local], feature_mask [F]) -> (new score [n_local], tree arrays, the
    same on every rank).  `objective` computes gradients row by row
    (binary logloss by default)."""
    return make_step("data", meta, cfg, num_bins_max, learning_rate,
                     objective, group)


def shard_rows(*arrays, group=None):
    """This rank's block of each per-row array (the last axis of 2-D)."""
    return tuple(take_block(a, group) for a in arrays)
