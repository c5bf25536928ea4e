"""The feature-parallel train step over a torch.distributed group
(counterpart of lightgbm_tpu/parallel/feature_parallel.py; the
reference's FeatureParallelTreeLearner, feature_parallel_tree_learner.cpp
:21-69): every rank holds every row, searches its own block of the
features and the winner crosses as one sync (the partitioned grower's
"feature" mode, which partitions its full rows by any winner's column, so
a rank keeps every column, laid out with its owned block first)."""
from __future__ import annotations

import numpy as np

from ..ops.split import pad_feature_meta  # noqa: F401  (re-export)
from ._common import make_step


def pad_features(bins: np.ndarray, feature_mask: np.ndarray,
                 num_shards: int):
    """Pad the feature axis to a multiple of the ranks; padded columns
    are all bin 0 and masked out of the search."""
    F = bins.shape[0]
    pad = -F % num_shards
    if pad:
        bins = np.concatenate([bins, np.zeros((pad, bins.shape[1]),
                                              bins.dtype)])
        feature_mask = np.concatenate([feature_mask, np.zeros(pad, bool)])
    return bins, feature_mask, F + pad


def make_feature_parallel_train_step(meta, cfg, num_bins_max: int,
                                     learning_rate: float, objective=None,
                                     group=None):
    """step(bins [F, N], score, label, weight, mask [N], feature_mask [F])
    -> (new score [N], tree arrays): every input whole on every rank; meta
    covers the (padded) features."""
    return make_step("feature", meta, cfg, num_bins_max, learning_rate,
                     objective, group)


def shard_features(bins, feature_mask, *replicated, group=None):
    """What a rank of the feature learner holds: every column and every
    row (its owned block is laid first inside the step)."""
    return (bins, feature_mask) + tuple(replicated)
