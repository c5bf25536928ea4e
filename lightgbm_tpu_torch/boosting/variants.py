"""Boosting variants: GOSS, DART, RF (counterpart of
lightgbm_tpu/boosting/variants.py).

Role parity with the reference src/boosting/goss.hpp (gradient-based
one-side sampling), dart.hpp (dropout boosting with tree-weight
renormalization) and rf.hpp (random forest: bagged trees of the
zero-score gradients, running average of converted outputs);
`create_boosting` mirrors src/boosting/boosting.cpp:30-64.

All three ride the partition-ordered fast path of gbdt.GBDT, on the
device with one blocking fetch per tree:
- GOSS samples inside the gradient fill (`_FastState.fill_sampled`):
  a top-k of sum_k |g h| and a uniform draw from the JAX package's
  threefry stream (utils/threefry.py), over the payload's rows in
  partition order as the JAX package's partitioned path draws, or over
  the rows in original order, gathered through the index column, where
  the JAX package trains on its masked grower (a non-rowwise objective,
  leaf renewal, a custom objective's gradients), so both packages select
  the same rows;
- DART's drop and normalize edits replay trees over the payload's own
  bin columns (`GBDT._add_tree_to_train_score`);
- RF grows each tree on the zero score's gradients (of a non-rowwise
  objective too), masked by the bagged count column, and folds the
  running average into the payload and every validation set.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import threefry
from ..utils.log import LightGBMError, Log
from ..utils.random import Random, partition_seed
from .gbdt import GBDT, _depth_iters, _FastState, _traverse_add


def goss_masks(grads: torch.Tensor, hesss: torch.Tensor,
               valid: torch.Tensor, key: Tuple[int, int], top_k: int,
               other_k: int, multiply: float,
               rows: Optional[torch.Tensor] = None, n_draw: int = 0):
    """GOSS's selection (the JAX package's _goss_masks; goss.hpp
    BaggingHelper): the top_k rows by sum_k |g h| (ties at the threshold
    all in), other_k of the rest drawn by the smallest uniforms of
    `key`'s stream over the rows (ties in too), the rest amplified by
    `multiply` = (n - top_k) / other_k.  grads / hesss: [K, n]; valid:
    [n] bool.  With `rows` ([n] int64, each row's original row in
    [0, n_draw]) the stream is drawn over n_draw rows in original order
    and each row takes its original row's uniform (row n_draw, a guard,
    takes 0 and is never drawn).  Returns the f32 (gradient weight, count
    mask), [n] each,
    computed on the rows' device with no host read.  The classes' |g h|
    are summed in class order, one add at a time (as XLA sums the JAX
    package's K rows), not by a reduction whose order the card picks."""
    prod = torch.abs(grads * hesss)
    gh = prod[0]
    for k in range(1, prod.shape[0]):
        gh = gh + prod[k]
    gh = torch.where(valid, gh, float("-inf"))
    thresh = torch.sort(gh, descending=True).values[top_k - 1]
    is_top = valid & (gh >= thresh)
    rest = valid & ~is_top
    if rows is None:
        r = threefry.uniform(key, gh.shape[0], gh.device)
    else:
        r = threefry.uniform(key, n_draw, gh.device)
        r = torch.cat([r, r.new_zeros(1)])[rows]
    r = torch.where(rest, r, float("inf"))
    kth = torch.sort(r).values[other_k - 1]
    sampled = rest & (r <= kth)
    one = torch.ones((), dtype=torch.float32, device=gh.device)
    gmask = torch.where(is_top, one,
                        torch.where(sampled, one * np.float32(multiply),
                                    torch.zeros_like(one)))
    return gmask, (is_top | sampled).to(torch.float32)


class GOSS(GBDT):
    """Gradient-based One-Side Sampling (goss.hpp:26-210)."""

    _sampled_fill = True

    def __init__(self, config, train_set, objective, metrics, device,
                 init_model=None):
        super().__init__(config, train_set, objective, metrics, device,
                         init_model)
        if config.top_rate + config.other_rate > 1.0:
            Log.fatal("top_rate + other_rate cannot be larger than 1.0")
        if config.top_rate <= 0.0 or config.other_rate <= 0.0:
            Log.fatal("top_rate and other_rate must be positive for GOSS")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            Log.fatal("Cannot use bagging in GOSS")
        Log.info("Using GOSS")
        self._goss_key = threefry.prng_key(partition_seed(
            int(config.seed or 0) + int(config.bagging_seed), 3))
        n = train_set.num_data
        self._goss_top_k = max(1, int(n * config.top_rate))
        self._goss_other_k = max(1, int(n * config.other_rate))
        self._goss_multiply = float(
            (n - self._goss_top_k) / self._goss_other_k)
        # no subsampling for the first 1 / learning_rate iterations
        # (goss.hpp:137)
        self._goss_warmup = int(1.0 / config.learning_rate)

    def sample_key(self) -> Optional[Tuple[int, int]]:
        """This iteration's threefry key, or None in the warm-up."""
        if self.iter < self._goss_warmup:
            return None
        return threefry.fold_in(self._goss_key, self.iter)

    def draws_in_original_order(self, custom=None) -> bool:
        """Whether the uniform draw runs over the rows in original order:
        where the JAX package trains GOSS on its masked grower (its
        _fast_eligible refuses GOSS with a non-rowwise objective or leaf
        renewal, and custom gradients always train masked), whose
        _bagging_masks draws over the padded rows in original order.
        Elsewhere its partitioned path draws in the payload's order."""
        obj = self.objective
        return custom is not None or not getattr(obj, "is_rowwise", True) \
            or obj.renew_tree_output_required()

    def _fill(self, fs: _FastState, k: int, custom=None):
        key = self.sample_key()
        hook = None
        if key is not None:
            original = self.draws_in_original_order(custom)

            def hook(g, h, valid):
                order = dict(rows=fs.row_index(), n_draw=fs.n_pad) \
                    if original else {}
                return goss_masks(g, h, valid > 0, key, self._goss_top_k,
                                  self._goss_other_k, self._goss_multiply,
                                  **order)
        return fs.fill_sampled(self.objective, k, hook, custom)


class DART(GBDT):
    """Dropout boosting (dart.hpp:17-200): drop a random subset of this
    run's trees before the new one, shrink the new tree by lr / (1 + k),
    then renormalize the dropped trees so the training and validation
    scores stay consistent.  The drops draw on the host
    (Random(drop_seed)); their score edits replay the trees on the
    device."""

    def __init__(self, config, train_set, objective, metrics, device,
                 init_model=None):
        super().__init__(config, train_set, objective, metrics, device,
                         init_model)
        self.random_for_drop = Random(int(config.drop_seed))
        self.tree_weight: list = []
        self.sum_weight = 0.0
        self.drop_index: list = []
        Log.info("Using DART")

    def _run_tree(self, i: int, k: int):
        """Tree k of this run's iteration i, past any loaded model's."""
        K = self.num_tree_per_iteration
        return self.model.trees[(self.num_init_iteration + i) * K + k]

    def train_one_iter(self, grad=None, hess=None) -> bool:
        self._dropping_trees()
        stopped = super().train_one_iter(grad, hess)
        if stopped:
            return stopped
        self._normalize()
        if not bool(self.config.uniform_drop):
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def _dropping_trees(self) -> None:
        """dart.hpp DroppingTrees: draw the drop list, subtract the
        dropped trees from the training scores, set the shrinkage."""
        cfg = self.config
        K = self.num_tree_per_iteration
        self.drop_index = []
        is_skip = self.random_for_drop.next_float() < float(cfg.skip_drop)
        n_iter = self.iter
        if not is_skip and n_iter > 0:
            drop_rate = float(cfg.drop_rate)
            max_drop = int(cfg.max_drop)
            if not bool(cfg.uniform_drop):
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if max_drop > 0:
                        drop_rate = min(drop_rate,
                                        max_drop * inv_avg / self.sum_weight)
                    for i in range(n_iter):
                        if self.random_for_drop.next_float() < \
                                drop_rate * self.tree_weight[i] * inv_avg:
                            self.drop_index.append(i)
                            if max_drop > 0 and \
                                    len(self.drop_index) >= max_drop:
                                break
            else:
                if max_drop > 0:
                    drop_rate = min(drop_rate, max_drop / float(n_iter))
                for i in range(n_iter):
                    if self.random_for_drop.next_float() < drop_rate:
                        self.drop_index.append(i)
                        if max_drop > 0 and len(self.drop_index) >= max_drop:
                            break
        # dart.hpp:119-126; candidates are this run's trees
        for i in self.drop_index:
            for k in range(K):
                self._add_tree_to_train_score(self._run_tree(i, k), k, -1.0)
        k_cnt = float(len(self.drop_index))
        lr = float(cfg.learning_rate)
        if not bool(cfg.xgboost_dart_mode):
            self.shrinkage_rate = lr / (1.0 + k_cnt)
        else:
            self.shrinkage_rate = lr if not self.drop_index \
                else lr / (lr + k_cnt)

    def _normalize(self) -> None:
        """dart.hpp Normalize: the dropped trees end scaled by k / (k + 1)
        (k / (k + lr) in xgboost mode); the training scores regain
        factor * tree, the validation scores lose (1 - factor) * tree."""
        k = float(len(self.drop_index))
        if k == 0:
            return
        cfg = self.config
        lr = float(cfg.learning_rate)
        K = self.num_tree_per_iteration
        if not bool(cfg.xgboost_dart_mode):
            factor = k / (k + 1.0)
            weight_sub = 1.0 / (k + 1.0)
        else:
            factor = k / (k + lr)
            weight_sub = 1.0 / (k + lr)
        for i in self.drop_index:
            for kk in range(K):
                tree = self._run_tree(i, kk)
                self._add_tree_to_valid_scores(tree, kk, factor - 1.0)
                self._add_tree_to_train_score(tree, kk, factor)
                tree.apply_shrinkage(factor)
            if not bool(cfg.uniform_drop):
                self.sum_weight -= self.tree_weight[i] * weight_sub
                self.tree_weight[i] *= factor


class RF(GBDT):
    """Random forest (rf.hpp:18-207): every tree fits the gradients of
    the zero score, bagging and feature sampling are mandatory, leaf
    outputs are converted through the objective, and the score is the
    running average of the trees."""

    _fused_score_add = False
    _piecewise_profile = False

    def __init__(self, config, train_set, objective, metrics, device,
                 init_model=None):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            Log.fatal("RF mode requires bagging (bagging_freq > 0, "
                      "bagging_fraction in (0,1))")
        if not 0.0 < config.feature_fraction < 1.0:
            Log.fatal("RF mode requires feature_fraction in (0, 1)")
        if objective is None:
            Log.fatal("RF mode requires an objective function (no custom "
                      "fobj)")
        super().__init__(config, train_set, objective, metrics, device,
                         init_model)
        if self.num_tree_per_iteration != 1:
            Log.fatal("Cannot use RF for multi-class")
        if train_set.metadata.init_score is not None:
            Log.fatal("Cannot use init_score in RF mode")
        self.shrinkage_rate = 1.0
        self.model.average_output = True
        # continued training: GBDT replayed the loaded trees as a SUM; RF
        # scores are running averages (rf.hpp:33-38)
        if self.num_init_iteration > 0:
            self._multiply_scores(0, 1.0 / self.num_init_iteration)
        self._leaf_transform = objective.convert_output
        self._metric_objective = None
        Log.info("Using RF")

    def _boost_from_average(self) -> float:
        return 0.0

    def reset_config(self, new_params) -> None:
        # rf.hpp ResetConfig: the shrinkage stays 1.0
        super().reset_config(new_params)
        self.shrinkage_rate = 1.0

    def _fill(self, fs: _FastState, k: int, custom=None):
        return fs.fill_gradients(self.objective, k, zero_score=True)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One tree of the zero score's gradients (the JAX package's
        _train_one_iter_fast_rf), then the running-average fold
        score = score * m / (m + 1) + tree / (m + 1) on the payload and
        on every validation set.  A stump's leaf is 0 and folds
        nothing."""
        if grad is not None or hess is not None:
            raise LightGBMError("RF mode requires an objective function "
                                "(no custom fobj)")
        fs = self._enter_fast()
        fmask = self._feature_sample()
        self._refresh_bag(fs)
        tree = self._train_tree(fs, fmask, 0.0, 0)
        m = float(self.iter + self.num_init_iteration)
        if tree.num_leaves > 1:
            self._rf_fold(tree, m)
        else:
            tree.leaf_value[0] = 0.0
        self.model.trees.append(tree)
        self.iter += 1
        return False

    def _rf_fold(self, tree, m: float) -> None:
        """The running average over m earlier trees: the payload's score
        scales by m / (m + 1) and adds tree / (m + 1), in f32 as the JAX
        package's rf_score_update computes them; each validation set by
        f32(m / (m + 1)) and tree / f32(m + 1), as its fold does."""
        fs = self._fast
        m32 = np.float32(m)
        fs.scale_score(m32 / (m32 + np.float32(1.0)), 0)
        tree_dev, leaf_out = self._tree_to_device(tree)
        depth = _depth_iters(tree)
        fs.payload_tree_add(tree_dev, leaf_out / (m32 + np.float32(1.0)), 0,
                            self.meta, self._bmap, depth)
        leaf_v = leaf_out / np.float32(m + 1.0)
        for vs in self.valid_sets:
            vs[3][0] *= np.float32(m / (m + 1.0))
            _traverse_add(vs[2], vs[3], leaf_v, tree_dev, self.meta,
                          self._bmap, depth)


def create_boosting(boosting_type: str, config, train_set, objective,
                    metrics, device: torch.device,
                    init_model=None) -> GBDT:
    """Factory keyed on config.boosting (boosting.cpp:30-64)."""
    if boosting_type in ("gbdt", "gbrt"):
        return GBDT(config, train_set, objective, metrics, device, init_model)
    if boosting_type == "dart":
        return DART(config, train_set, objective, metrics, device, init_model)
    if boosting_type == "goss":
        return GOSS(config, train_set, objective, metrics, device, init_model)
    if boosting_type in ("rf", "random_forest"):
        return RF(config, train_set, objective, metrics, device, init_model)
    Log.fatal("Unknown boosting type %s", boosting_type)
