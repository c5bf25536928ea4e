"""GBDT boosting engine (counterpart of lightgbm_tpu/boosting/gbdt.py).

Role parity with the reference src/boosting/gbdt.cpp: Init, TrainOneIter
(:387-482), BoostFromAverage (:363-385).  This slice ports the serial
partition-ordered fast path for one tree per iteration (K = 1): the
`_FastState` payload, the fused step (gradient fill -> grow -> score
add), `_boost_from_average` and `_finish_tree_host`, in f32 or with
quantized gradients (gradient_quantization: the grad/hess columns hold
integers, histograms are int32), growing one leaf per round or
frontier-batched (tpu_frontier_batch), with the histogram pool
(histogram_pool_size) or the grower's merged mode (its own rule; no
config key reaches it, as in the JAX package), and validation sets,
scored on the device after every tree by bin-level traversal
(`add_valid`).
Bagging, GOSS, DART, RF, the non-finite sentinel and the parallel
learners are not ported; asking for one raises.  boost_window and
pipeline_depth change only how the JAX package dispatches its work, never
the model, and are accepted as no-ops.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.binning import BIN_TYPE_CATEGORICAL
from ..io.dataset import BinnedDataset
from ..models.gbdt_model import GBDTModel
from ..models.tree import Tree
from ..ops import segment as seg
from ..ops.quantize import (F32_GH_BYTES, QUANT_GH_BYTES, derive_qmax,
                            quant_seed, quantize_pair)
from ..ops.bundle import BundleMap, decode_bin, identity_bundle_map
from ..ops.split import MISSING_NAN, MISSING_ZERO, FeatureMeta
from ..utils.log import Log
from ..utils.random import Random, partition_seed
from .grower2 import GrowerConfig, PayloadCols, make_partitioned_grower

K_EPSILON = 1e-15

#: f32 holds every integer row index exactly below this (the JAX package
#: switches to a radix-split index column past it; this slice raises)
_IDX_EXACT_LIMIT = 1 << 24


def _construct_bitset(vals) -> list:
    """Common::ConstructBitset — uint32 words spanning [0, max(vals)]."""
    if not vals:
        return []
    words = [0] * (max(vals) // 32 + 1)
    for v in vals:
        words[v // 32] |= 1 << (v % 32)
    return words


def feature_meta(ds: BinnedDataset, device) -> FeatureMeta:
    """Per-feature split metadata of a binned dataset, on `device`."""
    m = ds.bin_mappers

    def t(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

    return FeatureMeta(
        num_bin=t([mm.num_bin for mm in m], torch.int32),
        missing_type=t([mm.missing_type for mm in m], torch.int32),
        default_bin=t([mm.default_bin for mm in m], torch.int32),
        is_trivial=t([mm.is_trivial for mm in m], torch.bool),
        is_categorical=t([mm.bin_type == BIN_TYPE_CATEGORICAL for mm in m],
                         torch.bool),
        penalty=t(ds.feature_penalty, torch.float32),
        monotone=t(ds.monotone_constraints, torch.int32),
    )


class _FastState:
    """Partition-ordered training state: ONE row-major payload matrix
    [N_pad + GUARD, P] f32 that the grower reorders in place, with the
    JAX package's column layout for K = 1 (gbdt.py:279-305):

        bins 0..G-1 | label | weight | cnt | idx | score | grad | hess |
        value | bvalid | gweight

    so P = G + 10 (38 at 28 features).  The TPU pads P to 128 lanes; that
    padding does not carry over.  Guard rows carry idx == n_pad."""

    def __init__(self, gbdt: "GBDT", score: torch.Tensor):
        ds = gbdt.train_set
        dev = gbdt.device
        G = ds.bins.shape[0]
        n_pad = ds.num_data_padded
        self.G, self.n_pad = G, n_pad
        self.n_rows = n_pad + seg.GUARD
        self.label_col = G
        self.weight_col = G + 1
        self.cnt_col = G + 2
        self.idx_col = G + 3
        self.score0 = G + 4
        self.grad_col = self.score0 + 1
        self.hess_col = self.grad_col + 1
        self.value_col = self.grad_col + 2
        self.bvalid_col = self.value_col + 1
        self.gweight_col = self.bvalid_col + 1
        self.P = self.gweight_col + 1
        self.cols = PayloadCols(grad=self.grad_col, hess=self.hess_col,
                                cnt=self.cnt_col, value=self.value_col)
        Log.info("fast path payload: %d rows x %d cols, %.2f GB "
                 "(+%.2f GB partition scratch) on %s", self.n_rows, self.P,
                 self.n_rows * self.P * 4 / 2**30,
                 self.n_rows * self.P * 4 / 2**30, dev)

        md = ds.metadata
        pay = torch.zeros((self.n_rows, self.P), dtype=torch.float32,
                          device=dev)
        pay[:n_pad, :G] = torch.as_tensor(ds.bins, device=dev).T \
            .to(torch.float32)
        pay[:n_pad, G] = torch.as_tensor(ds.padded(md.label), device=dev)
        weight = md.weight if md.weight is not None \
            else np.ones(ds.num_data, np.float32)
        pay[:n_pad, G + 1] = torch.as_tensor(ds.padded(weight), device=dev)
        vmask = torch.as_tensor(ds.valid_row_mask(), device=dev)
        pay[:n_pad, self.cnt_col] = vmask
        pay[:n_pad, self.bvalid_col] = vmask
        pay[:, self.idx_col] = float(n_pad)
        pay[:n_pad, self.idx_col] = torch.arange(n_pad, device=dev,
                                                 dtype=torch.float32)
        pay[:n_pad, self.score0] = score[0]
        self.payload = pay
        self.aux = torch.zeros_like(pay)

    def fill_gradients(self, objective, qmax: int = 0,
                       generator: Optional[torch.Generator] = None):
        """Write the masked gradients of the current scores into the
        grad/hess columns, in the payload's current row order.  With
        qmax > 0 (the quantized mode, gbdt.py:500-511 of the JAX package)
        they are quantized first, after the count mask, with `generator`'s
        draws, and the [2] scales are returned; else None."""
        pay = self.payload
        g, h = objective.get_gradients_multi(pay[:, self.score0][None],
                                             pay[:, self.label_col],
                                             pay[:, self.weight_col])
        valid = pay[:, self.cnt_col]
        g, h = g[0] * valid, h[0] * valid
        qscale = None
        if qmax:
            g, h, qscale = quantize_pair(g, h, generator, float(qmax))
        seg.payload_col_write(pay, self.grad_col, g)
        seg.payload_col_write(pay, self.hess_col, h)
        return qscale

    def raw_scores(self) -> np.ndarray:
        """[1, n_pad] scores in ORIGINAL row order (host)."""
        h = self.payload[:, self.idx_col:self.score0 + 1].cpu().numpy()
        idx = h[:, 0].astype(np.int64)
        keep = idx < self.n_pad
        out = np.zeros((1, self.n_pad), np.float32)
        out[0, idx[keep]] = h[keep, 1]
        return out


def _traverse_add(bins_v: torch.Tensor, score_v: torch.Tensor,
                  leaf_out: torch.Tensor, tree_dev: Dict[str, torch.Tensor],
                  meta: FeatureMeta, bmap: BundleMap,
                  depth_iters: int) -> None:
    """score_v[0] += leaf_out[leaf of each row], in place: one tree's
    bin-level traversal over a [G, M] binned matrix, `depth_iters` steps of
    Tree::DecisionInner (tree.h:234-249 / 288-295).  The JAX package's
    _make_decision_body and _traverse_update (gbdt.py:858-911), eager."""
    M = bins_v.shape[1]
    rows = torch.arange(M, device=bins_v.device)
    sf, sb, dl = (tree_dev["split_feature"], tree_dev["split_bin"],
                  tree_dev["default_left"])
    lc, rc = tree_dev["left_child"], tree_dev["right_child"]
    is_cat, cat_bitset = tree_dev["split_is_cat"], tree_dev["split_cat_bitset"]
    nd = torch.zeros(M, dtype=torch.int64, device=bins_v.device)
    for _ in range(depth_iters):
        is_leaf = nd < 0
        ndc = nd.clamp(min=0)
        f = sf[ndc]
        raw = bins_v[bmap.f_group[f].long(), rows]
        num_bin, default_bin = meta.num_bin[f], meta.default_bin[f]
        fbin = decode_bin(raw, bmap.f_identity[f], bmap.f_offset[f], num_bin,
                          default_bin)
        mt = meta.missing_type[f]
        is_missing = ((mt == MISSING_NAN) & (fbin == num_bin - 1)) | \
                     ((mt == MISSING_ZERO) & (fbin == default_bin))
        go_left = torch.where(is_missing, dl[ndc], fbin <= sb[ndc])
        go_left = torch.where(
            is_cat[ndc],
            cat_bitset[ndc, fbin.clamp(0, cat_bitset.shape[1] - 1).long()],
            go_left)
        child = torch.where(go_left, lc[ndc], rc[ndc]).long()
        nd = torch.where(is_leaf, nd, child)
    score_v[0] += leaf_out[~nd]


def _depth_iters(tree: Tree) -> int:
    """Traversal steps that take every row to its leaf: the tree's depth.
    The JAX package runs num_leaves - 1 steps (a static trip count for
    jit); the steps past the depth leave every row where it is."""
    depth, stack = 0, [(0, 1)]
    while stack:
        node, d = stack.pop()
        for child in (int(tree.left_child[node]), int(tree.right_child[node])):
            if child < 0:
                depth = max(depth, d)
            else:
                stack.append((child, d + 1))
    return depth


def _fetch_packed(out: Dict) -> Dict[str, np.ndarray]:
    """The grower's small outputs in ONE device-to-host transfer: every
    tensor field is exact in f32 (counts and ids < 2^24, flags 0/1), so
    they are flattened and concatenated on the device, fetched once and
    split on the host."""
    keys = sorted(k for k, v in out.items() if isinstance(v, torch.Tensor))
    flat = torch.cat([out[k].to(torch.float32).reshape(-1) for k in keys])
    flat = flat.cpu().numpy()
    host = {k: v for k, v in out.items() if not isinstance(v, torch.Tensor)}
    off = 0
    for k in keys:
        n = out[k].numel()
        a = flat[off:off + n].reshape(tuple(out[k].shape))
        host[k] = a if out[k].dtype == torch.float32 \
            else a.astype(str(out[k].dtype).replace("torch.", ""))
        off += n
    return host


class GBDT:
    """The boosting engine behind Booster."""

    def __init__(self, config, train_set: BinnedDataset, objective,
                 metrics: List, device: torch.device):
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.train_metrics = metrics
        self.device = device
        self.iter = 0
        self._check_supported()
        self.shrinkage_rate = float(config.learning_rate)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = 1
        #: host syncs of every finished tree (grower loop tests + the fetch)
        self.host_syncs: List[int] = []
        #: sequential grower rounds paid by the finished trees (== splits
        #: unless the frontier-batched grower committed several per round)
        self.split_rounds_total = 0
        self.trees_finished = 0
        #: [name, dataset, bins on the device, [1, n_pad] scores, metrics]
        self.valid_sets: List[list] = []

        # quantized-gradient training (the JAX package's gate,
        # gbdt.py:994-1026): the grid is capped by the int32 overflow
        # bound, which raises when no grid is left
        self._qmax = 0
        self.quant_report = None
        if bool(config.gradient_quantization):
            qdtype = str(config.gradient_quant_dtype or "int16")
            self._qmax = derive_qmax(train_set.num_data_padded, qdtype)
            gh_bytes = QUANT_GH_BYTES[qdtype]
            self.quant_report = {
                "dtype": qdtype, "qmax": self._qmax,
                "hist_gh_bytes_per_row": gh_bytes,
                "hist_bytes_reduction_vs_f32": F32_GH_BYTES / gh_bytes,
            }
            Log.info("gradient quantization on: %s grid (qmax=%d)", qdtype,
                     self._qmax)

        self.model = GBDTModel()
        self.model.num_class = self.num_class
        self.model.num_tree_per_iteration = self.num_tree_per_iteration
        self.model.max_feature_idx = train_set.num_features - 1
        self.model.feature_names = list(train_set.feature_names)
        self.model.feature_infos = train_set.feature_infos()
        self.model.objective_str = objective.to_string()

        self.meta = feature_meta(train_set, device)
        self._bmap = identity_bundle_map(train_set.num_features, device)
        self.grower_cfg = GrowerConfig(
            num_leaves=int(config.num_leaves),
            max_depth=int(config.max_depth),
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            max_delta_step=float(config.max_delta_step),
            min_data_in_leaf=int(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            frontier_batch=max(1, int(config.tpu_frontier_batch or 1)),
            quantized=self._qmax > 0, qmax=self._qmax,
            hist_pool_slots=self._hist_pool_slots(config, train_set))

        md = train_set.metadata
        n_pad = train_set.num_data_padded
        # pre-payload scores; the payload's score column takes over at the
        # first iteration
        self.score = torch.zeros((1, n_pad), dtype=torch.float32,
                                 device=device)
        objective.init(md.label, md.weight, md.query_boundaries)
        self._fast: Optional[_FastState] = None
        self.grower = None

        seed = int(getattr(config, "seed", 0) or 0)
        self.feature_rng = Random(partition_seed(
            seed + int(config.feature_fraction_seed), 2))
        self._boosted_from_average = False

    @staticmethod
    def _hist_pool_slots(config, train_set: BinnedDataset) -> int:
        """histogram_pool_size (MB, the reference's HistogramPool) -> pool
        slots of the grower, at least 2 (the JAX package's
        gbdt.py:1207-1227).  -1 keeps one histogram per leaf (0) unless
        that alone would pass 4 GB of device memory, where the pool caps
        itself with a warning."""
        L = int(config.num_leaves)
        slot_bytes = train_set.bins.shape[0] * train_set.max_num_bin * 3 * 4
        pool_mb = float(getattr(config, "histogram_pool_size", -1.0) or -1.0)
        if pool_mb > 0:
            return max(2, min(L, int(pool_mb * 1024 * 1024
                                     // max(slot_bytes, 1))))
        budget = 4 << 30
        if L * slot_bytes > budget:
            slots = max(2, int(budget // max(slot_bytes, 1)))
            Log.warning(
                "histogram memory for %d leaves would be %.1f GB; capping "
                "the histogram pool at %d slots (set histogram_pool_size "
                "to control this)", L, L * slot_bytes / 2**30, slots)
            return slots
        return 0

    def _check_supported(self) -> None:
        cfg, ds = self.config, self.train_set
        unsupported = [
            (str(cfg.boosting) != "gbdt", "boosting=%s" % cfg.boosting),
            (self.objective is None, "a custom objective"),
            (str(cfg.tree_learner) != "serial",
             "tree_learner=%s" % cfg.tree_learner),
            (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0, "bagging"),
            (bool(cfg.forcedsplits_filename), "forced splits"),
            (ds.bundle_info is not None, "an EFB-bundled dataset"),
            (any(m.bin_type == BIN_TYPE_CATEGORICAL for m in ds.bin_mappers),
             "categorical features"),
            (bool(np.any(ds.monotone_constraints)), "monotone constraints"),
            (ds.metadata.init_score is not None, "init_score"),
            (ds.num_data_padded + 1 >= _IDX_EXACT_LIMIT,
             "%d rows (the f32 row-index column is exact below 2^24)"
             % ds.num_data_padded),
            (str(cfg.sentinel_nonfinite) != "off",
             "sentinel_nonfinite=%s" % cfg.sentinel_nonfinite),
        ]
        if str(cfg.tpu_histogram_impl) not in ("auto", "pallas", "lax"):
            raise ValueError("tpu_histogram_impl must be one of "
                             "auto|pallas|lax, got %r"
                             % (cfg.tpu_histogram_impl,))
        for bad, what in unsupported:
            if bad:
                raise NotImplementedError(
                    "%s is not ported to the PyTorch package yet" % what)

    # -- validation (the JAX package's gbdt.py:1299-1319, 2076-2122) ----------
    def add_valid(self, name: str, valid: BinnedDataset, metrics: List) -> None:
        """Score `valid` (binned with the training mappers) after every
        tree: its bins go to the device, every existing tree is replayed
        onto its scores, and the metrics are initialised on its labels."""
        bins = valid.bins if valid.bins.dtype == np.uint8 \
            else valid.bins.astype(np.int32)
        bins_v = torch.as_tensor(bins, device=self.device)
        score_v = torch.zeros((1, valid.num_data_padded), dtype=torch.float32,
                              device=self.device)
        if valid.metadata.init_score is not None:
            score_v += torch.as_tensor(valid.padded(
                valid.metadata.init_score.astype(np.float32)),
                device=self.device)
        for tree in self.model.trees:
            self._add_tree_to_score(bins_v, score_v, tree)
        for m in metrics:
            m.init(valid.metadata.label, valid.metadata.weight,
                   valid.metadata.query_boundaries)
        self.valid_sets.append([name, valid, bins_v, score_v, metrics])

    def _add_tree_to_score(self, bins_v: torch.Tensor, score_v: torch.Tensor,
                           tree: Tree) -> None:
        if tree.num_leaves <= 1:
            score_v += np.float32(tree.leaf_value[0])
            return
        tree_dev, leaf_out = self._tree_to_device(tree)
        _traverse_add(bins_v, score_v, leaf_out, tree_dev, self.meta,
                      self._bmap, _depth_iters(tree))

    def _tree_to_device(self, tree: Tree):
        """Device arrays for the bin-level traversal of a host tree (the
        JAX package's _tree_to_device): bin thresholds and the inner
        categorical bitsets."""
        ni = max(tree.num_leaves - 1, 1)
        B = self.train_set.max_num_bin
        is_cat = (tree.decision_type[:ni] & 1) != 0
        bitset = np.zeros((ni, B), dtype=bool)
        for node in np.nonzero(is_cat)[0]:
            ci = int(tree.threshold_in_bin[node])
            lo = tree.cat_boundaries_inner[ci]
            hi = tree.cat_boundaries_inner[ci + 1]
            for wi in range(lo, hi):
                word = tree.cat_threshold_inner[wi]
                for bit in range(32):
                    b = (wi - lo) * 32 + bit
                    if b < B and (word >> bit) & 1:
                        bitset[node, b] = True

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        tree_dev = {
            "split_feature": t(tree.split_feature[:ni], torch.int64),
            "split_bin": t(np.where(is_cat, 0, tree.threshold_in_bin[:ni]),
                           torch.int32),
            "default_left": t((tree.decision_type[:ni] & 2) != 0, torch.bool),
            "split_is_cat": t(is_cat, torch.bool),
            "split_cat_bitset": t(bitset, torch.bool),
            "left_child": t(tree.left_child[:ni], torch.int64),
            "right_child": t(tree.right_child[:ni], torch.int64),
        }
        leaf_out = t(tree.leaf_value[:max(tree.num_leaves, 1)], torch.float32)
        return tree_dev, leaf_out

    # -- one boosting iteration (gbdt.cpp:387-482) ---------------------------
    def train_one_iter(self, grad=None, hess=None) -> bool:
        if grad is not None or hess is not None:
            raise NotImplementedError(
                "custom gradients are not ported to the PyTorch package yet")
        init_score = self._boost_from_average()
        if self._fast is None:
            self._fast = _FastState(self, self.score)
            self.grower = make_partitioned_grower(
                self.meta, self.grower_cfg, self.train_set.max_num_bin,
                self._fast.cols, self.train_set.num_features)
        fs = self._fast
        fmask = self._feature_sample()
        lr = self.shrinkage_rate

        # the fused step: gradients -> grow -> score add (stumps must not
        # move the scores; gbdt.cpp stops instead)
        if self._qmax:
            # one generator per (iteration, class), seeded on the JAX
            # schedule, so reruns on one device quantize identically
            gen = torch.Generator(device=self.device)
            gen.manual_seed(quant_seed(self.config.seed or 0, self.iter,
                                       self.num_tree_per_iteration, 0))
            qscale = fs.fill_gradients(self.objective, self._qmax, gen)
            out, fs.payload, fs.aux = self.grower(fs.payload, fs.aux, fmask,
                                                  qscale)
        else:
            fs.fill_gradients(self.objective)
            out, fs.payload, fs.aux = self.grower(fs.payload, fs.aux, fmask)
        if out["num_leaves"] > 1:
            seg.payload_col_write(fs.payload, fs.score0,
                                  fs.payload[:, fs.value_col] * lr, "add")
        host = _fetch_packed(out)
        self.host_syncs.append(out["host_syncs"] + 1)
        self.split_rounds_total += out["split_rounds"]
        self.trees_finished += 1
        tree = self._finish_tree_host(host, init_score, lr)
        self.model.trees.append(tree)
        for vs in self.valid_sets:
            self._add_tree_to_score(vs[2], vs[3], tree)
        self.iter += 1
        if tree.num_leaves <= 1:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def _boost_from_average(self) -> float:
        if self._boosted_from_average or self.model.current_iteration > 0 \
                or self.num_class > 1:
            return 0.0
        self._boosted_from_average = True
        if not bool(self.config.boost_from_average):
            return 0.0
        init = self.objective.boost_from_score()
        if abs(init) > K_EPSILON:
            self.score = self.score + np.float32(init)
            Log.info("Start training from score %f", init)
            return init
        return 0.0

    def _feature_sample(self) -> torch.Tensor:
        cfg = self.config
        f = self.train_set.num_features
        mask = np.zeros(f, dtype=bool)
        if cfg.feature_fraction < 1.0:
            used = max(1, int(f * cfg.feature_fraction))
            mask[self.feature_rng.sample(f, used)] = True
        else:
            mask[:] = True
        return torch.as_tensor(mask, device=self.device)

    def _finish_tree_host(self, host: Dict[str, np.ndarray],
                          init_score: float, lr: float) -> Tree:
        """Fetched grower outputs -> reference Tree (the JAX package's
        _finish_tree_host for numerical splits)."""
        nl = int(host["num_leaves"])
        L = self.grower_cfg.num_leaves
        tree = Tree(max(L, 2))
        tree.num_leaves = nl
        if nl > 1:
            ni = nl - 1
            ds = self.train_set
            tree.split_feature[:ni] = host["split_feature"][:ni]
            tree.split_gain[:ni] = host["split_gain"][:ni]
            dt = (host["default_left"][:ni].astype(np.int8) << 1)
            miss = np.asarray([ds.bin_mappers[int(f)].missing_type
                               for f in host["split_feature"][:ni]],
                              dtype=np.int8)
            dt |= (miss << 2)
            tree.decision_type[:ni] = dt
            for node in range(ni):
                f = int(host["split_feature"][node])
                b = int(host["split_bin"][node])
                tree.threshold_in_bin[node] = b
                tree.threshold[node] = ds.real_threshold(f, b)
            tree.left_child[:ni] = host["left_child"][:ni]
            tree.right_child[:ni] = host["right_child"][:ni]
            tree.internal_value[:ni] = host["internal_value"][:ni] * lr
            tree.internal_count[:ni] = host["internal_count"][:ni].astype(np.int64)
            tree.leaf_value[:nl] = host["leaf_value"][:nl].astype(np.float64) * lr
            tree.leaf_count[:nl] = host["leaf_count"][:nl].astype(np.int64)
            tree.leaf_parent[:] = -1
            for node in range(ni):
                for child in (tree.left_child[node], tree.right_child[node]):
                    if child < 0:
                        tree.leaf_parent[~child] = node
            tree.shrinkage = lr
            if abs(init_score) > K_EPSILON:
                tree.leaf_value[:nl] += init_score
                tree.shrinkage = 1.0
        else:
            tree.leaf_value[0] = float(host["leaf_value"][0]) * lr + init_score
            tree.shrinkage = 1.0
        return tree

    def split_rounds_per_tree(self) -> Optional[float]:
        """Mean sequential grower rounds per finished tree (< splits per
        tree once the frontier-batched grower commits several splits in
        one round)."""
        if self.trees_finished == 0:
            return None
        return self.split_rounds_total / self.trees_finished

    # -- evaluation ----------------------------------------------------------
    def raw_train_score(self) -> np.ndarray:
        if self._fast is None:
            raw = self.score.cpu().numpy()
        else:
            raw = self._fast.raw_scores()
        return raw[:, : self.train_set.num_data]

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        raw = self.raw_train_score()
        return [("training", m.name, m.eval(raw[0], self.objective),
                 m.is_higher_better) for m in self.train_metrics]

    def raw_valid_score(self, i: int) -> np.ndarray:
        """[1, num_data] scores of validation set i (host)."""
        _, valid, _, score_v, _ = self.valid_sets[i]
        return score_v[:, : valid.num_data].cpu().numpy()

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for i, (name, _, _, _, metrics) in enumerate(self.valid_sets):
            raw = self.raw_valid_score(i)
            out.extend((name, m.name, m.eval(raw[0], self.objective),
                        m.is_higher_better) for m in metrics)
        return out
