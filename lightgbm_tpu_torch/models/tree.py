"""Flat-array (SoA) decision tree model.

Role parity with the reference's include/LightGBM/tree.h:20-518 and
src/io/tree.cpp (Split/SplitCategorical, Predict*, ToString/ToJSON,
parse-from-string at tree.cpp:475).  Redesigned TPU-first: a tree is a bundle
of flat numpy/jnp arrays (structure-of-arrays) so prediction is a vectorized
gather traversal that jits cleanly, and training emits array slices rather
than mutating a pointer graph.

Node index conventions follow the reference text format exactly so model files
interchange: internal nodes are numbered 0..num_leaves-2; child pointers are
`>= 0` for internal children and `~leaf_index` (negative) for leaves.
decision_type bit layout (tree.h:14-15, 195-202): bit0 = categorical,
bit1 = default_left, bits 2-3 = missing type (0 none, 1 zero, 2 nan).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

_K_CATEGORICAL_MASK = 1
_K_DEFAULT_LEFT_MASK = 2

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

_K_ZERO_THRESHOLD = 1e-35  # reference meta.h kZeroThreshold


def _fmt_double(v: float) -> str:
    return repr(float(v))


def _join_arr(arr, fmt=str) -> str:
    return " ".join(fmt(x) for x in arr)


class Tree:
    """One decision tree with num_leaves leaves stored as flat arrays."""

    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        self.num_leaves = 1
        self.num_cat = 0
        n = max(max_leaves - 1, 1)
        self.left_child = np.zeros(n, dtype=np.int32)
        self.right_child = np.zeros(n, dtype=np.int32)
        self.split_feature = np.zeros(n, dtype=np.int32)
        self.threshold_in_bin = np.zeros(n, dtype=np.int32)
        self.threshold = np.zeros(n, dtype=np.float64)
        self.decision_type = np.zeros(n, dtype=np.int8)
        self.split_gain = np.zeros(n, dtype=np.float32)
        self.internal_value = np.zeros(n, dtype=np.float64)
        self.internal_count = np.zeros(n, dtype=np.int32)
        self.leaf_value = np.zeros(max_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(max_leaves, dtype=np.int32)
        self.leaf_parent = np.full(max_leaves, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(max_leaves, dtype=np.int32)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        # inner (bin-id) bitsets, training-side only — not serialized
        # (tree.h cat_boundaries_inner_/cat_threshold_inner_)
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []
        self.shrinkage = 1.0
        # training-side only, not serialized: the f32 shrunk leaf outputs
        # the engine added to its validation scores (its leaf_value_f32 *
        # f32(lr); empty for a stump, which adds nothing), so a validation
        # set added later replays the same bits; None where the engine
        # did not add them so (a loaded tree, RF) or they went stale
        self.valid_out: Optional[np.ndarray] = None

    # -- training-side mutation ---------------------------------------------
    def split(self, leaf: int, feature: int, threshold_bin: int,
              threshold_double: float, left_value: float, right_value: float,
              left_cnt: int, right_cnt: int, gain: float,
              missing_type: int, default_left: bool) -> int:
        """Split `leaf`; the left child keeps index `leaf`, the right child
        becomes leaf `num_leaves`.  Returns the new internal node index."""
        node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = node
            else:
                self.right_child[parent] = node
        self.split_feature[node] = feature
        self.threshold_in_bin[node] = threshold_bin
        self.threshold[node] = threshold_double
        dt = 0
        if default_left:
            dt |= _K_DEFAULT_LEFT_MASK
        dt |= (missing_type & 3) << 2
        self.decision_type[node] = dt
        self.split_gain[node] = gain
        self.left_child[node] = ~leaf
        new_leaf = self.num_leaves
        self.right_child[node] = ~new_leaf
        # reference stores the pre-split leaf output as the internal value (tree.h Split)
        self.internal_value[node] = self.leaf_value[leaf]
        self.internal_count[node] = left_cnt + right_cnt
        self.leaf_value[leaf] = left_value if left_value == left_value else 0.0
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[new_leaf] = right_value if right_value == right_value else 0.0
        self.leaf_count[new_leaf] = right_cnt
        self.leaf_parent[leaf] = node
        self.leaf_parent[new_leaf] = node
        self.leaf_depth[new_leaf] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        self.num_leaves += 1
        return node

    def split_categorical(self, leaf: int, feature: int, threshold_bin_bitset: List[int],
                          threshold_cat_bitset: List[int], left_value: float,
                          right_value: float, left_cnt: int, right_cnt: int,
                          gain: float, missing_type: int) -> int:
        node = self.split(leaf, feature, 0, 0.0, left_value, right_value,
                          left_cnt, right_cnt, gain, missing_type, False)
        self.decision_type[node] &= ~_K_DEFAULT_LEFT_MASK
        self.decision_type[node] |= _K_CATEGORICAL_MASK
        self.threshold_in_bin[node] = self.num_cat
        self.threshold[node] = self.num_cat
        self.num_cat += 1
        self.cat_threshold.extend(threshold_cat_bitset)
        self.cat_boundaries.append(len(self.cat_threshold))
        self.cat_threshold_inner.extend(threshold_bin_bitset)
        self.cat_boundaries_inner.append(len(self.cat_threshold_inner))
        return node

    def apply_shrinkage(self, rate: float) -> None:
        self.leaf_value[: self.num_leaves] *= rate
        self.internal_value[: self.num_leaves - 1] *= rate
        self.shrinkage *= rate
        self.valid_out = None

    # -- prediction ----------------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        """Vectorized traversal over raw feature values [n, num_features]."""
        return self._traverse(X, leaf_index=False)

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        return self._traverse(X, leaf_index=True)

    def _traverse(self, X: np.ndarray, leaf_index: bool) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            out = np.zeros(n) if leaf_index else np.full(n, self.leaf_value[0])
            return out
        node = np.zeros(n, dtype=np.int32)
        active = np.ones(n, dtype=bool)
        # num_leaves-1 is the max depth of any path
        for _ in range(self.num_leaves):
            if not active.any():
                break
            nd = node[active]
            fval = X[active, self.split_feature[nd]].astype(np.float64)
            dt = self.decision_type[nd]
            is_cat = (dt & _K_CATEGORICAL_MASK) != 0
            missing_type = (dt >> 2) & 3
            default_left = (dt & _K_DEFAULT_LEFT_MASK) != 0
            go_left = np.zeros(len(nd), dtype=bool)

            # numerical decision (tree.h:212-232)
            num_mask = ~is_cat
            if num_mask.any():
                fv = fval[num_mask]
                mt = missing_type[num_mask]
                nan_mask = np.isnan(fv)
                fv = np.where(nan_mask & (mt != MISSING_NAN), 0.0, fv)
                is_missing = ((mt == MISSING_ZERO) & (np.abs(fv) <= _K_ZERO_THRESHOLD)) | \
                             ((mt == MISSING_NAN) & nan_mask)
                left = np.where(is_missing, default_left[num_mask],
                                fv <= self.threshold[nd[num_mask]])
                go_left[num_mask] = left
            # categorical decision (tree.h:251-268)
            if is_cat.any():
                fv = fval[is_cat]
                mt = missing_type[is_cat]
                # NaN goes right when missing_type==NaN, else is treated as category 0
                int_val = np.where(np.isnan(fv),
                                   np.where(mt == MISSING_NAN, -1.0, 0.0), fv)
                cat_idx = self.threshold_in_bin[nd[is_cat]]
                inb = np.zeros(int(is_cat.sum()), dtype=bool)
                for j in range(len(inb)):
                    v = int_val[j]
                    if not np.isfinite(v) or v < 0:
                        continue
                    v = int(v)
                    ci = int(cat_idx[j])
                    lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
                    i1, i2 = v // 32, v % 32
                    if lo + i1 < hi and (self.cat_threshold[lo + i1] >> i2) & 1:
                        inb[j] = True
                go_left[is_cat] = inb

            child = np.where(go_left, self.left_child[nd], self.right_child[nd])
            node[active] = child
            reached_leaf = child < 0
            # store leaves as encoded negatives; deactivate
            idx = np.where(active)[0]
            active[idx[reached_leaf]] = False
        leaf = ~node  # node holds ~leaf_index for finished rows
        if leaf_index:
            return leaf.astype(np.float64)
        return self.leaf_value[leaf]

    def cat_words_for_node(self, node: int) -> np.ndarray:
        """The raw-category membership bitset of a categorical split node
        as uint32 words (word i covers categories 32*i .. 32*i+31) — the
        export format the device predictor packs into its fixed-width
        [T, nodes, W] word tensor."""
        if not (self.decision_type[node] & _K_CATEGORICAL_MASK):
            return np.zeros(0, np.uint32)
        ci = int(self.threshold_in_bin[node])
        lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
        return np.asarray(self.cat_threshold[lo:hi], np.uint32)

    def set_bin_thresholds(self, bin_mappers) -> None:
        """Map double thresholds back to bin thresholds against a training
        dataset's mappers so a loaded model can be replayed on binned data
        (continued training / validation replay).  Inverse of RealThreshold:
        the stored double threshold is the upper bound of its bin, so
        values_to_bins maps it exactly onto that bin."""
        ni = self.num_leaves - 1
        self.cat_boundaries_inner = [0]
        self.cat_threshold_inner = []
        for node in range(ni):
            f = int(self.split_feature[node])
            mapper = bin_mappers[f]
            dt = int(self.decision_type[node])
            if dt & _K_CATEGORICAL_MASK:
                ci = int(self.threshold[node])
                self.threshold_in_bin[node] = ci
                lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
                cats = [(i - lo) * 32 + j for i in range(lo, hi) for j in range(32)
                        if (self.cat_threshold[i] >> j) & 1]
                bins = sorted(mapper.categorical_2_bin[c] for c in cats
                              if c in mapper.categorical_2_bin)
                words = [0] * ((max(bins) // 32 + 1) if bins else 0)
                for b in bins:
                    words[b // 32] |= 1 << (b % 32)
                self.cat_threshold_inner.extend(words)
                self.cat_boundaries_inner.append(len(self.cat_threshold_inner))
            else:
                self.threshold_in_bin[node] = int(
                    mapper.values_to_bins(np.array([self.threshold[node]]))[0])

    # -- SHAP contributions (tree.cpp TreeSHAP:591-698, arXiv:1706.06060) ----
    def _decide_one(self, node: int, fval: float) -> int:
        """Single-value decision -> child node id (Tree::Decision)."""
        dt = int(self.decision_type[node])
        if dt & _K_CATEGORICAL_MASK:
            mt = (dt >> 2) & 3
            if np.isnan(fval):
                v = -1 if mt == MISSING_NAN else 0
            else:
                v = int(fval) if np.isfinite(fval) else -1
            go_left = False
            if v >= 0:
                ci = int(self.threshold_in_bin[node])
                lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
                i1, i2 = v // 32, v % 32
                go_left = lo + i1 < hi and bool((self.cat_threshold[lo + i1] >> i2) & 1)
        else:
            mt = (dt >> 2) & 3
            default_left = bool(dt & _K_DEFAULT_LEFT_MASK)
            if np.isnan(fval) and mt != MISSING_NAN:
                fval = 0.0
            if (mt == MISSING_ZERO and abs(fval) <= _K_ZERO_THRESHOLD) or \
                    (mt == MISSING_NAN and np.isnan(fval)):
                go_left = default_left
            else:
                go_left = fval <= self.threshold[node]
        return int(self.left_child[node] if go_left else self.right_child[node])

    def _data_count(self, node: int) -> float:
        if node < 0:
            return float(self.leaf_count[~node])
        return float(self.internal_count[node])

    def predict_contrib(self, X: np.ndarray, num_features: int) -> np.ndarray:
        """Per-feature SHAP contributions [n, num_features + 1]; the last
        column accumulates the expected value (Tree::PredictContrib,
        tree.h:466-475)."""
        n = X.shape[0]
        phi = np.zeros((n, num_features + 1))
        phi[:, num_features] += self.expected_value()
        if self.num_leaves > 1:
            for row in range(n):
                self._tree_shap(X[row], phi[row], 0, 0, [], 1.0, 1.0, -1)
        return phi

    def _tree_shap(self, x, phi, node, unique_depth, parent_path,
                   parent_zero_fraction, parent_one_fraction,
                   parent_feature_index) -> None:
        # each frame owns a copy of the path prefix (reference keeps one big
        # buffer with std::copy per level)
        path = [list(el) for el in parent_path[:unique_depth]]
        path.append([parent_feature_index, parent_zero_fraction,
                     parent_one_fraction, 1.0 if unique_depth == 0 else 0.0])
        for i in range(unique_depth - 1, -1, -1):
            path[i + 1][3] += parent_one_fraction * path[i][3] * (i + 1) / (unique_depth + 1.0)
            path[i][3] = parent_zero_fraction * path[i][3] * (unique_depth - i) / (unique_depth + 1.0)

        if node < 0:
            for i in range(1, unique_depth + 1):
                w = _unwound_path_sum(path, unique_depth, i)
                fi, one_f, zero_f = path[i][0], path[i][2], path[i][1]
                phi[fi] += w * (one_f - zero_f) * self.leaf_value[~node]
            return

        f = int(self.split_feature[node])
        hot_index = self._decide_one(node, float(x[f]))
        cold_index = int(self.right_child[node]) if hot_index == int(self.left_child[node]) \
            else int(self.left_child[node])
        w = self._data_count(node)
        hot_zero_fraction = self._data_count(hot_index) / w
        cold_zero_fraction = self._data_count(cold_index) / w
        incoming_zero_fraction = 1.0
        incoming_one_fraction = 1.0

        path_index = 0
        while path_index <= unique_depth:
            if path[path_index][0] == f:
                break
            path_index += 1
        if path_index != unique_depth + 1:
            incoming_zero_fraction = path[path_index][1]
            incoming_one_fraction = path[path_index][2]
            _unwind_path(path, unique_depth, path_index)
            unique_depth -= 1

        self._tree_shap(x, phi, hot_index, unique_depth + 1, path,
                        hot_zero_fraction * incoming_zero_fraction,
                        incoming_one_fraction, f)
        self._tree_shap(x, phi, cold_index, unique_depth + 1, path,
                        cold_zero_fraction * incoming_zero_fraction, 0.0, f)

    def expected_value(self) -> float:
        if self.num_leaves == 1:
            return float(self.leaf_value[0])
        total = float(self.internal_count[0])
        return float(np.sum(self.leaf_value[:self.num_leaves] *
                            self.leaf_count[:self.num_leaves]) / max(total, 1.0))

    # -- serialization (reference text format, tree.cpp:209-244) -------------
    def to_string(self) -> str:
        nl = self.num_leaves
        lines = ["num_leaves=%d" % nl, "num_cat=%d" % self.num_cat]
        if nl > 1:
            ni = nl - 1
            lines.append("split_feature=" + _join_arr(self.split_feature[:ni]))
            lines.append("split_gain=" + _join_arr(self.split_gain[:ni], lambda v: _fmt_float32(v)))
            lines.append("threshold=" + _join_arr(self.threshold[:ni], _fmt_double))
            lines.append("decision_type=" + _join_arr(self.decision_type[:ni]))
            lines.append("left_child=" + _join_arr(self.left_child[:ni]))
            lines.append("right_child=" + _join_arr(self.right_child[:ni]))
            lines.append("leaf_value=" + _join_arr(self.leaf_value[:nl], _fmt_double))
            lines.append("leaf_count=" + _join_arr(self.leaf_count[:nl]))
            lines.append("internal_value=" + _join_arr(self.internal_value[:ni], _fmt_double))
            lines.append("internal_count=" + _join_arr(self.internal_count[:ni]))
            if self.num_cat > 0:
                lines.append("cat_boundaries=" + _join_arr(self.cat_boundaries))
                lines.append("cat_threshold=" + _join_arr(self.cat_threshold))
        else:
            lines.append("leaf_value=" + _fmt_double(self.leaf_value[0]))
        lines.append("shrinkage=%s" % _fmt_double(self.shrinkage))
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.split("\n"):
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        num_leaves = int(kv["num_leaves"])
        tree = cls(max(num_leaves, 2))
        tree.num_leaves = num_leaves
        tree.num_cat = int(kv.get("num_cat", "0"))
        tree.shrinkage = float(kv.get("shrinkage", "1"))
        if num_leaves <= 1:
            if "leaf_value" in kv:
                tree.leaf_value[0] = float(kv["leaf_value"].split()[0])
            return tree

        def arr(key, dtype, n):
            if key not in kv or kv[key] == "":
                return np.zeros(n, dtype=dtype)
            vals = np.array(kv[key].split(), dtype=np.float64)
            return vals.astype(dtype)

        ni = num_leaves - 1
        tree.split_feature[:ni] = arr("split_feature", np.int32, ni)
        tree.split_gain[:ni] = arr("split_gain", np.float32, ni)
        tree.threshold[:ni] = arr("threshold", np.float64, ni)
        tree.decision_type[:ni] = arr("decision_type", np.int8, ni)
        tree.threshold_in_bin[:ni] = tree.threshold[:ni].astype(np.int32)
        tree.left_child[:ni] = arr("left_child", np.int32, ni)
        tree.right_child[:ni] = arr("right_child", np.int32, ni)
        tree.leaf_value[:num_leaves] = arr("leaf_value", np.float64, num_leaves)
        tree.leaf_count[:num_leaves] = arr("leaf_count", np.int32, num_leaves)
        tree.internal_value[:ni] = arr("internal_value", np.float64, ni)
        tree.internal_count[:ni] = arr("internal_count", np.int32, ni)
        if tree.num_cat > 0:
            tree.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            tree.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
        # recompute leaf parents/depths from child pointers
        tree.leaf_parent[:] = -1
        for node in range(ni):
            for child in (tree.left_child[node], tree.right_child[node]):
                if child < 0:
                    tree.leaf_parent[~child] = node
        return tree

    def to_json(self) -> Dict:
        if self.num_leaves == 1:
            structure = {"leaf_value": float(self.leaf_value[0])}
        else:
            structure = self._node_to_json(0)
        return {"num_leaves": int(self.num_leaves), "num_cat": int(self.num_cat),
                "shrinkage": float(self.shrinkage), "tree_structure": structure}

    def _node_to_json(self, index: int) -> Dict:
        if index >= 0:
            dt = int(self.decision_type[index])
            is_cat = bool(dt & _K_CATEGORICAL_MASK)
            node = {
                "split_index": int(index),
                "split_feature": int(self.split_feature[index]),
                "split_gain": float(self.split_gain[index]),
                "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
                "default_left": bool(dt & _K_DEFAULT_LEFT_MASK),
                "internal_value": float(self.internal_value[index]),
                "internal_count": int(self.internal_count[index]),
                "left_child": self._node_to_json(int(self.left_child[index])),
                "right_child": self._node_to_json(int(self.right_child[index])),
            }
            if is_cat:
                ci = int(self.threshold_in_bin[index])
                lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
                cats = []
                for i in range(lo, hi):
                    for j in range(32):
                        if (self.cat_threshold[i] >> j) & 1:
                            cats.append((i - lo) * 32 + j)
                node["decision_type"] = "=="
                node["threshold"] = "||".join(str(c) for c in cats)
            else:
                node["decision_type"] = "<="
                node["threshold"] = float(self.threshold[index])
            return node
        leaf = ~index
        return {"leaf_index": int(leaf), "leaf_value": float(self.leaf_value[leaf]),
                "leaf_count": int(self.leaf_count[leaf])}


def _fmt_float32(v) -> str:
    return repr(round(float(v), 6)) if v == v else "nan"


def _unwind_path(path, unique_depth, path_index) -> None:
    """Tree::UnwindPath (tree.cpp:605-628)."""
    one_fraction = path[path_index][2]
    zero_fraction = path[path_index][1]
    next_one_portion = path[unique_depth][3]
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i][3]
            path[i][3] = next_one_portion * (unique_depth + 1.0) / ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i][3] * zero_fraction * (unique_depth - i) / (unique_depth + 1.0)
        else:
            path[i][3] = path[i][3] * (unique_depth + 1.0) / (zero_fraction * (unique_depth - i))
    for i in range(path_index, unique_depth):
        path[i][0] = path[i + 1][0]
        path[i][1] = path[i + 1][1]
        path[i][2] = path[i + 1][2]


def _unwound_path_sum(path, unique_depth, path_index) -> float:
    """Tree::UnwoundPathSum (tree.cpp:630-649)."""
    one_fraction = path[path_index][2]
    zero_fraction = path[path_index][1]
    next_one_portion = path[unique_depth][3]
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (unique_depth + 1.0) / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i][3] - tmp * zero_fraction * \
                ((unique_depth - i) / (unique_depth + 1.0))
        else:
            total += (path[i][3] / zero_fraction) / \
                ((unique_depth - i) / (unique_depth + 1.0))
    return total
