"""Model container: an ordered list of trees + metadata, text-format compatible.

Role parity with the reference's src/boosting/gbdt_model_text.cpp
(SaveModelToString at :240-326, LoadModelFromString, DumpModel JSON at :15-54)
so model files interchange with the reference: a model trained here loads in
the reference CLI and vice versa.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.log import Log
from .tree import Tree

_MODEL_VERSION = "v2"


class GBDTModel:
    """Trees + the header metadata the reference stores in its model file."""

    def __init__(self):
        self.trees: List[Tree] = []
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.label_index = 0
        self.max_feature_idx = 0
        self.objective_str: str = "regression"
        self.average_output = False
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.loaded_parameters: str = ""
        self.sub_model_name = "tree"

    # -- iteration bookkeeping ----------------------------------------------
    @property
    def num_total_trees(self) -> int:
        return len(self.trees)

    @property
    def current_iteration(self) -> int:
        return len(self.trees) // self.num_tree_per_iteration

    # -- prediction ----------------------------------------------------------
    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1, early_stop: Optional[str] = None,
                    early_stop_freq: int = 10,
                    early_stop_margin: float = 10.0) -> np.ndarray:
        """Raw margin scores [n, num_tree_per_iteration] by summing trees.

        early_stop: None/'none', 'binary' (stop a row once 2*|margin| exceeds
        early_stop_margin) or 'multiclass' (top1-top2 gap) — vectorized form
        of src/boosting/prediction_early_stop.cpp, checked every
        early_stop_freq iterations per row."""
        n = X.shape[0]
        k = self.num_tree_per_iteration
        out = np.zeros((n, k), dtype=np.float64)
        end = self._resolve_end_iteration(start_iteration, num_iteration)
        use_early = early_stop in ("binary", "multiclass")
        if use_early and early_stop == "multiclass" and k < 2:
            Log.fatal("Multiclass early stopping needs predictions of length >= 2")
        if use_early and early_stop == "binary" and k != 1:
            Log.fatal("Binary early stopping needs predictions of length one")
        active = np.ones(n, dtype=bool)
        all_active = True  # avoid per-iteration fancy-index copies until a row stops
        rounds_since_check = 0
        for it in range(start_iteration, end):
            if use_early and not all_active:
                rows = X[active]
                if rows.shape[0] == 0:
                    break
            else:
                rows = X
            for j in range(k):
                pred = self.trees[it * k + j].predict(rows)
                if use_early and not all_active:
                    out[active, j] += pred
                else:
                    out[:, j] += pred
            if use_early:
                rounds_since_check += 1
                if rounds_since_check == early_stop_freq:
                    rounds_since_check = 0
                    if early_stop == "binary":
                        margin = 2.0 * np.abs(out[:, 0])
                    else:
                        part = np.partition(out, k - 2, axis=1)
                        margin = part[:, k - 1] - part[:, k - 2]
                    active &= ~(margin > early_stop_margin)
                    all_active = bool(active.all())
        return out

    def early_stop_mode(self, requested: bool) -> Optional[str]:
        """None / 'binary' / 'multiclass' — the reference gates prediction
        early stop on NeedAccuratePrediction: only binary / multiclass /
        ranking objectives tolerate truncated sums (predictor.hpp:46-52,
        objective NeedAccuratePrediction overrides).  Shared by the host
        and device predict paths so both truncate identically."""
        if not requested or self.average_output:
            return None
        obj_kind = str(self.objective_str).split()[0] \
            if self.objective_str else ""
        if obj_kind not in ("binary", "multiclass", "multiclassova",
                            "lambdarank"):
            return None
        return "multiclass" if self.num_tree_per_iteration > 1 else "binary"

    def num_prediction_iterations(self, start_iteration: int = 0,
                                  num_iteration: int = -1) -> int:
        return max(self._resolve_end_iteration(start_iteration, num_iteration)
                   - start_iteration, 1)

    def _resolve_end_iteration(self, start_iteration: int, num_iteration) -> int:
        """'<= 0 means all' + clamp rule shared by every prediction entry."""
        total_iter = self.current_iteration
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iter
        return min(start_iteration + num_iteration, total_iter)

    def predict_contrib(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """SHAP feature contributions summed over trees: [n, F+1] for one
        model per iteration, [n, K*(F+1)] for multiclass (c_api predict
        CONTRIB layout)."""
        n = X.shape[0]
        F = self.max_feature_idx + 1
        k = self.num_tree_per_iteration
        end = self._resolve_end_iteration(0, num_iteration)
        out = np.zeros((n, k, F + 1))
        for it in range(end):
            for j in range(k):
                out[:, j, :] += self.trees[it * k + j].predict_contrib(X, F)
        return out[:, 0, :] if k == 1 else out.reshape(n, k * (F + 1))

    def predict_leaf_index(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        end = self._resolve_end_iteration(0, num_iteration) * self.num_tree_per_iteration
        outs = [self.trees[i].predict_leaf_index(X) for i in range(end)]
        return np.stack(outs, axis=1) if outs else np.zeros((X.shape[0], 0))

    # -- serialization -------------------------------------------------------
    def save_model_to_string(self, start_iteration: int = 0, num_iteration: int = -1,
                             feature_importance_type: str = "split",
                             parameters: str = "") -> str:
        lines = [self.sub_model_name, "version=%s" % _MODEL_VERSION,
                 "num_class=%d" % self.num_class,
                 "num_tree_per_iteration=%d" % self.num_tree_per_iteration,
                 "label_index=%d" % self.label_index,
                 "max_feature_idx=%d" % self.max_feature_idx,
                 "objective=%s" % self.objective_str]
        if self.average_output:
            lines.append("average_output")
        fnames = self.feature_names
        if len(fnames) <= self.max_feature_idx:
            fnames = ["Column_%d" % i for i in range(self.max_feature_idx + 1)]
        lines.append("feature_names=" + " ".join(fnames))
        lines.append("feature_infos=" + " ".join(self.feature_infos))

        total_iter = self.current_iteration
        start_iteration = max(0, min(start_iteration, total_iter))
        if num_iteration is None or num_iteration <= 0:
            end_model = self.num_total_trees
        else:
            end_model = min((start_iteration + num_iteration) * self.num_tree_per_iteration,
                            self.num_total_trees)
        start_model = start_iteration * self.num_tree_per_iteration

        tree_strs = []
        for i in range(start_model, end_model):
            s = "Tree=%d\n" % (i - start_model) + self.trees[i].to_string() + "\n"
            tree_strs.append(s)
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs) + "end of trees\n"

        imp = self.feature_importance(num_iteration, feature_importance_type)
        pairs = sorted([(int(v), fnames[i]) for i, v in enumerate(imp) if v > 0],
                       key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        body += "".join("%s=%d\n" % (nm, v) for v, nm in pairs)
        if parameters:
            body += "\nparameters:\n" + parameters + "\nend of parameters\n"
        return body

    def save_model(self, filename: str, start_iteration: int = 0,
                   num_iteration: int = -1, parameters: str = "") -> None:
        with open(filename, "w") as f:
            f.write(self.save_model_to_string(start_iteration, num_iteration,
                                              parameters=parameters))

    @classmethod
    def load_model_from_string(cls, text: str) -> "GBDTModel":
        model = cls()
        header, _, rest = text.partition("Tree=0")
        kv: Dict[str, str] = {}
        for line in header.split("\n"):
            line = line.strip()
            if line == "average_output":
                model.average_output = True
            elif "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        model.num_class = int(kv.get("num_class", "1"))
        model.num_tree_per_iteration = int(kv.get("num_tree_per_iteration", str(model.num_class)))
        model.label_index = int(kv.get("label_index", "0"))
        model.max_feature_idx = int(kv.get("max_feature_idx", "0"))
        model.objective_str = kv.get("objective", "regression")
        model.feature_names = kv.get("feature_names", "").split()
        model.feature_infos = kv.get("feature_infos", "").split()
        if not rest:
            return model
        tree_part, _, tail = ("Tree=0" + rest).partition("end of trees")
        blocks = re.split(r"Tree=\d+\n", tree_part)
        for block in blocks:
            if "num_leaves" in block:
                model.trees.append(Tree.from_string(block))
        m = re.search(r"parameters:\n(.*?)\nend of parameters", tail, re.S)
        if m:
            model.loaded_parameters = m.group(1)
        return model

    @classmethod
    def load_model(cls, filename: str) -> "GBDTModel":
        with open(filename) as f:
            return cls.load_model_from_string(f.read())

    def dump_model(self, num_iteration: int = -1) -> Dict:
        total_iter = self.current_iteration
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iter
        end = min(num_iteration, total_iter) * self.num_tree_per_iteration
        return {
            "name": self.sub_model_name,
            "version": _MODEL_VERSION,
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_index,
            "max_feature_idx": self.max_feature_idx,
            "objective": self.objective_str,
            "average_output": self.average_output,
            "feature_names": list(self.feature_names),
            "tree_info": [t.to_json() for t in self.trees[:end]],
        }

    # -- importance (gbdt.cpp FeatureImportance) ----------------------------
    def feature_importance(self, num_iteration: int = -1,
                           importance_type: str = "split") -> np.ndarray:
        num_feat = self.max_feature_idx + 1
        imp = np.zeros(num_feat, dtype=np.float64)
        total_iter = self.current_iteration
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iter
        end = min(num_iteration, total_iter) * self.num_tree_per_iteration
        for tree in self.trees[:end]:
            ni = tree.num_leaves - 1
            for node in range(ni):
                f = tree.split_feature[node]
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += max(tree.split_gain[node], 0.0)
        return imp
