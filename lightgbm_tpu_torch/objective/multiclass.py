"""Multiclass objectives (counterpart of lightgbm_tpu/objective/multiclass.py):
softmax (K trees per iteration) and one-vs-all.

Role parity with the reference src/objective/multiclass_objective.hpp
(MulticlassSoftmax :16-137, MulticlassOVA :139-225).  The K per-class
gradient planes are one [K, N] computation on the training device, in the
JAX package's order of operations; the trainer takes class k's plane for
class k's tree.  Neither boosts from an average (gbdt skips it for K > 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction


def _onehot(label: torch.Tensor, num_class: int) -> torch.Tensor:
    """[K, N] bool: row n of class label[n]."""
    classes = torch.arange(num_class, dtype=torch.int32, device=label.device)
    return label[None, :].to(torch.int32) == classes[:, None]


def _check_class_label(label: np.ndarray, num_class: int, name: str) -> None:
    li = label.astype(np.int64)
    if np.any(li < 0) or np.any(li >= num_class) or np.any(li != label):
        Log.fatal("Label must be in [0, %d) for %s objective", num_class,
                  name)


class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(getattr(config, "num_class", 1))
        if self.num_class <= 1:
            Log.fatal("num_class must be > 1 for multiclass objective")

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def check_label(self) -> None:
        _check_class_label(self.label, self.num_class, "multiclass")

    def get_gradients_multi(self, score, label, weight):
        """score [K, N] -> (grad [K, N], hess [K, N]): p - onehot and
        2 p (1 - p) like the reference (multiclass_objective.hpp:73), each
        times the row weight; p is the softmax over the class axis
        (jax.nn.softmax's exp(s - max) / sum)."""
        e = torch.exp(score - score.amax(dim=0, keepdim=True))
        p = e / e.sum(dim=0, keepdim=True)
        onehot = _onehot(label, self.num_class).to(p.dtype)
        grad = ((p - onehot) * weight[None, :]).to(torch.float32)
        hess = (2.0 * p * (1.0 - p) * weight[None, :]).to(torch.float32)
        return grad, hess

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Row-wise softmax; raw is [N, K] (or [K] for one row)."""
        raw = np.asarray(raw, dtype=np.float64)
        m = raw - np.max(raw, axis=-1, keepdims=True)
        e = np.exp(m)
        return e / np.sum(e, axis=-1, keepdims=True)

    def to_string(self) -> str:
        return "multiclass num_class:%d" % self.num_class


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: K independent sigmoid binary objectives
    (multiclass_objective.hpp:139-225; per-class BinaryLogloss with an
    indicator label)."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(getattr(config, "num_class", 1))
        self.sigmoid = float(getattr(config, "sigmoid", 1.0))
        self.is_unbalance = bool(getattr(config, "is_unbalance", False))
        self.scale_pos_weight = float(getattr(config, "scale_pos_weight",
                                              1.0))
        if self.num_class <= 1:
            Log.fatal("num_class must be > 1 for multiclassova objective")
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)
        # per-class (neg_weight, pos_weight), filled by check_label
        self.label_weights = np.ones((self.num_class, 2), dtype=np.float64)

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def check_label(self) -> None:
        _check_class_label(self.label, self.num_class, "multiclassova")
        # per-class pos/neg weighting, as the reference gets by composing
        # one BinaryLogloss per class with an indicator label
        # (multiclass_objective.hpp:145, binary_objective.hpp CheckLabel)
        li = self.label.astype(np.int64)
        self.label_weights = np.ones((self.num_class, 2), dtype=np.float64)
        for k in range(self.num_class):
            cnt_pos = float(np.sum(li == k))
            cnt_neg = float(len(li) - cnt_pos)
            if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
                if cnt_pos > cnt_neg:
                    self.label_weights[k] = (cnt_pos / cnt_neg, 1.0)
                else:
                    self.label_weights[k] = (1.0, cnt_neg / cnt_pos)
            elif self.scale_pos_weight != 1.0:
                self.label_weights[k] = (1.0, self.scale_pos_weight)

    def get_gradients_multi(self, score, label, weight):
        """Binary-logloss math per class plane with y_k in {-1, +1}
        (binary_objective.hpp GetGradients with indicator labels); the
        [K, 2] f32 label weights go to the device once."""
        onehot = _onehot(label, self.num_class)
        lw = self.device_table("label_weights", self.label_weights,
                               score.device)
        w = weight[None, :] * torch.where(onehot, lw[:, 1:2], lw[:, 0:1])
        one = torch.ones((), dtype=torch.float32, device=score.device)
        y = torch.where(onehot, one, -one)
        response = -y * self.sigmoid / (1.0 + torch.exp(y * self.sigmoid
                                                        * score))
        abs_r = torch.abs(response)
        grad = (response * w).to(torch.float32)
        hess = (abs_r * (self.sigmoid - abs_r) * w).to(torch.float32)
        return grad, hess

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.sigmoid
                                   * np.asarray(raw, dtype=np.float64)))

    def to_string(self) -> str:
        return "multiclassova num_class:%d sigmoid:%g" % (self.num_class,
                                                          self.sigmoid)
