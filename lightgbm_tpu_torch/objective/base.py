"""Objective function interface (counterpart of lightgbm_tpu/objective/base.py).

Role parity with the reference include/LightGBM/objective_function.h.
Gradients/hessians are computed on the training device by plain PyTorch
functions of the raw score; host-side helpers provide init-score
boosting and output transforms.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ObjectiveFunction:
    name = "custom"
    is_constant_hessian = False
    # gradients depend only on each row's own (score, label, weight) — lets
    # the trainer compute them in any row order (partitioned fast path)
    is_rowwise = True

    def __init__(self, config):
        self.config = config
        self.num_class = getattr(config, "num_class", 1)
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.num_data = 0

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None) -> None:
        self.label = np.asarray(label, dtype=np.float64)
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float64)
        self.num_data = len(self.label)
        self.check_label()

    def check_label(self) -> None:
        pass

    def get_gradients(self, score, label, weight):
        """(grad, hess) from raw scores: [N] f32 tensors on the training
        device; weight is all-ones when unweighted."""
        raise NotImplementedError

    def get_gradients_multi(self, score, label, weight):
        """The [K, N] score-matrix form.  Single-model objectives wrap
        get_gradients on the one score plane."""
        grad, hess = self.get_gradients(score[0], label, weight)
        return grad[None, :], hess[None, :]

    def boost_from_score(self) -> float:
        """Initial raw score (BoostFromScore in the reference objectives)."""
        return 0.0

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def renew_tree_output_required(self) -> bool:
        """IsRenewTreeOutput (objective_function.h)."""
        return False

    def to_string(self) -> str:
        return self.name
