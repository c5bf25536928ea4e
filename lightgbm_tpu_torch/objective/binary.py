"""Binary log-loss objective (counterpart of lightgbm_tpu/objective/binary.py).

Role parity with the reference src/objective/binary_objective.hpp (sigmoid
parameter, label weighting via is_unbalance / scale_pos_weight, BoostFromScore
at :119-140).  Gradient math in f32 on the training device, in the JAX
package's order of operations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(getattr(config, "sigmoid", 1.0))
        self.is_unbalance = bool(getattr(config, "is_unbalance", False))
        self.scale_pos_weight = float(getattr(config, "scale_pos_weight", 1.0))
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero", self.sigmoid)
        self.label_weights = (1.0, 1.0)

    def check_label(self) -> None:
        unique = np.unique(self.label)
        if not np.all(np.isin(unique, (0.0, 1.0))):
            Log.fatal("Binary objective requires labels in {0, 1}")
        cnt_pos = float(np.sum(self.label == 1))
        cnt_neg = float(np.sum(self.label == 0))
        if cnt_neg == 0 or cnt_pos == 0:
            Log.warning("Contains only one class")
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weights = (1.0, cnt_pos / cnt_neg)
            else:
                self.label_weights = (cnt_neg / cnt_pos, 1.0)
        elif self.scale_pos_weight != 1.0:
            self.label_weights = (1.0, self.scale_pos_weight)

    def get_gradients(self, score, label, weight):
        # y in {-1, +1}; response = -y*sig / (1 + exp(y*sig*score))
        pos = label > 0
        one = torch.ones((), dtype=torch.float32, device=score.device)
        y = torch.where(pos, one, -one)
        w_label = torch.where(pos, one * self.label_weights[1],
                              one * self.label_weights[0])
        w = weight * w_label
        response = -y * self.sigmoid / (1.0 + torch.exp(y * self.sigmoid * score))
        abs_r = torch.abs(response)
        grad = (response * w).to(torch.float32)
        hess = (abs_r * (self.sigmoid - abs_r) * w).to(torch.float32)
        return grad, hess

    def boost_from_score(self) -> float:
        if self.weight is not None:
            suml = float(np.sum(self.label * self.weight))
            sumw = float(np.sum(self.weight))
        else:
            suml = float(np.sum(self.label))
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, 1e-300), 1e-15), 1.0 - 1e-15)
        init = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        Log.info("[%s:BoostFromScore]: pavg=%.6f -> initscore=%.6f", self.name, pavg, init)
        return init

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def to_string(self) -> str:
        return "binary sigmoid:%g" % self.sigmoid
