"""LambdaRank (NDCG) objective, output side (counterpart of
lightgbm_tpu/objective/rank.py).

Role parity with the reference src/objective/rank_objective.hpp
(LambdarankNDCG).  Its raw score is the model's output; this slice ports
the parameters and the model-text name.  The query-grouped gradients
come with the slice that trains ranking (gbdt refuses it).
"""
from __future__ import annotations

import numpy as np

from ..utils.log import Log
from .base import ObjectiveFunction

# reference dcg_calculator.cpp:30-38: label_gain[i] = 2^i - 1, 31 levels
_MAX_LABEL = 31


def default_label_gain() -> np.ndarray:
    return np.array([(1 << i) - 1 for i in range(_MAX_LABEL)],
                    dtype=np.float64)


class LambdarankNDCG(ObjectiveFunction):
    is_rowwise = False  # pairwise within query groups
    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(getattr(config, "sigmoid", 1.0))
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero",
                      self.sigmoid)
        gains = list(getattr(config, "label_gain", ()) or ())
        self.label_gain = np.asarray(gains, np.float64) if gains \
            else default_label_gain()
        self.optimize_pos_at = int(getattr(config, "max_position", 20))
