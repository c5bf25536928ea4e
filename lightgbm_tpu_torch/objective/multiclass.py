"""Multiclass objectives, output side (counterpart of
lightgbm_tpu/objective/multiclass.py): softmax (K trees per iteration) and
one-vs-all.

Role parity with the reference src/objective/multiclass_objective.hpp
(MulticlassSoftmax :16-137, MulticlassOVA :139-225).  This slice ports
the parameters, model-text name and output transform; the [K, N]
gradients come with the slice that trains K > 1 (gbdt refuses it).
"""
from __future__ import annotations

import numpy as np

from ..utils.log import Log
from .base import ObjectiveFunction


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

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Row-wise softmax; raw is [N, K] (or [K] for one row)."""
        raw = np.asarray(raw, dtype=np.float64)
        m = raw - np.max(raw, axis=-1, keepdims=True)
        e = np.exp(m)
        return e / np.sum(e, axis=-1, keepdims=True)

    def to_string(self) -> str:
        return "multiclass num_class:%d" % self.num_class


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: K independent sigmoid outputs."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(getattr(config, "num_class", 1))
        self.sigmoid = float(getattr(config, "sigmoid", 1.0))
        if self.num_class <= 1:
            Log.fatal("num_class must be > 1 for multiclassova objective")
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.sigmoid
                                   * np.asarray(raw, dtype=np.float64)))

    def to_string(self) -> str:
        return "multiclassova num_class:%d sigmoid:%g" % (self.num_class,
                                                          self.sigmoid)
