"""Cross-entropy objectives for labels in [0, 1], output side (counterpart
of lightgbm_tpu/objective/xentropy.py).

Role parity with the reference src/objective/xentropy_objective.hpp:
CrossEntropy ("xentropy", :38-135), whose output is sigmoid(f), and
CrossEntropyLambda ("xentlambda", :140-268), whose output is the positive
intensity log1p(exp(f)), not a probability.  Gradients come with the
slice that trains them (gbdt refuses it).
"""
from __future__ import annotations

import numpy as np

from .base import ObjectiveFunction


class CrossEntropy(ObjectiveFunction):
    name = "xentropy"

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-raw))


class CrossEntropyLambda(ObjectiveFunction):
    name = "xentlambda"

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return np.log1p(np.exp(raw))
