"""Regression objective family, output side (counterpart of
lightgbm_tpu/objective/regression.py).

Role parity with the reference src/objective/regression_objective.hpp:
RegressionL2loss (:64-170), RegressionL1loss (:175-256), RegressionHuberLoss
(:261-319), RegressionFairLoss (:323-365), RegressionPoissonLoss (:371-450),
RegressionQuantileloss (:452-545), RegressionMAPELOSS (:551-645),
RegressionGammaLoss (:652-684), RegressionTweedieLoss (:689-725).

This slice ports what loading and predicting a model need: each class's
parameters, its model-text name (`to_string`) and its output transform
(`convert_output`).  Gradients, BoostFromScore and leaf renewal come with
the slice that trains these objectives; until then gbdt refuses training
with them.
"""
from __future__ import annotations

import numpy as np

from ..utils.log import Log
from .base import ObjectiveFunction


class RegressionL2(ObjectiveFunction):
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def to_string(self) -> str:
        return "regression sqrt" if self.sqrt else "regression"


class RegressionL1(RegressionL2):
    name = "regression_l1"

    def to_string(self) -> str:
        return self.name


class RegressionHuber(RegressionL2):
    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(getattr(config, "alpha", 0.9))
        if self.sqrt:
            Log.warning("Cannot use sqrt transform in %s Regression, will "
                        "auto disable it", self.name)
            self.sqrt = False

    def to_string(self) -> str:
        return self.name


class RegressionFair(RegressionL2):
    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(getattr(config, "fair_c", 1.0))

    def to_string(self) -> str:
        return self.name


class RegressionPoisson(RegressionL2):
    """output = exp(f) (regression_objective.hpp:405-429)."""
    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(getattr(config, "poisson_max_delta_step",
                                            0.7))
        if self.sqrt:
            Log.warning("Cannot use sqrt transform in %s Regression, will "
                        "auto disable it", self.name)
            self.sqrt = False

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return np.exp(raw)

    def to_string(self) -> str:
        return self.name


class RegressionQuantile(RegressionL1):
    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(getattr(config, "alpha", 0.9))
        if not (0.0 < self.alpha < 1.0):
            Log.fatal("alpha should be in (0, 1) for quantile objective")


class RegressionMAPE(RegressionL1):
    name = "mape"


class RegressionGamma(RegressionPoisson):
    name = "gamma"


class RegressionTweedie(RegressionPoisson):
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(getattr(config, "tweedie_variance_power", 1.5))
