"""Regression objective family (counterpart of
lightgbm_tpu/objective/regression.py).

Role parity with the reference src/objective/regression_objective.hpp:
RegressionL2loss (:64-170), RegressionL1loss (:175-256), RegressionHuberLoss
(:261-319), RegressionFairLoss (:323-365), RegressionPoissonLoss (:371-450),
RegressionQuantileloss (:452-545), RegressionMAPELOSS (:551-645),
RegressionGammaLoss (:652-684), RegressionTweedieLoss (:689-725).

Gradient/hessian math runs on the training device (f32 torch, in the JAX
package's order of operations); BoostFromScore and the percentile-based
leaf renewal (IsRenewTreeOutput objectives: L1, quantile, MAPE) run on the
host in numpy over the leaf partition fetched once per tree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction


def percentile(data: np.ndarray, alpha: float) -> float:
    """PercentileFun (regression_objective.hpp:11-36): descending-rank
    percentile with linear interpolation; pos<1 -> max, pos>=cnt -> min."""
    cnt = len(data)
    if cnt == 0:
        return 0.0
    a = np.sort(np.asarray(data, dtype=np.float64))
    float_pos = (1.0 - alpha) * cnt
    pos = int(float_pos)
    if pos < 1:
        return float(a[-1])
    if pos >= cnt:
        return float(a[0])
    bias = float_pos - pos
    v1 = a[cnt - pos]       # pos-1 -th largest
    v2 = a[cnt - 1 - pos]   # pos   -th largest
    return float(v1 - (v1 - v2) * bias)


def weighted_percentile(data: np.ndarray, weights: np.ndarray,
                        alpha: float) -> float:
    """WeightedPercentileFun (regression_objective.hpp:38-59): weighted CDF
    inversion, interpolating over the in-bounds [cdf[pos-1], cdf[pos]]
    step (the reference reads past the CDF end on its final step)."""
    cnt = len(data)
    if cnt == 0:
        return 0.0
    data = np.asarray(data, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    order = np.argsort(data, kind="stable")
    d = data[order]
    cdf = np.cumsum(weights[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    if pos == 0:
        return float(d[0])
    if pos >= cnt:
        return float(d[-1])
    v1, v2 = d[pos - 1], d[pos]
    denom = cdf[pos] - cdf[pos - 1]
    if denom <= 0:
        return float(v1)
    return float(v1 + (threshold - cdf[pos - 1]) / denom * (v2 - v1))


class RegressionL2(ObjectiveFunction):
    name = "regression"
    is_constant_hessian = True  # when unweighted

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        if self.sqrt:
            self.label = np.sign(self.label) * np.sqrt(np.abs(self.label))
        self.is_constant_hessian = weight is None

    def _trans_label(self, label):
        """The device's label transform, as init's on the host (sqrt)."""
        if self.sqrt:
            return torch.sign(label) * torch.sqrt(torch.abs(label))
        return label

    def get_gradients(self, score, label, weight):
        label = self._trans_label(label)
        grad = ((score - label) * weight).to(torch.float32)
        hess = weight.to(torch.float32)
        return grad, hess

    def boost_from_score(self) -> float:
        if self.weight is not None:
            return float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        return float(np.mean(self.label))

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def to_string(self) -> str:
        return "regression sqrt" if self.sqrt else "regression"


class RegressionL1(RegressionL2):
    name = "regression_l1"

    def get_gradients(self, score, label, weight):
        label = self._trans_label(label)
        diff = score - label
        grad = (torch.sign(diff) * weight).to(torch.float32)
        hess = weight.to(torch.float32)
        return grad, hess

    def boost_from_score(self) -> float:
        if self.weight is not None:
            return weighted_percentile(self.label, self.weight, 0.5)
        return percentile(self.label, 0.5)

    def renew_tree_output_required(self) -> bool:
        return True

    def _renew_alpha(self) -> float:
        return 0.5

    def _renew_weights(self):
        return self.weight

    def renew_leaf_values(self, leaf_values: np.ndarray, leaf_ids: np.ndarray,
                          pred: np.ndarray, in_bag: np.ndarray) -> np.ndarray:
        """RenewTreeOutput (regression_objective.hpp:221-251): each leaf's
        percentile of the residuals (label - pred) over its bagged rows,
        the rows bucketed by leaf with one stable argsort."""
        alpha = self._renew_alpha()
        w = self._renew_weights()
        out = leaf_values.copy()
        n = self.num_data
        residual = self.label - pred[:n]
        lid = leaf_ids[:n]
        rows = np.nonzero(in_bag[:n])[0]
        order = rows[np.argsort(lid[rows], kind="stable")]
        sorted_lid = lid[order]
        leaf_range = np.arange(len(leaf_values))
        starts = np.searchsorted(sorted_lid, leaf_range, side="left")
        ends = np.searchsorted(sorted_lid, leaf_range, side="right")
        for leaf in leaf_range:
            rows_l = order[starts[leaf]:ends[leaf]]
            if len(rows_l) == 0:
                continue
            if w is None:
                out[leaf] = percentile(residual[rows_l], alpha)
            else:
                out[leaf] = weighted_percentile(residual[rows_l], w[rows_l],
                                                alpha)
        return out

    def to_string(self) -> str:
        return self.name


class RegressionHuber(RegressionL2):
    name = "huber"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(getattr(config, "alpha", 0.9))
        if self.sqrt:
            Log.warning("Cannot use sqrt transform in %s Regression, will "
                        "auto disable it", self.name)
            self.sqrt = False

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        self.is_constant_hessian = False

    def get_gradients(self, score, label, weight):
        diff = score - label
        clipped = torch.clamp(diff, -self.alpha, self.alpha)
        grad = (clipped * weight).to(torch.float32)
        hess = weight.to(torch.float32)
        return grad, hess

    def to_string(self) -> str:
        return self.name


class RegressionFair(RegressionL2):
    name = "fair"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.c = float(getattr(config, "fair_c", 1.0))

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        self.is_constant_hessian = False

    def get_gradients(self, score, label, weight):
        x = score - self._trans_label(label)
        denom = torch.abs(x) + self.c
        grad = (self.c * x / denom * weight).to(torch.float32)
        hess = (self.c * self.c / (denom * denom) * weight).to(torch.float32)
        return grad, hess

    def to_string(self) -> str:
        return self.name


class RegressionPoisson(RegressionL2):
    """loss = exp(f) - label * f;  output = exp(f)
    (regression_objective.hpp:405-429)."""
    name = "poisson"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(getattr(config, "poisson_max_delta_step",
                                            0.7))
        if self.sqrt:
            Log.warning("Cannot use sqrt transform in %s Regression, will "
                        "auto disable it", self.name)
            self.sqrt = False

    def check_label(self) -> None:
        if np.min(self.label) < 0.0:
            Log.fatal("[%s]: at least one target label is negative",
                      self.name)
        if np.sum(self.label) == 0.0:
            Log.fatal("[%s]: sum of labels is zero", self.name)

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        self.is_constant_hessian = False

    def get_gradients(self, score, label, weight):
        exp_s = torch.exp(score)
        grad = ((exp_s - label) * weight).to(torch.float32)
        hess = (torch.exp(score + self.max_delta_step) * weight) \
            .to(torch.float32)
        return grad, hess

    def boost_from_score(self) -> float:
        return float(np.log(super().boost_from_score()))

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

    def get_gradients(self, score, label, weight):
        label = self._trans_label(label)
        delta = score - label
        grad = (torch.where(delta >= 0, 1.0 - self.alpha, -self.alpha)
                * weight).to(torch.float32)
        hess = weight.to(torch.float32)
        return grad, hess

    def boost_from_score(self) -> float:
        if self.weight is not None:
            return weighted_percentile(self.label, self.weight, self.alpha)
        return percentile(self.label, self.alpha)

    def _renew_alpha(self) -> float:
        return self.alpha


class RegressionMAPE(RegressionL1):
    """Gradient weight 1/max(1,|label|) folded into grad only; leaf renewal
    uses the same label weights (regression_objective.hpp:551-645)."""
    name = "mape"
    is_constant_hessian = True

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        if np.any(np.abs(self.label) < 1):
            Log.warning("Met 'abs(label) < 1', will convert them to '1' in "
                        "MAPE objective and metric")
        lw = 1.0 / np.maximum(1.0, np.abs(self.label))
        self.label_weight = lw if self.weight is None else lw * self.weight
        self.is_constant_hessian = True

    def get_gradients(self, score, label, weight):
        label = self._trans_label(label)
        diff = score - label
        lw = 1.0 / torch.clamp(torch.abs(label), min=1.0)
        lw = lw * weight if self.weight is not None else lw
        grad = (torch.sign(diff) * lw).to(torch.float32)
        hess = weight.to(torch.float32)
        return grad, hess

    def boost_from_score(self) -> float:
        return weighted_percentile(self.label, self.label_weight, 0.5)

    def _renew_weights(self):
        # always weighted (by label_weight), even without sample weights
        return self.label_weight


class RegressionGamma(RegressionPoisson):
    name = "gamma"

    def get_gradients(self, score, label, weight):
        exp_ns = torch.exp(-score)
        grad = ((1.0 - label * exp_ns) * weight).to(torch.float32)
        hess = (label * exp_ns * weight).to(torch.float32)
        return grad, hess


class RegressionTweedie(RegressionPoisson):
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(getattr(config, "tweedie_variance_power", 1.5))

    def get_gradients(self, score, label, weight):
        rho = self.rho
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        grad = ((-label * e1 + e2) * weight).to(torch.float32)
        hess = ((-label * (1.0 - rho) * e1 + (2.0 - rho) * e2) * weight) \
            .to(torch.float32)
        return grad, hess
