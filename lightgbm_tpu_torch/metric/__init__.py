"""Metrics — role parity with src/metric/ (factory at metric.cpp:11-56).

Host-side numpy implementations operating on raw scores; each returns
(name, value, is_higher_better).  The ranking metrics (NDCG, MAP) are not
ported yet.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils.log import Log


class Metric:
    name = "metric"
    is_higher_better = False
    multiclass = False  # True -> eval() receives the full [K, N] score matrix

    def __init__(self, config):
        self.config = config

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None) -> None:
        if label is None:
            Log.fatal("Label should not be None for metric evaluation")
        self.label = np.asarray(label, dtype=np.float64)
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float64)
        self.sum_weight = float(len(self.label)) if self.weight is None \
            else float(np.sum(self.weight))

    def _wmean(self, values: np.ndarray) -> float:
        if self.weight is None:
            return float(np.mean(values))
        return float(np.sum(values * self.weight) / self.sum_weight)

    def eval(self, raw_score: np.ndarray, objective) -> float:
        raise NotImplementedError


class L2Metric(Metric):
    name = "l2"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        return self._wmean((self.label - pred) ** 2)


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, raw_score, objective) -> float:
        return float(np.sqrt(super().eval(raw_score, objective)))


class L1Metric(Metric):
    name = "l1"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        return self._wmean(np.abs(self.label - pred))


class QuantileMetric(Metric):
    """Pinball loss (regression_metric.hpp:141-158)."""
    name = "quantile"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        alpha = float(getattr(self.config, "alpha", 0.9))
        delta = self.label - pred
        return self._wmean(np.where(delta < 0, (alpha - 1.0) * delta, alpha * delta))


class HuberMetric(Metric):
    """Huber loss (regression_metric.hpp:175-192)."""
    name = "huber"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        a = float(getattr(self.config, "alpha", 0.9))
        diff = pred - self.label
        loss = np.where(np.abs(diff) <= a, 0.5 * diff * diff,
                        a * (np.abs(diff) - 0.5 * a))
        return self._wmean(loss)


class FairMetric(Metric):
    """Fair loss (regression_metric.hpp:196-210)."""
    name = "fair"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        c = float(getattr(self.config, "fair_c", 1.0))
        x = np.abs(pred - self.label)
        return self._wmean(c * x - c * c * np.log(1.0 + x / c))


class PoissonMetric(Metric):
    """Poisson negative log-likelihood (regression_metric.hpp:213-228)."""
    name = "poisson"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        pred = np.maximum(pred, 1e-10)
        return self._wmean(pred - self.label * np.log(pred))


class MAPEMetric(Metric):
    """MAPE with |label| clamped to >= 1 (regression_metric.hpp:232-243)."""
    name = "mape"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        return self._wmean(np.abs(self.label - pred) / np.maximum(1.0, np.abs(self.label)))


class GammaMetric(Metric):
    """Gamma negative log-likelihood with psi=1 (regression_metric.hpp:245-261);
    at psi=1 the reference formula reduces to label/pred + log(pred)."""
    name = "gamma"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        return self._wmean(self.label / pred + np.log(pred))


class GammaDevianceMetric(Metric):
    """2 * sum(label/pred - log(label/pred) - 1); a sum, not a weighted mean
    (regression_metric.hpp:264-279, AverageLoss override)."""
    name = "gamma-deviance"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        tmp = self.label / (pred + 1e-9)
        loss = tmp - np.log(tmp) - 1.0
        if self.weight is not None:
            loss = loss * self.weight
        return float(2.0 * np.sum(loss))


class TweedieMetric(Metric):
    """Tweedie deviance-like loss (regression_metric.hpp:282-299)."""
    name = "tweedie"

    def eval(self, raw_score, objective) -> float:
        pred = objective.convert_output(raw_score) if objective is not None else raw_score
        rho = float(getattr(self.config, "tweedie_variance_power", 1.5))
        pred = np.maximum(pred, 1e-10)
        a = self.label * np.exp((1.0 - rho) * np.log(pred)) / (1.0 - rho)
        b = np.exp((2.0 - rho) * np.log(pred)) / (2.0 - rho)
        return self._wmean(-a + b)


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, raw_score, objective) -> float:
        # objective is None (custom fobj): score is already a probability
        # (reference binary_metric.hpp Eval, objective==nullptr branch)
        prob = objective.convert_output(raw_score) if objective is not None else raw_score
        prob = np.clip(prob, 1e-15, 1.0 - 1e-15)
        loss = -(self.label * np.log(prob) + (1.0 - self.label) * np.log(1.0 - prob))
        return self._wmean(loss)


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, raw_score, objective) -> float:
        prob = objective.convert_output(raw_score) if objective is not None else raw_score
        return self._wmean(((prob > 0.5) != (self.label > 0)).astype(np.float64))


class AUCMetric(Metric):
    name = "auc"
    is_higher_better = True

    def eval(self, raw_score, objective) -> float:
        """Weighted ROC-AUC by rank accumulation, tie-aware
        (src/metric/binary_metric.hpp AUCMetric semantics)."""
        order = np.argsort(raw_score, kind="mergesort")
        score = raw_score[order]
        label = self.label[order]
        w = np.ones_like(label) if self.weight is None else self.weight[order]
        pos_w = np.where(label > 0, w, 0.0)
        neg_w = np.where(label > 0, 0.0, w)
        boundary = np.nonzero(np.diff(score))[0]
        seg_id = np.zeros(len(score), dtype=np.int64)
        seg_id[boundary + 1] = 1
        seg_id = np.cumsum(seg_id)
        nseg = int(seg_id[-1]) + 1 if len(score) else 0
        pos_per = np.bincount(seg_id, weights=pos_w, minlength=nseg)
        neg_per = np.bincount(seg_id, weights=neg_w, minlength=nseg)
        cum_neg_before = np.concatenate([[0.0], np.cumsum(neg_per)[:-1]])
        auc_sum = np.sum(pos_per * (cum_neg_before + 0.5 * neg_per))
        total_pos = pos_per.sum()
        total_neg = neg_per.sum()
        if total_pos <= 0 or total_neg <= 0:
            Log.warning("AUC undefined: data contains one class only")
            return 1.0
        return float(auc_sum / (total_pos * total_neg))


def _xent_loss(label: np.ndarray, prob: np.ndarray) -> np.ndarray:
    """XentLoss with the reference's 1e-12 log-argument clamp
    (xentropy_metric.hpp:31-46)."""
    eps = 1.0e-12
    a = label * np.log(np.maximum(prob, eps))
    b = (1.0 - label) * np.log(np.maximum(1.0 - prob, eps))
    return -(a + b)


class CrossEntropyMetric(Metric):
    """xentropy: weighted mean of XentLoss over p = ConvertOutput(score)
    (xentropy_metric.hpp:67-146)."""
    name = "xentropy"

    def eval(self, raw_score, objective) -> float:
        p = objective.convert_output(raw_score) if objective is not None else raw_score
        return self._wmean(_xent_loss(self.label, p))


class CrossEntropyLambdaMetric(Metric):
    """xentlambda: XentLoss on p = 1 - exp(-w * hhat), averaged over #data
    regardless of weights (xentropy_metric.hpp:162-221)."""
    name = "xentlambda"

    def eval(self, raw_score, objective) -> float:
        hhat = objective.convert_output(raw_score) if objective is not None \
            else np.log1p(np.exp(raw_score))
        w = self.weight if self.weight is not None else 1.0
        p = 1.0 - np.exp(-w * hhat)
        return float(np.mean(_xent_loss(self.label, p)))


class KLDivergenceMetric(Metric):
    """kldiv: cross-entropy plus the precomputed label-entropy offset
    (xentropy_metric.hpp:246-340)."""
    name = "kldiv"

    def init(self, label, weight, query_boundaries=None) -> None:
        super().init(label, weight, query_boundaries)
        p = self.label
        hp = np.where(p > 0, p * np.log(np.maximum(p, 1e-300)), 0.0) + \
            np.where(1.0 - p > 0, (1.0 - p) * np.log(np.maximum(1.0 - p, 1e-300)), 0.0)
        self.presum_label_entropy = self._wmean(hp)

    def eval(self, raw_score, objective) -> float:
        p = objective.convert_output(raw_score) if objective is not None else raw_score
        return self.presum_label_entropy + self._wmean(_xent_loss(self.label, p))


class MultiLoglossMetric(Metric):
    """Softmax logloss over [K, N] raw scores (multiclass_metric.hpp
    MultiSoftmaxLoglossMetric)."""
    name = "multi_logloss"
    multiclass = True

    def eval(self, raw_score, objective) -> float:
        # raw_score [K, N] -> probabilities [N, K] via the objective transform
        raw = np.asarray(raw_score, dtype=np.float64).T
        prob = objective.convert_output(raw) if objective is not None else raw
        k = self.label.astype(np.int64)
        p = prob[np.arange(len(k)), k]
        return self._wmean(-np.log(np.maximum(p, 1e-15)))


class MultiErrorMetric(Metric):
    """Top-1 error with the reference's tie rule: any other class with
    score >= the true class counts as an error (multiclass_metric.hpp
    MultiErrorMetric)."""
    name = "multi_error"
    multiclass = True

    def eval(self, raw_score, objective) -> float:
        raw = np.asarray(raw_score, dtype=np.float64).T
        prob = objective.convert_output(raw) if objective is not None else raw
        k = self.label.astype(np.int64)
        true_p = prob[np.arange(len(k)), k]
        others = prob.copy()
        others[np.arange(len(k)), k] = -np.inf
        err = (np.max(others, axis=1) >= true_p).astype(np.float64)
        return self._wmean(err)


_REGISTRY = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric,
    "gamma": GammaMetric, "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "xentropy": CrossEntropyMetric, "xentlambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivergenceMetric,
}


def create_metric(name: str, config) -> Optional[Metric]:
    cls = _REGISTRY.get(name)
    if cls is None:
        Log.warning("Unknown metric type name: %s", name)
        return None
    return cls(config)


def create_metrics(names, config) -> List:
    """Metric instances for the configured names; unknown names (the
    ranking metrics among them) are warned about and skipped."""
    out: List = []
    for name in names:
        m = create_metric(name, config)
        if m is not None:
            out.append(m)
    return out
