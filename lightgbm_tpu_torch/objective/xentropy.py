"""Cross-entropy objectives for labels in [0, 1] (counterpart of
lightgbm_tpu/objective/xentropy.py).

Role parity with the reference src/objective/xentropy_objective.hpp:
CrossEntropy ("xentropy", :38-135), loss on p = sigmoid(f), whose output
is sigmoid(f), and CrossEntropyLambda ("xentlambda", :140-268), the
parameterization p = 1 - exp(-w * log(1 + exp(f))), whose output is the
positive intensity log1p(exp(f)), not a probability.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction


def _check_unit_interval(label: np.ndarray, name: str) -> None:
    if np.any(label < 0.0) or np.any(label > 1.0):
        Log.fatal("[%s]: label must be in the interval [0, 1]", name)


def _sigmoid_grads(score, label, weight):
    z = 1.0 / (1.0 + torch.exp(-score))
    grad = ((z - label) * weight).to(torch.float32)
    hess = (z * (1.0 - z) * weight).to(torch.float32)
    return grad, hess


class CrossEntropy(ObjectiveFunction):
    name = "xentropy"

    def check_label(self) -> None:
        _check_unit_interval(self.label, self.name)
        if self.weight is not None:
            if np.min(self.weight) < 0.0:
                Log.fatal("[%s]: at least one weight is negative", self.name)
            if np.sum(self.weight) == 0.0:
                Log.fatal("[%s]: sum of weights is zero", self.name)

    def get_gradients(self, score, label, weight):
        return _sigmoid_grads(score, label, weight)

    def boost_from_score(self) -> float:
        if self.weight is not None:
            pavg = float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        init = float(np.log(pavg / (1.0 - pavg)))
        Log.info("[%s:BoostFromScore]: pavg = %f -> initscore = %f",
                 self.name, pavg, init)
        return init

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-raw))


class CrossEntropyLambda(ObjectiveFunction):
    name = "xentlambda"

    def check_label(self) -> None:
        _check_unit_interval(self.label, self.name)
        if self.weight is not None:
            if np.min(self.weight) <= 0.0:
                Log.fatal("[%s]: at least one weight is non-positive",
                          self.name)
        self._has_weight = self.weight is not None

    def get_gradients(self, score, label, weight):
        if not self._has_weight:
            # unit weights: CrossEntropy's gradients
            # (xentropy_objective.hpp:185-193); padded rows carry w = 0
            return _sigmoid_grads(score, label, weight)
        # padded and guard rows carry w = 0, which drives z -> 0 and c -> 1
        # and turns the closed form into 0/0: compute with w = 1 there and
        # select 0 (real rows have w > 0, checked in init).  torch.where,
        # not a product: NaN * 0 is NaN
        valid = weight > 0.0
        w = torch.where(valid, weight, 1.0)
        y = label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        grad = torch.where(valid, grad, 0.0)
        hess = torch.where(valid, hess, 0.0)
        return grad.to(torch.float32), hess.to(torch.float32)

    def boost_from_score(self) -> float:
        if self.weight is not None:
            havg = float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        else:
            havg = float(np.mean(self.label))
        init = float(np.log(np.expm1(max(havg, 1e-15))))
        Log.info("[%s:BoostFromScore]: havg = %f -> initscore = %f",
                 self.name, havg, init)
        return init

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        # the "normalized exponential parameter" lambda > 0, NOT a probability
        return np.log1p(np.exp(raw))
