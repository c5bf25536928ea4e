"""Objective factory — reference src/objective/objective_function.cpp:10-47.

Every name of the JAX package's registry is registered, so every model
text it writes loads and predicts, and every one trains.  "none" (what a
custom objective sets) makes no objective: the trainer takes the caller's
gradients and the metrics read raw scores."""
from __future__ import annotations

from ..utils.log import Log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG
from .regression import (RegressionFair, RegressionGamma, RegressionHuber,
                         RegressionL1, RegressionL2, RegressionMAPE,
                         RegressionPoisson, RegressionQuantile,
                         RegressionTweedie)
from .xentropy import CrossEntropy, CrossEntropyLambda

_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "lambdarank": LambdarankNDCG,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
}

def create_objective(name: str, config) -> ObjectiveFunction:
    if name in _REGISTRY:
        return _REGISTRY[name](config)
    if name == "none":
        return None
    Log.fatal("Unknown objective type name: %s", name)


def create_objective_from_model_string(objective_str: str, config):
    """Parse 'binary sigmoid:1'-style objective strings from model files."""
    parts = objective_str.split()
    name = parts[0] if parts else "regression"
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            try:
                setattr(config, k, int(v))
            except ValueError:
                try:
                    setattr(config, k, float(v))
                except ValueError:
                    setattr(config, k, v)
        elif tok == "sqrt":
            config.reg_sqrt = True
    return create_objective(name, config)
