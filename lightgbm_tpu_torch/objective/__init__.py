"""Objective factory — reference src/objective/objective_function.cpp:10-47.

This slice ports the binary objective; the others raise until ported."""
from __future__ import annotations

from .base import ObjectiveFunction
from .binary import BinaryLogloss

_REGISTRY = {
    "binary": BinaryLogloss,
}


def create_objective(name: str, config) -> ObjectiveFunction:
    if name in _REGISTRY:
        return _REGISTRY[name](config)
    if name == "none":
        return None
    raise NotImplementedError(
        "objective %s is not ported to the PyTorch package yet (ported: %s)"
        % (name, ", ".join(sorted(_REGISTRY))))


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
