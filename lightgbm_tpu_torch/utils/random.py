"""Deterministic light-weight PRNG for host-side sampling decisions.

Role parity with the reference's include/LightGBM/utils/random.h:9-113 (Random
class with NextShort/NextInt/NextFloat and k-of-N sampling).  Host-side code
(bagging index generation, feature sampling, binning sample selection) uses
numpy Generators seeded deterministically, so runs are reproducible
end-to-end.
"""
from __future__ import annotations

import numpy as np


class Random:
    """Deterministic PRNG with the sampling helpers the trainers need."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.Generator(np.random.Philox(seed))

    def next_int(self, lower: int, upper: int) -> int:
        return int(self._rng.integers(lower, upper))

    def next_float(self) -> float:
        return float(self._rng.random())

    def sample(self, total: int, k: int) -> np.ndarray:
        """Sample k distinct indices from [0, total), sorted ascending."""
        k = min(k, total)
        if k <= 0:
            return np.empty(0, dtype=np.int64)
        idx = self._rng.choice(total, size=k, replace=False)
        idx.sort()
        return idx


def partition_seed(seed: int, stream: int) -> int:
    """Derive independent seeds for named subsystems (bagging, feature_fraction, ...)."""
    return (seed * 1000003 + stream * 7919 + 12345) % (2**31 - 1)
