"""Ranking metrics: NDCG@k and MAP@k (counterpart of
lightgbm_tpu/metric/rank.py).

Role parity with src/metric/rank_metric.hpp (NDCGMetric), map_metric.hpp
(MapMetric) and dcg_calculator.cpp.  Host-side numpy: metrics consume raw
scores fetched once per eval round, one per-query argsort per eval position.
"""
from __future__ import annotations

import numpy as np

from ..objective.rank import (check_rank_label, default_label_gain,
                              max_dcg_at_k, position_discounts)
from ..utils.log import Log


class RankMetric:
    """Shared query plumbing; query_weight = mean doc weight per query
    (metadata.cpp:464-472 LoadQueryWeights)."""
    is_higher_better = True
    multiclass = False

    def __init__(self, config, k: int):
        self.config = config
        self.k = int(k)

    def init(self, label, weight, query_boundaries=None) -> None:
        if query_boundaries is None:
            Log.fatal("The %s metric requires query information" % self.name)
        self.label = np.asarray(label, dtype=np.float64)
        self.qb = np.asarray(query_boundaries, dtype=np.int64)
        self.num_queries = len(self.qb) - 1
        if weight is None:
            self.query_weights = None
            self.sum_query_weights = float(self.num_queries)
        else:
            w = np.asarray(weight, dtype=np.float64)
            sums = np.add.reduceat(w, self.qb[:-1])
            self.query_weights = sums / np.maximum(np.diff(self.qb), 1)
            self.sum_query_weights = float(self.query_weights.sum())

    def _query_average(self, per_query: np.ndarray) -> float:
        if self.query_weights is not None:
            per_query = per_query * self.query_weights
        return float(per_query.sum() / self.sum_query_weights)


class NDCGAtK(RankMetric):
    def __init__(self, config, k: int):
        super().__init__(config, k)
        self.name = "ndcg@%d" % k
        gains = list(getattr(config, "label_gain", ()) or ())
        self.label_gain = np.asarray(gains, np.float64) if gains \
            else default_label_gain()

    def init(self, label, weight, query_boundaries=None) -> None:
        super().init(label, weight, query_boundaries)
        check_rank_label(self.label, len(self.label_gain))
        self.inverse_max_dcg = np.zeros(self.num_queries)
        for qi in range(self.num_queries):
            lo, hi = int(self.qb[qi]), int(self.qb[qi + 1])
            mdcg = max_dcg_at_k(self.k, self.label[lo:hi], self.label_gain)
            # all-negative queries marked -1 -> scored as NDCG=1
            # (rank_metric.hpp:69-75)
            self.inverse_max_dcg[qi] = 1.0 / mdcg if mdcg > 0.0 else -1.0

    def eval(self, raw_score: np.ndarray, objective) -> float:
        score = np.asarray(raw_score, dtype=np.float64)
        out = np.zeros(self.num_queries)
        for qi in range(self.num_queries):
            lo, hi = int(self.qb[qi]), int(self.qb[qi + 1])
            if self.inverse_max_dcg[qi] <= 0.0:
                out[qi] = 1.0
                continue
            k = min(self.k, hi - lo)
            order = np.argsort(-score[lo:hi], kind="stable")[:k]
            disc = position_discounts(k)
            dcg = np.sum(self.label_gain[
                self.label[lo:hi][order].astype(np.int64)] * disc)
            out[qi] = dcg * self.inverse_max_dcg[qi]
        return self._query_average(out)


class MAPAtK(RankMetric):
    def __init__(self, config, k: int):
        super().__init__(config, k)
        self.name = "map@%d" % k

    def init(self, label, weight, query_boundaries=None) -> None:
        super().init(label, weight, query_boundaries)
        self.npos = np.add.reduceat((self.label > 0.5).astype(np.int64),
                                    self.qb[:-1])

    def eval(self, raw_score: np.ndarray, objective) -> float:
        score = np.asarray(raw_score, dtype=np.float64)
        out = np.zeros(self.num_queries)
        for qi in range(self.num_queries):
            lo, hi = int(self.qb[qi]), int(self.qb[qi + 1])
            npos = int(self.npos[qi])
            if npos <= 0:
                out[qi] = 1.0
                continue
            k = min(self.k, hi - lo)
            order = np.argsort(-score[lo:hi], kind="stable")[:k]
            hits = self.label[lo:hi][order] > 0.5
            cum_hits = np.cumsum(hits)
            ap = np.sum(np.where(hits, cum_hits / (np.arange(k) + 1.0), 0.0))
            out[qi] = ap / min(npos, k)
        return self._query_average(out)
