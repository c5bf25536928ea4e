"""LambdaRank (NDCG) objective (counterpart of lightgbm_tpu/objective/rank.py).

Role parity with the reference src/objective/rank_objective.hpp
(LambdarankNDCG: Init at :43-71, GetGradientsForOneQuery at :82-168) and
src/metric/dcg_calculator.cpp (label gains, position discounts,
CalMaxDCGAtK at :52-74).

The JAX package pads every query to the longest one ([Q, S]) and computes
the pairwise lambdas of a chunk of queries as one [q, S, S] program.  On
the card a query of ~120 documents padded to MSLR's longest (~1,250)
would do ~100x its pairs, so here each query is padded to its size class
(the next power of two) and each class's [Q_b, S_b] block is cut into
chunks of at most PAIR_CHUNK pairs.  A query's lambdas are the same f32
terms either way (the padding pairs add exact zeros); only the order of
the row sums' adds can differ.  The tables are built once, in init, on
the host; the fill gathers scores, sorts with stable sorts (every score
ties at iteration 0), and gathers each document's lambda back from its
one slot, so no atomic add and no host read runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction

# reference dcg_calculator.cpp:30-38: label_gain[i] = 2^i - 1, 31 levels
_MAX_LABEL = 31

#: pairs (f32 elements of one [q, S_b, S_b] temporary) per query chunk:
#: 256 MiB, ~2.5 GiB with the chunk's other temporaries
PAIR_CHUNK = 1 << 26


def default_label_gain() -> np.ndarray:
    return np.array([(1 << i) - 1 for i in range(_MAX_LABEL)],
                    dtype=np.float64)


def position_discounts(n: int) -> np.ndarray:
    """discount[i] = 1/log2(2+i) (dcg_calculator.cpp:44-48)."""
    return 1.0 / np.log2(2.0 + np.arange(n, dtype=np.float64))


def max_dcg_at_k(k: int, labels: np.ndarray, label_gain: np.ndarray) -> float:
    """Ideal DCG@k: labels sorted descending (CalMaxDCGAtK)."""
    k = min(k, len(labels))
    top = np.sort(labels.astype(np.int64))[::-1][:k]
    disc = position_discounts(k)
    return float(np.sum(label_gain[top] * disc))


def check_rank_label(label: np.ndarray, num_levels: int) -> None:
    """DCGCalculator::CheckLabel semantics."""
    if np.any(np.abs(label - np.round(label)) > 1e-15):
        Log.fatal("label should be int type for ranking task")
    if np.any(label < 0) or np.any(label >= num_levels):
        Log.fatal("label exceeds the max range of label_gain")


def size_class(n: int) -> int:
    """The padded length of a query of n documents: the next power of two."""
    return 1 << max(int(n) - 1, 0).bit_length()


class LambdarankNDCG(ObjectiveFunction):
    is_rowwise = False  # pairwise within query groups
    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(getattr(config, "sigmoid", 1.0))
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero",
                      self.sigmoid)
        gains = list(getattr(config, "label_gain", ()) or ())
        self.label_gain = np.asarray(gains, np.float64) if gains \
            else default_label_gain()
        self.optimize_pos_at = int(getattr(config, "max_position", 20))

    def init(self, label, weight, query_boundaries=None) -> None:
        super().init(label, weight, query_boundaries)
        if query_boundaries is None:
            Log.fatal("Lambdarank tasks require query information")
        qb = np.asarray(query_boundaries, dtype=np.int64)
        check_rank_label(self.label, len(self.label_gain))
        sizes = np.diff(qb)
        cls = np.asarray([size_class(n) for n in sizes], np.int64)
        # one [Q_b, S_b] block per size class: each slot's document (0 on
        # padding, which the mask drops), label and 1/maxDCG@max_position;
        # `slot` holds each document's position in the blocks' flat concat
        self.blocks = []
        slot = np.zeros(self.num_data, np.int64)
        base = 0
        for S in np.unique(cls):
            qs = np.nonzero(cls == S)[0]
            Qb = len(qs)
            doc_idx = np.zeros((Qb, S), np.int64)
            mask = np.zeros((Qb, S), bool)
            label_mat = np.zeros((Qb, S), np.float32)
            inv_max_dcg = np.zeros(Qb, np.float32)
            for i, qi in enumerate(qs):
                lo, hi = int(qb[qi]), int(qb[qi + 1])
                cnt = hi - lo
                doc_idx[i, :cnt] = np.arange(lo, hi)
                mask[i, :cnt] = True
                label_mat[i, :cnt] = self.label[lo:hi]
                slot[lo:hi] = base + i * S + np.arange(cnt)
                mdcg = max_dcg_at_k(self.optimize_pos_at, self.label[lo:hi],
                                    self.label_gain)
                inv_max_dcg[i] = 1.0 / mdcg if mdcg > 0.0 else 0.0
            chunk = int(min(max(1, PAIR_CHUNK // (S * S)), Qb))
            self.blocks.append(dict(S=int(S), chunk=chunk, doc_idx=doc_idx,
                                    mask=mask, label=label_mat,
                                    inv_max_dcg=inv_max_dcg))
            base += Qb * int(S)
        self.slot = slot
        self.max_size = int(cls.max()) if len(cls) else 1

    def _tables(self, device):
        t = self.device_table
        out = []
        for b, blk in enumerate(self.blocks):
            out.append(dict(
                S=blk["S"], chunk=blk["chunk"],
                doc_idx=t("doc_idx%d" % b, blk["doc_idx"], device,
                          torch.int64),
                mask=t("mask%d" % b, blk["mask"], device, torch.bool),
                label=t("label%d" % b, blk["label"], device),
                inv_max_dcg=t("inv_max_dcg%d" % b, blk["inv_max_dcg"],
                              device)))
        shared = dict(
            slot=t("slot", self.slot, device, torch.int64),
            gain=t("gain", self.label_gain, device),
            disc=t("disc", position_discounts(self.max_size), device))
        return out, shared

    def _chunk_lambdas(self, s, lbl, msk, imd, gain_tab, disc_tab):
        """Pairwise lambdas of a chunk of queries: s, lbl, msk [q, S], imd
        [q] -> (g, h) [q, S] (rank_objective.hpp GetGradientsForOneQuery,
        in the JAX package's order of operations)."""
        sigma = self.sigmoid
        neg_inf = -1e30
        s_m = torch.where(msk, s, neg_inf)
        # rank of every slot in its query's descending-score order
        order = torch.argsort(-s_m, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        disc = disc_tab[ranks] * msk
        gain = gain_tab[lbl.to(torch.int64)]
        best = s_m.amax(dim=1, keepdim=True)
        worst = torch.where(msk, s, -neg_inf).amin(dim=1, keepdim=True)
        has_range = (best != worst)[:, :, None]

        ds = s[:, :, None] - s[:, None, :]            # i = high, j = low
        valid = msk[:, :, None] & msk[:, None, :] & \
            (lbl[:, :, None] > lbl[:, None, :])
        dcg_gap = gain[:, :, None] - gain[:, None, :]
        paired_disc = torch.abs(disc[:, :, None] - disc[:, None, :])
        delta = dcg_gap * paired_disc * imd[:, None, None]
        delta = torch.where(has_range, delta / (0.01 + torch.abs(ds)), delta)
        sig = 2.0 / (1.0 + torch.exp(2.0 * sigma * ds))
        p_lambda = torch.where(valid, -delta * sig, 0.0)
        p_hess = torch.where(valid, 2.0 * delta * sig * (2.0 - sig), 0.0)
        # pair (i high, j low): lambda_i += p, lambda_j -= p; hess both += h
        g = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
        h = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        return g, h

    def get_gradients(self, score, label, weight):
        """score [M] (M >= num_data, rows past num_data are padding) in
        original row order -> (grad, hess) [M]; label is the one init saw
        (its [Q_b, S_b] tables), weight multiplies at the end
        (rank_objective.hpp:162-167)."""
        blocks, shared = self._tables(score.device)
        gs, hs = [], []
        for blk in blocks:
            for c0 in range(0, blk["doc_idx"].shape[0], blk["chunk"]):
                c1 = c0 + blk["chunk"]
                g, h = self._chunk_lambdas(
                    score[blk["doc_idx"][c0:c1]], blk["label"][c0:c1],
                    blk["mask"][c0:c1], blk["inv_max_dcg"][c0:c1],
                    shared["gain"], shared["disc"])
                gs.append(g.reshape(-1))
                hs.append(h.reshape(-1))
        tail = score.new_zeros(score.shape[0] - self.num_data)
        # every document sits in exactly one slot: a gather, no scatter-add
        grad = torch.cat([torch.cat(gs)[shared["slot"]], tail])
        hess = torch.cat([torch.cat(hs)[shared["slot"]], tail])
        return (grad * weight).to(torch.float32), \
            (hess * weight).to(torch.float32)

    def to_string(self) -> str:
        return self.name
