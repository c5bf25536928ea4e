"""State carried across between the two packages.

The JAX package keeps a GBDT's training state in the fast-path payload
([N_pad + GUARD, P] f32, gbdt._FastState) and describes splits with
FeatureMeta and SplitPredicate tuples; this package keeps the same
layouts.  These helpers take the numpy form of that state (np.asarray of
each JAX array, or any tuple with the same field names) and return the
tensors this package uses, and back.  A quantized payload (integer-valued
grad/hess columns) crosses like any other, with its [2] scales beside it
(`qscale_from_numpy`).  A partition-ordered payload's per-row state (the
bag in the count column, the scores) reads back in original row order
through its index column (`original_order`, `bag_mask_from_payload`,
`scores_from_payload`; on the wide layout past 2^24 rows the index is
split in radix-4096 halves, and `idxhi_col` names the high one), so the
two packages' bags and scores (every class plane's, and the snapshot's,
for K > 1) compare row for row.  They import nothing of the JAX package.  A GBDT's
"weights" are its model text, which both packages read and write:
`Booster(model_str=...)` loads a model written by either.
"""
from __future__ import annotations

import numpy as np
import torch

from .boosting.gbdt import _IDX_RADIX
from .ops.segment import SplitPredicate
from .ops.split import FeatureMeta

_META_DTYPES = dict(num_bin=torch.int32, missing_type=torch.int32,
                    default_bin=torch.int32, is_trivial=torch.bool,
                    is_categorical=torch.bool, penalty=torch.float32,
                    monotone=torch.int32)

_PRED_DTYPES = dict(col=torch.int32, threshold=torch.int32,
                    default_left=torch.bool, is_cat=torch.bool,
                    bitset=torch.bool, missing_type=torch.int32,
                    num_bin=torch.int32, default_bin=torch.int32,
                    offset=torch.int32, identity=torch.bool)


def payload_from_numpy(payload, device="cpu") -> torch.Tensor:
    """A payload array ([N_pad + GUARD, P] f32) as a contiguous tensor.
    The column layout is the same in both packages: bins 0..G-1, label,
    weight, count, index, then K score columns from G + 4, for K > 1 K
    snapshot columns from G + 4 + K, then grad, hess, value, bvalid and
    gweight, and idxhi on the wide layout (P = G + 10 for one tree per
    iteration, G + 2K + 9 for K > 1, one more on the wide layout).
    The TPU's padding to 128 lanes, if present, is kept as it is."""
    arr = np.ascontiguousarray(np.asarray(payload, dtype=np.float32))
    if arr.ndim != 2:
        raise ValueError("payload must be 2-D, got shape %s" % (arr.shape,))
    return torch.from_numpy(arr.copy()).to(device)


def payload_to_numpy(payload: torch.Tensor) -> np.ndarray:
    """The payload back as a host f32 array."""
    return payload.detach().to("cpu", torch.float32).numpy().copy()


def qscale_from_numpy(qscale, device="cpu") -> torch.Tensor:
    """The quantized mode's [2] f32 (gradient, hessian) scales, as
    quantize_pair returns them, as a tensor for the grower."""
    arr = np.array(qscale, dtype=np.float32).reshape(-1)
    if arr.shape != (2,):
        raise ValueError("qscale must hold 2 values, got shape %s"
                         % (arr.shape,))
    return torch.from_numpy(arr).to(device)


def _fields(obj, name):
    # np.array copies: a read-only view of a JAX array cannot back a tensor
    return np.array(obj[name] if isinstance(obj, dict) else
                    getattr(obj, name))


def feature_meta_from_numpy(meta, device="cpu") -> FeatureMeta:
    """FeatureMeta from any object (or dict) with the JAX FeatureMeta's
    field names holding array-likes."""
    return FeatureMeta(**{
        k: torch.as_tensor(_fields(meta, k), device=device).to(dt)
        for k, dt in _META_DTYPES.items()})


def split_predicate_from_numpy(pred, device="cpu") -> SplitPredicate:
    """SplitPredicate of 0-d tensors (and a [B] bitset) from any object
    (or dict) with the JAX SplitPredicate's field names."""
    return SplitPredicate(**{
        k: torch.as_tensor(_fields(pred, k), device=device).to(dt)
        for k, dt in _PRED_DTYPES.items()})


#: radix of the wide layout's split index (both packages' _IDX_RADIX)
IDX_RADIX = _IDX_RADIX


def original_order(payload, col, idx_col: int, n_pad: int,
                   idxhi_col: int = None) -> np.ndarray:
    """Column `col` (or a sequence of columns) of a partition-ordered
    payload (either package's, as a tensor or any array-like) in ORIGINAL
    row order: [n_pad] f64 (or [len(col), n_pad]), routed by the index
    column (idx + IDX_RADIX * idxhi on the wide layout, where
    `idxhi_col` is given); guard rows (index n_pad) are dropped."""
    if isinstance(payload, torch.Tensor):
        payload = payload.detach().cpu().numpy()
    pay = np.asarray(payload, dtype=np.float32)
    idx = pay[:, idx_col].astype(np.int64)
    if idxhi_col is not None:
        idx = idx + pay[:, idxhi_col].astype(np.int64) * IDX_RADIX
    keep = idx < n_pad
    cols = np.atleast_1d(np.asarray(col, np.int64))
    out = np.zeros((len(cols), n_pad), np.float64)
    out[:, idx[keep]] = pay[keep][:, cols].T
    return out if np.ndim(col) else out[0]


def bag_mask_from_payload(payload, cnt_col: int, idx_col: int,
                          n_pad: int, idxhi_col: int = None) -> np.ndarray:
    """The bag (count-mask column) in original row order, [n_pad] f32 of
    0/1: zero on padded rows and on rows out of the bag."""
    return (original_order(payload, cnt_col, idx_col, n_pad, idxhi_col)
            > 0).astype(np.float32)


def scores_from_payload(payload, score_col: int, idx_col: int,
                        n_pad: int, num_class: int = 0,
                        idxhi_col: int = None) -> np.ndarray:
    """The raw scores in original row order: the score column, [n_pad]
    f64 (before a tree is added, the pre-tree scores renewal reads), or
    with num_class=K the K columns from `score_col` (the scores, or the
    snapshot from snap0), [K, n_pad]."""
    if num_class:
        return original_order(payload, range(score_col,
                                             score_col + num_class),
                              idx_col, n_pad, idxhi_col)
    return original_order(payload, score_col, idx_col, n_pad, idxhi_col)
