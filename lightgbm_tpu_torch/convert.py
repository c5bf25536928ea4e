"""State carried across between the two packages.

The JAX package keeps a GBDT's training state in the fast-path payload
([N_pad + GUARD, P] f32, gbdt._FastState) and describes splits with
FeatureMeta and SplitPredicate tuples; this package keeps the same
layouts.  These helpers take the numpy form of that state (np.asarray of
each JAX array, or any tuple with the same field names) and return the
tensors this package uses, and back.  A quantized payload (integer-valued
grad/hess columns) crosses like any other, with its [2] scales beside it
(`qscale_from_numpy`).  They import nothing of the JAX package.  A GBDT's "weights" are its model text, which both packages read
and write: `Booster(model_str=...)` loads a model written by either.
"""
from __future__ import annotations

import numpy as np
import torch

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
    The column layout is the same in both packages (P = G + 10 for one
    tree per iteration); the TPU's padding to 128 lanes, if present, is
    kept as it is."""
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
