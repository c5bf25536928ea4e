"""EFB storage decode (counterpart of lightgbm_tpu/ops/bundle.py).

The storage/bin matrix holds G bundled columns; the split layer sees F
original features.  This slice trains dense data, where bundling never
triggers, so only the identity map and `decode_bin` (which every routing
site calls, and which the partition predicate must follow exactly) are
ported; `expand_histogram` waits for the bundled path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BundleMap(NamedTuple):
    f_group: torch.Tensor     # [F] i32 storage column of each feature
    f_offset: torch.Tensor    # [F] i32 bin offset inside the bundle
    f_identity: torch.Tensor  # [F] bool raw-bin passthrough


def identity_bundle_map(num_features: int, device=None) -> BundleMap:
    return BundleMap(
        f_group=torch.arange(num_features, dtype=torch.int32, device=device),
        f_offset=torch.zeros(num_features, dtype=torch.int32, device=device),
        f_identity=torch.ones(num_features, dtype=torch.bool, device=device))


def decode_bin(value, identity, offset, num_bin, default_bin):
    """Original bin of one feature given its bundle's storage value.

    enc = offset + b - (b > d) for b != d; anything outside the feature's
    range means "this member at its default bin"."""
    v = value.to(torch.int32)
    e = v - offset
    in_range = (e >= 0) & (e < num_bin - 1)
    b = e + (e >= default_bin).to(torch.int32)
    return torch.where(torch.as_tensor(identity, device=v.device), v,
                       torch.where(in_range, b,
                                   torch.as_tensor(default_bin,
                                                   dtype=torch.int32,
                                                   device=v.device)))
