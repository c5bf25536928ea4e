"""EFB storage decode (counterpart of lightgbm_tpu/ops/bundle.py).

The storage/bin matrix holds G bundled columns; the split layer sees F
original features.  Two primitives bridge them (reference counterpart:
FeatureGroup bin offsets + FeatureHistogram views into the group
histogram, include/LightGBM/feature_group.h:18):

- `expand_histogram`: [G, Bg, 3] bundle histogram -> [F, B, 3]
  per-feature views by a static gather; a feature's default bin takes the
  bundle remainder (rows where any OTHER member was non-default are rows
  where this member sat at its default).  Plain PyTorch, as the JAX
  package's is plain jnp: it reaches no Pallas kernel, and on the card it
  is captured in the tree's CUDA graphs with the rest of the split step.
- `decode_bin`: bundled storage value -> the original feature's bin, used
  by every routing site (partition predicates, traversal).

A dataset without bundling uses the identity map (f_group=arange,
identity=True) so every consumer runs one code path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def bundle_map_from_info(info, device=None) -> BundleMap:
    """The map of a dataset's BundleInfo (io/bundling.py), on `device`."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return BundleMap(f_group=t(info.f_group, torch.int32),
                     f_offset=t(info.f_offset, torch.int32),
                     f_identity=t(info.f_identity, torch.bool))


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


class HistogramExpansion(NamedTuple):
    """The static tables of `expand_histogram` for one bundle map: built
    once per grower, so a split step only gathers."""
    group: torch.Tensor       # [F, 1] i64 storage column of each feature
    src: torch.Tensor         # [F, B] i64 storage bin of each feature bin
    valid: torch.Tensor       # [F, B, 1] bool: b < num_bin
    is_default: torch.Tensor  # [F, B, 1] bool: b == default_bin
    fix: torch.Tensor         # [F, B, 1] bool: the default bin of a bundled
    #                           (non-identity) feature


def histogram_expansion(bmap: BundleMap, num_bin: torch.Tensor,
                        default_bin: torch.Tensor, num_bins_feature: int,
                        num_bins_storage: int) -> HistogramExpansion:
    """The gather tables of the JAX package's expand_histogram
    (ops/bundle.py:58-78) for [G, Bg, 3] -> [F, B, 3] with Bg =
    num_bins_storage and B = num_bins_feature."""
    dev = num_bin.device
    B = num_bins_feature
    b = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    d = default_bin.to(torch.int32)[:, None]
    ident = bmap.f_identity.to(dev)[:, None]
    src = torch.where(ident, b, bmap.f_offset.to(dev)[:, None] + b
                      - (b > d).to(torch.int32))
    src = src.clamp(0, num_bins_storage - 1).long()
    is_default = (b == d)[:, :, None]
    return HistogramExpansion(
        group=bmap.f_group.to(dev).long()[:, None], src=src,
        valid=(b < num_bin.to(dev)[:, None])[:, :, None],
        is_default=is_default, fix=is_default & ~ident[:, :, None])


def expand_histogram(hist_g: torch.Tensor, tables: HistogramExpansion
                     ) -> torch.Tensor:
    """[..., G, Bg, 3] f32 bundle histograms -> [..., F, B, 3] per-feature
    views (the JAX package's expand_histogram, over any leading batch
    dimensions): a gather, zero past each feature's bins, and a bundled
    feature's default bin = its bundle's total minus its own bins' mass,
    in f32.  A quantized (int32) histogram is expanded after
    dequantization, as the JAX grower's find_split(hist_view(deq(h)))."""
    out = hist_g[..., tables.group, tables.src, :]            # [..., F, B, 3]
    zero = out.new_zeros(())
    out = torch.where(tables.valid, out, zero)
    totals = hist_g.sum(dim=-2)[..., tables.group[:, 0], :]   # [..., F, 3]
    own = torch.where(tables.is_default, zero, out).sum(dim=-2)
    fixed = (totals - own)[..., None, :]
    return torch.where(tables.fix, fixed, out)
