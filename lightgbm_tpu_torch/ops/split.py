"""Best-split search over histograms as vectorized prefix scans.

Counterpart of lightgbm_tpu/ops/split.py, numerical splits only: the same
two scan directions, missing-value routing, kEpsilon hessian seeding, gain
and leaf-output formulas, in the same order of operations so the CPU
results agree with the JAX package to the last few ulps.  Categorical
search (`_categorical_best`) is not ported yet: asking for it raises.

One routine serves every caller: `find_best_split_batched` searches a
leading [Q] axis of histograms, and `find_best_split` is its Q = 1 case,
so the root and the children of every split run the same arithmetic
(the JAX grower keeps the same rule, grower2.py:326-332).  Every
operation in it is elementwise, a serial scan along the bin axis of one
histogram, or an argmax (exact, first maximum), so a histogram's result
does not depend on Q: the frontier-batched grower (Q = 2K) picks the
same splits as the one-leaf loop (Q = 2), on the card too.
`dequantize_hist` gives the f32 view of the quantized mode's int32
histograms.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class FeatureMeta(NamedTuple):
    """Static per-feature arrays mirrored from the BinMappers
    (reference FeatureMetainfo, feature_histogram.hpp:15-26)."""
    num_bin: torch.Tensor       # [F] int32
    missing_type: torch.Tensor  # [F] int32
    default_bin: torch.Tensor   # [F] int32
    is_trivial: torch.Tensor    # [F] bool
    is_categorical: torch.Tensor  # [F] bool
    penalty: torch.Tensor       # [F] float32 feature_contrib penalty
    monotone: torch.Tensor      # [F] int32 in {-1, 0, +1}


class SplitResult(NamedTuple):
    gain: torch.Tensor           # f32; -inf when no valid split
    feature: torch.Tensor        # i32
    threshold_bin: torch.Tensor  # i32
    default_left: torch.Tensor   # bool
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor     # f32
    is_cat: torch.Tensor         # bool (always False in this slice)
    cat_bitset: torch.Tensor     # [..., B] bool
    left_output: torch.Tensor
    right_output: torch.Tensor


def threshold_l1(s, l1):
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(sum_g, sum_h, l1, l2, max_delta_step):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:447-456)."""
    ret = -threshold_l1(sum_g, l1) / (sum_h + l2)
    if max_delta_step > 0.0:
        ret = torch.clamp(ret, -max_delta_step, max_delta_step)
    return ret


def _leaf_split_gain(sum_g, sum_h, l1, l2, max_delta_step):
    """GetLeafSplitGain: gain of keeping (sum_g, sum_h) as one leaf."""
    out = leaf_output(sum_g, sum_h, l1, l2, max_delta_step)
    sg_l1 = threshold_l1(sum_g, l1)
    return -(2.0 * sg_l1 * out + (sum_h + l2) * out * out)


def _numerical_gain_tensor(hist, sum_g, total_h, num_data, feature_mask, *,
                           meta, l1, l2, max_delta_step, min_data_in_leaf,
                           min_sum_hessian_in_leaf, min_gain_to_split):
    """Shifted and penalized gains [Q, F, 2, B] (direction -1 first) plus
    the stacked left-side aggregates.  hist is [Q, F, B, 3]; sum_g,
    total_h and num_data are [Q]."""
    B = hist.shape[2]
    dev = hist.device
    bins = torch.arange(B, dtype=torch.int32, device=dev)[None, :]   # [1, B]
    nb = meta.num_bin[:, None]                                        # [F, 1]
    valid_bin = bins < nb

    is_nan = (meta.missing_type == MISSING_NAN)[:, None]
    is_zero = (meta.missing_type == MISSING_ZERO)[:, None]
    two_scan = ((meta.num_bin > 2)
                & (meta.missing_type != MISSING_NONE))[:, None]

    # mass excluded from the scanned prefix: it follows the default direction
    excl = (is_nan & (bins == nb - 1)) | \
        (is_zero & (bins == meta.default_bin[:, None]))
    excl = excl & two_scan
    drop = excl | ~valid_bin
    zero = torch.zeros((), dtype=hist.dtype, device=dev)
    # ONE scan along the bin axis of [Q, F, B, 3], which is not the
    # innermost axis: each (leaf, feature, channel) column is then summed
    # in bin order, serially (one thread per column on a card, a serial
    # loop on the CPU), so a histogram's prefix sums are the same bits at
    # any Q.  A scan along the innermost axis on a card picks its threads
    # per row from the number of rows, and its sums then differ with Q.
    p = torch.cumsum(torch.where(drop[None, :, :, None], zero, hist), dim=2)
    pg, ph, pc = p[..., 0], p[..., 1], p[..., 2]

    eps = K_EPSILON
    sg = sum_g[:, None, None]
    th = total_h[:, None, None]
    nd = num_data[:, None, None]
    # dir = +1: left(t) = scanned prefix; missing mass implicitly right
    lg1, lh1, lc1 = pg, ph + eps, pc
    rg1, rh1, rc1 = sg - lg1, th - lh1, nd - lc1
    # dir = -1: right(t) = scanned suffix; missing mass implicitly left
    sg_tot, sh_tot, sc_tot = pg[:, :, -1:], ph[:, :, -1:], pc[:, :, -1:]
    rg2, rh2, rc2 = sg_tot - pg, (sh_tot - ph) + eps, sc_tot - pc
    lg2, lh2, lc2 = sg - rg2, th - rh2, nd - rc2

    # candidate thresholds: t <= num_bin-2, not the zero-skip bin, real feature
    tmask = (bins <= nb - 2) & valid_bin
    tmask &= ~(is_zero & (bins == meta.default_bin[:, None]) & two_scan)
    tmask &= (~meta.is_trivial & ~meta.is_categorical & feature_mask)[:, None]

    def direction(lg, lh, lc, rg, rh, rc, extra_mask):
        ok = (tmask & extra_mask
              & (lc >= min_data_in_leaf) & (rc >= min_data_in_leaf)
              & (lh >= min_sum_hessian_in_leaf)
              & (rh >= min_sum_hessian_in_leaf))
        lo = leaf_output(lg, lh, l1, l2, max_delta_step)
        ro = leaf_output(rg, rh, l1, l2, max_delta_step)
        sgl = threshold_l1(lg, l1)
        sgr = threshold_l1(rg, l1)
        gain = -(2.0 * sgl * lo + (lh + l2) * lo * lo) \
            - (2.0 * sgr * ro + (rh + l2) * ro * ro)
        return torch.where(ok, gain, torch.full_like(gain, K_MIN_SCORE))

    gain_shift = _leaf_split_gain(sum_g, total_h, l1, l2, max_delta_step)
    min_gain_shift = (gain_shift + min_gain_to_split)[:, None, None, None]

    gain2 = direction(lg2, lh2, lc2, rg2, rh2, rc2,
                      torch.ones_like(tmask))             # dir -1 always runs
    gain1 = direction(lg1, lh1, lc1, rg1, rh1, rc1, two_scan)
    gains = torch.stack([gain2, gain1], dim=2)            # [Q, F, 2, B]
    # shift by the no-split gain, then penalize (reference order)
    gains = torch.where(gains > min_gain_shift,
                        (gains - min_gain_shift)
                        * meta.penalty[None, :, None, None],
                        torch.full_like(gains, K_MIN_SCORE))
    lgs = torch.stack([lg2, lg1], dim=2)
    lhs = torch.stack([lh2, lh1], dim=2)
    lcs = torch.stack([lc2, lc1], dim=2)
    return gains, (lgs, lhs, lcs)


def dequantize_hist(hist: torch.Tensor, gscale, hscale) -> torch.Tensor:
    """f32 view of an integer quantized-gradient histogram
    (lightgbm_tpu/ops/split.py dequantize_hist, bit for bit).

    Histograms of the quantized mode accumulate int32 (exact and
    order-free, so subtraction siblings are exact); the f32 view is taken
    only here, just before the split search, so the gain arithmetic is
    the f32 code unchanged.  `hist` is [..., 3] with channels (sum of
    quantized grad, sum of quantized hess, count); gscale / hscale are the
    scales of ops.quantize.quantize_pair (counts are never scaled)."""
    dev = hist.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())

    # a filled device scalar: a host-to-device copy would wait for the
    # stream
    one = torch.ones((), dtype=torch.float32, device=dev)
    scale = torch.stack([f32(gscale), f32(hscale), one])
    return hist.to(torch.float32) * scale


def find_best_split_batched(hist, sum_g, sum_h, num_data, feature_mask, *,
                            meta: FeatureMeta, l1, l2, max_delta_step,
                            min_data_in_leaf, min_sum_hessian_in_leaf,
                            min_gain_to_split,
                            with_categorical: bool = False) -> SplitResult:
    """Best split for each of Q leaves.

    hist: [Q, F, B, 3] f32; sum_g / sum_h / num_data: [Q] leaf totals;
    feature_mask: [F] bool.  Every field of the result carries the [Q]
    axis.  Regularization scalars are Python floats."""
    if with_categorical:
        raise NotImplementedError(
            "categorical split search is not ported yet")
    Q, F, B, _ = hist.shape
    eps = K_EPSILON
    total_h = sum_h + 2 * eps
    gains, (lgs, lhs, lcs) = _numerical_gain_tensor(
        hist, sum_g, total_h, num_data, feature_mask, meta=meta,
        l1=l1, l2=l2, max_delta_step=max_delta_step,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        min_gain_to_split=min_gain_to_split)

    flat = gains.reshape(Q, -1)
    idx = torch.argmax(flat, dim=1)           # first maximum, like jnp.argmax
    q = torch.arange(Q, device=hist.device)
    best_gain = flat[q, idx]
    f = idx // (2 * B)
    d = (idx // B) % 2
    t = idx % B

    # default_left = (dir == -1), except the 2-bin NaN fallback forces right
    force_right = (meta.num_bin[f] <= 2) & (meta.missing_type[f] == MISSING_NAN)
    default_left = (d == 0) & ~force_right

    left_g = lgs[q, f, d, t]
    left_h = lhs[q, f, d, t]   # includes the kEpsilon seed
    left_c = lcs[q, f, d, t]
    right_g = sum_g - left_g
    right_h = total_h - left_h
    lo = leaf_output(left_g, left_h, l1, l2, max_delta_step)
    ro = leaf_output(right_g, right_h, l1, l2, max_delta_step)
    return SplitResult(
        gain=best_gain,
        feature=f.to(torch.int32),
        threshold_bin=t.to(torch.int32),
        default_left=default_left,
        left_sum_g=left_g, left_sum_h=left_h - eps, left_count=left_c,
        is_cat=torch.zeros(Q, dtype=torch.bool, device=hist.device),
        cat_bitset=torch.zeros((Q, B), dtype=torch.bool, device=hist.device),
        left_output=lo, right_output=ro)


def find_best_split(hist, sum_g, sum_h, num_data, feature_mask, *,
                    meta: FeatureMeta, **kwargs) -> SplitResult:
    """Best split for one leaf: hist [F, B, 3], scalar totals.  The Q = 1
    case of `find_best_split_batched`, so it shares every operation."""
    dev = hist.device

    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1)

    res = find_best_split_batched(hist[None], vec(sum_g), vec(sum_h),
                                  vec(num_data), feature_mask, meta=meta,
                                  **kwargs)
    return SplitResult(*[a[0] for a in res])
