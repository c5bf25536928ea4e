"""Best-split search over histograms as vectorized prefix scans.

Counterpart of lightgbm_tpu/ops/split.py: the same two scan directions,
missing-value routing, kEpsilon hessian seeding, gain and leaf-output
formulas, in the same order of operations so the CPU results agree with
the JAX package to the last few ulps; and, with `with_categorical`, its
categorical search (`_categorical_best`: one-hot and sorted-subset
modes, feature_histogram.hpp:112-273).

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

Monotone constraints (static `monotone`, with per-leaf output bounds)
clip the candidates' outputs, take the gain at the clipped outputs and
zero the gain of a candidate against its feature's direction;
`evaluate_split_at` scores a forced (feature, threshold) per leaf.
Without constraints the search runs operation for operation as before.
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
    is_cat: torch.Tensor         # bool: a categorical subset split
    cat_bitset: torch.Tensor     # [..., B] bool: bins routed left
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
                           min_sum_hessian_in_leaf, min_gain_to_split,
                           monotone: bool = False, min_constraint=None,
                           max_constraint=None,
                           apply_min_gain_filter: bool = True):
    """Shifted and penalized gains [Q, F, 2, B] (direction -1 first), the
    stacked left-side aggregates and min_gain_shift [Q].  hist is
    [Q, F, B, 3]; sum_g, total_h and num_data are [Q]; the meta fields
    and feature_mask are [F], or [Q, F] where each leaf has its own
    features (the forced evaluation).

    monotone (static): candidates whose outputs break their feature's
    monotone direction gain 0, after the outputs are clipped to the
    leaf's [min_constraint, max_constraint] ([Q] each, or None), as the
    JAX package's _numerical_gain_tensor does (LeafSplits constraints,
    feature_histogram.hpp:478-489).  Without it no operation is added.
    apply_min_gain_filter False (the forced evaluation) keeps a split
    below min_gain_shift instead of rejecting it."""
    B = hist.shape[2]
    dev = hist.device
    bins = torch.arange(B, dtype=torch.int32, device=dev)[None, :]   # [1, B]
    nb = meta.num_bin[..., None]                                      # [.., F, 1]
    valid_bin = bins < nb

    is_nan = (meta.missing_type == MISSING_NAN)[..., None]
    is_zero = (meta.missing_type == MISSING_ZERO)[..., None]
    two_scan = ((meta.num_bin > 2)
                & (meta.missing_type != MISSING_NONE))[..., None]

    # mass excluded from the scanned prefix: it follows the default direction
    excl = (is_nan & (bins == nb - 1)) | \
        (is_zero & (bins == meta.default_bin[..., None]))
    excl = excl & two_scan
    drop = excl | ~valid_bin
    zero = torch.zeros((), dtype=hist.dtype, device=dev)
    # ONE scan along the bin axis of [Q, F, B, 3], which is not the
    # innermost axis: each (leaf, feature, channel) column is then summed
    # in bin order, serially (one thread per column on a card, a serial
    # loop on the CPU), so a histogram's prefix sums are the same bits at
    # any Q.  A scan along the innermost axis on a card picks its threads
    # per row from the number of rows, and its sums then differ with Q.
    p = torch.cumsum(torch.where(drop[..., None], zero, hist), dim=2)
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
    tmask &= ~(is_zero & (bins == meta.default_bin[..., None]) & two_scan)
    tmask &= (~meta.is_trivial & ~meta.is_categorical
              & feature_mask)[..., None]
    if min_constraint is not None:
        cmin = min_constraint[:, None, None]
        cmax = max_constraint[:, None, None]
    mono = meta.monotone[..., None]

    def direction(lg, lh, lc, rg, rh, rc, extra_mask):
        ok = (tmask & extra_mask
              & (lc >= min_data_in_leaf) & (rc >= min_data_in_leaf)
              & (lh >= min_sum_hessian_in_leaf)
              & (rh >= min_sum_hessian_in_leaf))
        lo = leaf_output(lg, lh, l1, l2, max_delta_step)
        ro = leaf_output(rg, rh, l1, l2, max_delta_step)
        if min_constraint is not None:
            # the gain is taken AT the clipped outputs, which is what
            # keeps monotonicity through whole subtrees
            lo = torch.clamp(lo, cmin, cmax)
            ro = torch.clamp(ro, cmin, cmax)
        sgl = threshold_l1(lg, l1)
        sgr = threshold_l1(rg, l1)
        gain = -(2.0 * sgl * lo + (lh + l2) * lo * lo) \
            - (2.0 * sgr * ro + (rh + l2) * ro * ro)
        if monotone:
            mono_bad = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
            gain = torch.where(mono_bad, torch.zeros_like(gain), gain)
        return torch.where(ok, gain, torch.full_like(gain, K_MIN_SCORE))

    gain_shift = _leaf_split_gain(sum_g, total_h, l1, l2, max_delta_step)
    min_gain_shift = gain_shift + min_gain_to_split
    mgs = min_gain_shift[:, None, None, None]

    gain2 = direction(lg2, lh2, lc2, rg2, rh2, rc2,
                      torch.ones_like(tmask))             # dir -1 always runs
    gain1 = direction(lg1, lh1, lc1, rg1, rh1, rc1, two_scan)
    gains = torch.stack([gain2, gain1], dim=2)            # [Q, F, 2, B]
    # shift by the no-split gain, then penalize (reference order)
    penalty = meta.penalty[..., None, None]
    if apply_min_gain_filter:
        gains = torch.where(gains > mgs, (gains - mgs) * penalty,
                            torch.full_like(gains, K_MIN_SCORE))
    else:
        # the forced evaluation: the constraint masks (already -inf)
        # still hold, but a split below min_gain_shift is kept
        gains = (gains - mgs) * penalty
    lgs = torch.stack([lg2, lg1], dim=2)
    lhs = torch.stack([lh2, lh1], dim=2)
    lcs = torch.stack([lc2, lc1], dim=2)
    return gains, (lgs, lhs, lcs), min_gain_shift


def _categorical_best(g, h, c, sum_g, sum_h, num_data, cat_mask, *, meta,
                      l1, l2, max_delta_step, min_data_in_leaf,
                      min_sum_hessian_in_leaf, max_cat_threshold, cat_l2,
                      cat_smooth, max_cat_to_onehot, min_data_per_group):
    """Best categorical split per leaf and feature
    (FindBestThresholdCategorical, feature_histogram.hpp:112-273; the JAX
    package's _categorical_best over a leading [Q] axis).

    g, h, c: [Q, F, B]; sum_g, sum_h (with its 2 kEpsilon), num_data: [Q];
    cat_mask: [F].  One-hot mode (num_bin <= max_cat_to_onehot) scans
    single-bin lefts.  Sorted-subset mode sorts the bins by
    g / (h + cat_smooth), stably (equal ratios keep bin order, as
    jnp.argsort does), and walks prefixes from both ends at once (the two
    directions stacked on a leading axis) with the reference's
    min_data_per_group grouping and its break on a starved right side.
    The walk runs min(B, max_cat_threshold) steps: the JAX scan runs B,
    but a step at i >= max_cat <= max_cat_threshold changes nothing.

    Returns raw_gain [Q, F], bitset [Q, F, B], the left side's g,
    h (+ kEpsilon) and count [Q, F], and used_sorted [F]."""
    Q, F, B = g.shape
    dev = g.device
    eps = K_EPSILON
    bins = torch.arange(B, dtype=torch.int64, device=dev)
    sg = sum_g[:, None, None]
    sh = sum_h[:, None, None]
    nd = num_data[:, None, None]
    # used_bin = num_bin - 1 + (missing_type == None) (:125-126)
    used_bin = (meta.num_bin - 1
                + (meta.missing_type == MISSING_NONE).to(torch.int32))
    valid_t = (bins[None, :] < used_bin[:, None]) & cat_mask[:, None]

    def pair_gain(lg, lh, rg, rh, l2_eff):
        return _leaf_split_gain(lg, lh, l1, l2_eff, max_delta_step) + \
            _leaf_split_gain(rg, rh, l1, l2_eff, max_delta_step)

    def pick(t, i):
        return torch.gather(t, 2, i[..., None])[..., 0]

    # ---- one-hot: left = the single bin t --------------------------------
    other_g = sg - g
    other_h = sh - h - eps
    other_c = nd - c
    ok_oh = valid_t & (c >= min_data_in_leaf) \
        & (h >= min_sum_hessian_in_leaf) & (other_c >= min_data_in_leaf) \
        & (other_h >= min_sum_hessian_in_leaf)
    gain_oh = pair_gain(g, h + eps, other_g, other_h, l2)
    gain_oh = torch.where(ok_oh, gain_oh, torch.full_like(gain_oh,
                                                          K_MIN_SCORE))
    t_oh = torch.argmax(gain_oh, dim=2)                         # [Q, F]
    best_oh = pick(gain_oh, t_oh)

    # ---- sorted subset ----------------------------------------------------
    keep = valid_t & (c >= cat_smooth)
    ctr = g / (h + cat_smooth)
    ctr = torch.where(keep, ctr, torch.full_like(ctr, float("inf")))
    order = torch.argsort(ctr, dim=2, stable=True)              # [Q, F, B]
    used = keep.sum(dim=2)                                      # [Q, F]
    max_cat = torch.clamp((used + 1) // 2, max=max_cat_threshold)
    l2s = l2 + cat_l2
    slot_valid = bins < used[..., None]
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    sorted_ghc = [torch.where(slot_valid, torch.gather(t, 2, order), zero)
                  for t in (g, h, c)]
    # direction -1 walks the sorted bins from the top (position used-1-i)
    top = torch.clamp(used[..., None] - 1 - bins, 0, B - 1)
    gd, hd, cd = [torch.stack([t, torch.gather(t, 2, top)])
                  for t in sorted_ghc]                          # [2, Q, F, B]

    def zeros():
        return torch.zeros((2, Q, F), dtype=g.dtype, device=dev)

    lg, lc, grp = zeros(), zeros(), zeros()
    lh = torch.full((2, Q, F), eps, dtype=g.dtype, device=dev)
    stopped = torch.zeros((2, Q, F), dtype=torch.bool, device=dev)
    bg = torch.full((2, Q, F), K_MIN_SCORE, dtype=g.dtype, device=dev)
    bi = torch.full((2, Q, F), -1, dtype=torch.int64, device=dev)
    blg, blh, blc = zeros(), zeros(), zeros()
    for i in range(min(B, int(max_cat_threshold))):
        stepping = (i < used) & (i < max_cat)
        lg = torch.where(stepping, lg + gd[..., i], lg)
        lh = torch.where(stepping, lh + hd[..., i], lh)
        lc = torch.where(stepping, lc + cd[..., i], lc)
        grp = torch.where(stepping, grp + cd[..., i], grp)
        cont1 = (lc < min_data_in_leaf) | (lh < min_sum_hessian_in_leaf)
        rc = nd[..., 0] - lc
        rh = sh[..., 0] - lh
        brk = (rc < min_data_in_leaf) | (rc < min_data_per_group) | \
            (rh < min_sum_hessian_in_leaf)
        # the break is only evaluated when the left side qualifies (the
        # reference `continue`s before its break checks, :205-212)
        candidate = stepping & ~stopped & ~cont1 & ~brk & \
            (grp >= min_data_per_group)
        stopped = stopped | (stepping & ~cont1 & brk)
        grp = torch.where(candidate, zero, grp)
        gain_i = pair_gain(lg, lh, sg[..., 0] - lg, rh, l2s)
        take = candidate & (gain_i > bg)
        bg = torch.where(take, gain_i, bg)
        bi = torch.where(take, i, bi)
        blg = torch.where(take, lg, blg)
        blh = torch.where(take, lh, blh)
        blc = torch.where(take, lc, blc)

    use2 = bg[1] > bg[0]

    def best_dir(t):
        return torch.where(use2, t[1], t[0])

    bg_s, bi_s = best_dir(bg), best_dir(bi)
    # the bitset: the first bi+1 sorted bins (direction +1) or the last
    # bi+1 (direction -1) go left; rank (the position of each bin) is the
    # inverse of order, by scatter
    rank = torch.empty_like(order).scatter_(2, order,
                                            bins.expand(Q, F, B))
    rank_dir = torch.where(use2[..., None], used[..., None] - 1 - rank, rank)
    bitset_s = keep & (rank_dir <= bi_s[..., None]) & (rank_dir >= 0)

    # ---- one-hot or sorted, per feature ------------------------------------
    use_onehot = meta.num_bin <= max_cat_to_onehot             # [F]
    raw_gain = torch.where(use_onehot, best_oh, bg_s)
    bitset = torch.where(use_onehot[:, None], bins == t_oh[..., None],
                         bitset_s)
    lg = torch.where(use_onehot, pick(g, t_oh), best_dir(blg))
    lh = torch.where(use_onehot, pick(h, t_oh) + eps, best_dir(blh))
    lc = torch.where(use_onehot, pick(c, t_oh), best_dir(blc))
    return raw_gain, bitset, lg, lh, lc, ~use_onehot


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
                            min_gain_to_split, max_cat_threshold=32,
                            cat_l2=10.0, cat_smooth=10.0, max_cat_to_onehot=4,
                            min_data_per_group=100,
                            with_categorical: bool = False,
                            monotone: bool = False, min_constraint=None,
                            max_constraint=None) -> SplitResult:
    """Best split for each of Q leaves.

    hist: [Q, F, B, 3] f32; sum_g / sum_h / num_data: [Q] leaf totals;
    feature_mask: [F] bool.  Every field of the result carries the [Q]
    axis.  Regularization scalars are Python floats.  with_categorical
    (static) adds the categorical search; without it the numerical search
    runs alone, unchanged.

    monotone (static) with min_constraint / max_constraint ([Q] f32
    bounds of each leaf's output, or None): the constrained search of the
    JAX package's find_best_split; a numerical winner's outputs are
    clipped to the bounds, a categorical winner's are not (as in the JAX
    package and feature_histogram.hpp:345-351).  Without them the search
    runs unchanged, operation for operation."""
    Q, F, B, _ = hist.shape
    eps = K_EPSILON
    total_h = sum_h + 2 * eps
    gains, (lgs, lhs, lcs), min_gain_shift = _numerical_gain_tensor(
        hist, sum_g, total_h, num_data, feature_mask, meta=meta,
        l1=l1, l2=l2, max_delta_step=max_delta_step,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        min_gain_to_split=min_gain_to_split, monotone=monotone,
        min_constraint=min_constraint, max_constraint=max_constraint)

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
    dev = hist.device
    is_cat = torch.zeros(Q, dtype=torch.bool, device=dev)
    cat_bitset = torch.zeros((Q, B), dtype=torch.bool, device=dev)
    l2_eff = l2

    if with_categorical:
        cat_mask = meta.is_categorical & ~meta.is_trivial & feature_mask
        raw_cat, bitset_cat, clg, clh, clc, sorted_mode = _categorical_best(
            hist[..., 0], hist[..., 1], hist[..., 2], sum_g, total_h,
            num_data, cat_mask, meta=meta, l1=l1, l2=l2,
            max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
            min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
            max_cat_threshold=max_cat_threshold, cat_l2=cat_l2,
            cat_smooth=cat_smooth, max_cat_to_onehot=max_cat_to_onehot,
            min_data_per_group=min_data_per_group)
        mgs = min_gain_shift[:, None]
        gain_cat = torch.where(raw_cat > mgs,
                               (raw_cat - mgs) * meta.penalty[None, :],
                               torch.full_like(raw_cat, K_MIN_SCORE))
        fc = torch.argmax(gain_cat, dim=1)
        best_cat = gain_cat[q, fc]
        cat_wins = best_cat > best_gain
        best_gain = torch.where(cat_wins, best_cat, best_gain)
        f = torch.where(cat_wins, fc, f)
        t = torch.where(cat_wins, 0, t)
        default_left = default_left & ~cat_wins
        left_g = torch.where(cat_wins, clg[q, fc], left_g)
        left_h = torch.where(cat_wins, clh[q, fc], left_h)
        left_c = torch.where(cat_wins, clc[q, fc], left_c)
        is_cat = cat_wins
        cat_bitset = bitset_cat[q, fc] & cat_wins[:, None]
        # sorted-subset splits regularize their children's outputs with
        # l2 + cat_l2 (fills, which a CUDA graph can hold)
        f32 = dict(dtype=torch.float32, device=dev)
        l2_eff = torch.where(cat_wins & sorted_mode[fc],
                             torch.full((), l2 + cat_l2, **f32),
                             torch.full((), l2, **f32))

    right_g = sum_g - left_g
    right_h = total_h - left_h
    lo = leaf_output(left_g, left_h, l1, l2_eff, max_delta_step)
    ro = leaf_output(right_g, right_h, l1, l2_eff, max_delta_step)
    if min_constraint is not None:
        lo = torch.where(is_cat, lo,
                         torch.clamp(lo, min_constraint, max_constraint))
        ro = torch.where(is_cat, ro,
                         torch.clamp(ro, min_constraint, max_constraint))
    return SplitResult(
        gain=best_gain,
        feature=f.to(torch.int32),
        threshold_bin=t.to(torch.int32),
        default_left=default_left,
        left_sum_g=left_g, left_sum_h=left_h - eps, left_count=left_c,
        is_cat=is_cat, cat_bitset=cat_bitset,
        left_output=lo, right_output=ro)


def find_best_split(hist, sum_g, sum_h, num_data, feature_mask, *,
                    meta: FeatureMeta, **kwargs) -> SplitResult:
    """Best split for one leaf: hist [F, B, 3], scalar totals.  The Q = 1
    case of `find_best_split_batched`, so it shares every operation."""
    dev = hist.device

    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1)

    for key in ("min_constraint", "max_constraint"):
        if kwargs.get(key) is not None:
            kwargs[key] = vec(kwargs[key])
    res = find_best_split_batched(hist[None], vec(sum_g), vec(sum_h),
                                  vec(num_data), feature_mask, meta=meta,
                                  **kwargs)
    return SplitResult(*[a[0] for a in res])


def evaluate_split_at(hist, sum_g, sum_h, num_data, feature, threshold_bin,
                      *, meta: FeatureMeta, l1, l2, max_delta_step,
                      min_data_in_leaf, min_sum_hessian_in_leaf,
                      monotone: bool = False, min_constraint=None,
                      max_constraint=None) -> SplitResult:
    """The split of each of Q leaves at a GIVEN numerical (feature,
    threshold_bin) ([Q] each): a forced split (the JAX package's
    evaluate_split_at; ForceSplits, serial_tree_learner.cpp:546-701).
    The threshold is imposed, the missing values' default direction is
    still chosen by gain, and min_data / min_sum_hessian still hold: an
    infeasible split comes back with gain -inf, so the caller falls back
    on the leaf's own best.  hist is [Q, F, B, 3]; only the forced
    feature's [B] slice of each leaf is scanned."""
    Q, B = hist.shape[0], hist.shape[2]
    dev = hist.device
    eps = K_EPSILON
    q = torch.arange(Q, device=dev)
    f = feature.long()
    t = threshold_bin.long()
    total_h = sum_h + 2 * eps
    meta1 = FeatureMeta(*[a[f][:, None] for a in meta])      # [Q, 1]
    gains, (lgs, lhs, lcs), _ = _numerical_gain_tensor(
        hist[q, f][:, None], sum_g, total_h, num_data,
        torch.ones((Q, 1), dtype=torch.bool, device=dev), meta=meta1,
        l1=l1, l2=l2, max_delta_step=max_delta_step,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        min_gain_to_split=0.0, monotone=monotone,
        min_constraint=min_constraint, max_constraint=max_constraint,
        apply_min_gain_filter=False)
    pair = gains[q, 0, :, t]                        # [Q, 2], dir -1 first
    d = torch.argmax(pair, dim=1)
    gain = pair[q, d]
    force_right = (meta1.num_bin[:, 0] <= 2) & \
        (meta1.missing_type[:, 0] == MISSING_NAN)
    default_left = (d == 0) & ~force_right
    left_g = lgs[q, 0, d, t]
    left_h = lhs[q, 0, d, t]
    left_c = lcs[q, 0, d, t]
    right_g = sum_g - left_g
    right_h = total_h - left_h
    lo = leaf_output(left_g, left_h, l1, l2, max_delta_step)
    ro = leaf_output(right_g, right_h, l1, l2, max_delta_step)
    if min_constraint is not None:
        lo = torch.clamp(lo, min_constraint, max_constraint)
        ro = torch.clamp(ro, min_constraint, max_constraint)
    return SplitResult(
        gain=gain, feature=f.to(torch.int32),
        threshold_bin=t.to(torch.int32), default_left=default_left,
        left_sum_g=left_g, left_sum_h=left_h - eps, left_count=left_c,
        is_cat=torch.zeros(Q, dtype=torch.bool, device=dev),
        cat_bitset=torch.zeros((Q, B), dtype=torch.bool, device=dev),
        left_output=lo, right_output=ro)


def pad_feature_meta(meta: FeatureMeta, f_padded: int) -> FeatureMeta:
    """Per-feature metadata extended by trivial (inert) entries for the
    padded storage columns of the column-owning learners (the JAX
    package's pad_feature_meta)."""
    F = int(meta.num_bin.shape[0])
    pad = f_padded - F
    if pad <= 0:
        return meta

    def ext(a, fill):
        return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                        device=a.device)])

    return FeatureMeta(
        num_bin=ext(meta.num_bin, 1), missing_type=ext(meta.missing_type, 0),
        default_bin=ext(meta.default_bin, 0),
        is_trivial=ext(meta.is_trivial, True),
        is_categorical=ext(meta.is_categorical, False),
        penalty=ext(meta.penalty, 1.0), monotone=ext(meta.monotone, 0))


def owned_first(num_padded: int, f_offset: int, gloc) -> torch.Tensor:
    """The feature learner's payload column layout: the rank that owns
    storage columns [f_offset, f_offset + gloc) of the zero-padded
    num_padded holds them first, then the columns before them, then
    those after.  Returns perm ([num_padded] int64): payload column j
    holds storage column perm[j].  `localize_col` is its inverse."""
    j = torch.arange(num_padded)
    return torch.where(j < gloc, f_offset + j,
                       torch.where(j - gloc < f_offset, j - gloc, j))


def localize_col(g: torch.Tensor, f_offset: int, gloc) -> torch.Tensor:
    """Storage column g -> its payload column in the owned-first layout
    (the JAX grower's localize_col; the inverse of `owned_first`)."""
    return torch.where(g < f_offset, gloc + g,
                       torch.where(g < f_offset + gloc, g - f_offset, g))


def slice_feature_meta(meta: FeatureMeta, idx: torch.Tensor) -> FeatureMeta:
    """The metadata of features `idx` (a [S] index tensor, or a slice)."""
    if isinstance(idx, slice):
        return FeatureMeta(*[a[idx] for a in meta])
    return FeatureMeta(*[a.index_select(0, idx.long()) for a in meta])


def per_feature_best_gains(hist, sum_g, sum_h, num_data, feature_mask, *,
                           meta: FeatureMeta, l1, l2, max_delta_step,
                           min_data_in_leaf, min_sum_hessian_in_leaf,
                           min_gain_to_split, max_cat_threshold=32,
                           cat_l2=10.0, cat_smooth=10.0, max_cat_to_onehot=4,
                           min_data_per_group=100,
                           with_categorical: bool = False,
                           **_unused) -> torch.Tensor:
    """Best gain per leaf and feature, [Q, F]: the vote statistic of the
    voting learner (voting_parallel_tree_learner.cpp's local
    FindBestSplits; the JAX package's per_feature_best_gains, ops/split.py
    :213, over a leading [Q] axis).  hist [Q, F, B, 3]; totals [Q]."""
    total_h = sum_h + 2 * K_EPSILON
    gains, _, min_gain_shift = _numerical_gain_tensor(
        hist, sum_g, total_h, num_data, feature_mask, meta=meta, l1=l1,
        l2=l2, max_delta_step=max_delta_step,
        min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
        min_gain_to_split=min_gain_to_split)
    best = gains.amax(dim=(2, 3))
    if with_categorical:
        cat_mask = meta.is_categorical & ~meta.is_trivial & feature_mask
        raw_cat = _categorical_best(
            hist[..., 0], hist[..., 1], hist[..., 2], sum_g, total_h,
            num_data, cat_mask, meta=meta, l1=l1, l2=l2,
            max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
            min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
            max_cat_threshold=max_cat_threshold, cat_l2=cat_l2,
            cat_smooth=cat_smooth, max_cat_to_onehot=max_cat_to_onehot,
            min_data_per_group=min_data_per_group)[0]
        mgs = min_gain_shift[:, None]
        gain_cat = torch.where(raw_cat > mgs,
                               (raw_cat - mgs) * meta.penalty[None, :],
                               torch.full_like(raw_cat, K_MIN_SCORE))
        best = torch.maximum(best, gain_cat)
    return best


#: the scalar fields of a SplitResult in the winner sync's packed row,
#: in the JAX package's order (grower.py:108-118), the bitset after them
_PACKED = ("gain", "feature", "threshold_bin", "default_left", "left_sum_g",
           "left_sum_h", "left_count", "is_cat", "left_output",
           "right_output")


def pack_split(res: SplitResult, f_offset=0) -> torch.Tensor:
    """[Q, 10 + B] f32: each leaf's SplitResult in one row, its feature
    shifted by `f_offset` (the owned columns' first global column).
    Feature and bin ids are exact in f32 below 2^24."""
    cols = [getattr(res, k).to(torch.float32) for k in _PACKED]
    cols[1] = cols[1] + f_offset
    return torch.cat([torch.stack(cols, dim=1),
                      res.cat_bitset.to(torch.float32)], dim=1)


def unpack_split(rows: torch.Tensor) -> SplitResult:
    """The SplitResult of `pack_split` rows."""
    c = {k: rows[:, i] for i, k in enumerate(_PACKED)}
    return SplitResult(
        gain=c["gain"], feature=c["feature"].to(torch.int32),
        threshold_bin=c["threshold_bin"].to(torch.int32),
        default_left=c["default_left"] > 0, left_sum_g=c["left_sum_g"],
        left_sum_h=c["left_sum_h"], left_count=c["left_count"],
        is_cat=c["is_cat"] > 0, cat_bitset=rows[:, len(_PACKED):] > 0,
        left_output=c["left_output"], right_output=c["right_output"])


def pick_winner(gathered: torch.Tensor) -> torch.Tensor:
    """SyncUpGlobalBestSplit (parallel_tree_learner.h:183-206; the JAX
    package's make_winner_sync): from every rank's packed rows
    ([world, Q, W], in rank order) each leaf's row of the greatest gain,
    ties to the lowest rank (argmax takes the first maximum).  A rank
    whose gain is NaN never wins, as a NaN fails the JAX rule's
    gain == pmax(gain) test."""
    gain = gathered[..., 0]
    gain = torch.where(torch.isnan(gain), torch.full_like(gain, K_MIN_SCORE),
                       gain)
    win = torch.argmax(gain, dim=0)                              # [Q]
    q = torch.arange(gathered.shape[1], device=gathered.device)
    return gathered[win, q]
