"""Exclusive Feature Bundling (EFB).

Role parity with the reference's bundling pipeline
(src/io/dataset.cpp:66-210 FindGroups/FastFeatureBundling,
include/LightGBM/feature_group.h:18): sparse features that are rarely
non-default on the same row are packed into one storage column with
disjoint bin ranges, shrinking both the histogram work and the bin matrix
by the bundle ratio.  The split layer still sees ORIGINAL features — a
bundle's histogram is expanded to per-feature views by static gathers
(ops/bundle.py), mirroring how the reference's FeatureHistogram points
into its group histogram at a bin offset.

Encoding (one uint8/16 value per row per bundle):
  0                     -> every member at its default (zero) bin
  off_f + b - (b > d_f) -> member f at non-default bin b   (d_f skipped)
Singleton bundles keep their feature's raw bins (identity encoding), so
dense features cost nothing.  Rows where two members collide keep the
later-written member — bounded by the conflict budget, the same
approximation the reference accepts (max_conflict_rate).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..utils.log import Log


class BundleInfo(NamedTuple):
    """Host-side bundle description attached to a BinnedDataset."""
    groups: List[List[int]]      # member feature ids per bundle
    f_group: np.ndarray          # [F] i32 bundle id of each feature
    f_offset: np.ndarray         # [F] i32 bin offset inside the bundle
    f_identity: np.ndarray       # [F] bool raw-bin passthrough (singleton)
    group_num_bin: np.ndarray    # [G] i32 total bins of each bundle
    max_group_bin: int
    #: [G] realized full-data conflict rate per bundle (0 for singletons);
    #: None when the layout was built without counting (validation reuse,
    #: caches saved before the field existed)
    conflict_rates: Optional[np.ndarray] = None


def find_bundles(nonzero: List[np.ndarray], num_rows: int,
                 num_bins: Sequence[int], default_bins: Sequence[int],
                 bundleable: Sequence[bool], *, max_conflict_rate: float,
                 max_bundle_bins: int, rng: np.random.Generator):
    """Greedy conflict-bounded grouping (reference FindGroups,
    src/io/dataset.cpp:66-153).

    nonzero: per-feature sorted row indices with a non-default bin (on the
    bundling sample).  Features are visited in random order like the
    reference (it shuffles feature order before grouping); each tries every
    existing bundle and joins the first whose accumulated conflict count
    and bin budget both fit.
    """
    F = len(nonzero)
    max_conflicts = int(max_conflict_rate * num_rows)
    order = [f for f in rng.permutation(F) if bundleable[f]]

    groups: List[List[int]] = []
    # each bundle's rows with a non-default member, as a [num_rows] mask:
    # a feature's conflicts with it are a gather of the mask at the
    # feature's rows (the JAX package intersects sorted row lists; the
    # counts, and so the bundles, are the same)
    group_rows: List[np.ndarray] = []
    group_conflicts: List[int] = []
    group_bins: List[int] = []            # 1 + sum(nb_f - 1) so far

    for f in order:
        rows_f = nonzero[f]
        extra_bins = int(num_bins[f]) - 1
        placed = False
        for gi in range(len(groups)):
            if group_bins[gi] + extra_bins > max_bundle_bins:
                continue
            cnt = int(np.count_nonzero(group_rows[gi][rows_f]))
            if group_conflicts[gi] + cnt <= max_conflicts:
                groups[gi].append(f)
                group_rows[gi][rows_f] = True
                group_conflicts[gi] += cnt
                group_bins[gi] += extra_bins
                placed = True
                break
        if not placed:
            mask = np.zeros(num_rows, bool)
            mask[rows_f] = True
            groups.append([f])
            group_rows.append(mask)
            group_conflicts.append(0)
            group_bins.append(1 + extra_bins)
    return groups


def realized_conflict_rates(bins: np.ndarray, info: BundleInfo,
                            default_bins: Sequence[int]) -> np.ndarray:
    """Per-bundle fraction of rows where two or more members are
    non-default on the FULL data (the rows whose later-written member
    overwrote another).  The reference bounds this on the bundling sample
    (dataset.cpp:66-153, max_conflict_rate); reporting the realized rate
    tells the user how lossy their bundling actually was."""
    N = bins.shape[1]
    rates = np.zeros(len(info.groups), np.float64)
    for gi, feats in enumerate(info.groups):
        if len(feats) <= 1:
            continue
        nd = np.zeros(N, np.int32)
        for f in feats:
            nd += bins[f] != default_bins[f]
        rates[gi] = float(np.count_nonzero(nd > 1)) / max(N, 1)
    return rates


def apply_bundles(bins: np.ndarray, info: BundleInfo,
                  num_bins: Sequence[int],
                  default_bins: Sequence[int],
                  count_conflicts: bool = False):
    """Re-encode a binned matrix with an EXISTING bundle layout (validation
    sets reuse the training dataset's bundling, Dataset::CreateValid).
    With count_conflicts, also returns the per-bundle realized conflict
    rates (reusing the member non-default masks this pass computes
    anyway)."""
    G = len(info.groups)
    N = bins.shape[1]
    dtype = np.uint8 if info.max_group_bin <= 256 else np.uint16
    bundled = np.zeros((G, N), dtype)
    rates = np.zeros(G, np.float64) if count_conflicts else None
    for gi, feats in enumerate(info.groups):
        if len(feats) == 1 and info.f_identity[feats[0]]:
            bundled[gi] = bins[feats[0]].astype(dtype)
            continue
        nd_count = np.zeros(N, np.int32) if count_conflicts else None
        for f in feats:
            b = bins[f].astype(np.int32)
            d = int(default_bins[f])
            nd = b != d
            if count_conflicts:
                nd_count += nd
            enc = info.f_offset[f] + b - (b > d)
            bundled[gi, nd] = enc[nd].astype(dtype)
        if count_conflicts:
            rates[gi] = float(np.count_nonzero(nd_count > 1)) / max(N, 1)
    return (bundled, rates) if count_conflicts else bundled


def bundle_features(bins: np.ndarray, num_bins: Sequence[int],
                    default_bins: Sequence[int], bundleable: Sequence[bool],
                    num_data: int, *, max_conflict_rate: float = 0.0,
                    max_bundle_bins: int = 255,
                    sample_cnt: int = 200000,
                    seed: int = 1) -> Optional[tuple]:
    """Bundle the binned matrix.  Returns (bundled_bins [G, N], BundleInfo)
    or None when bundling would not help (fewer than 2 bundleable sparse
    features, or no bundle gained a second member)."""
    F, N = bins.shape
    rng = np.random.default_rng(seed)
    sample_n = min(num_data, sample_cnt)
    sample = (np.sort(rng.choice(num_data, sample_n, replace=False))
              if sample_n < num_data else np.arange(num_data))

    nonzero = []
    for f in range(F):
        col = bins[f, sample]
        nonzero.append(np.flatnonzero(col != default_bins[f]).astype(np.int64))

    groups = find_bundles(nonzero, sample_n, num_bins, default_bins,
                          bundleable, max_conflict_rate=max_conflict_rate,
                          max_bundle_bins=max_bundle_bins, rng=rng)
    # features the grouping skipped (non-bundleable) become singletons
    grouped = {f for g in groups for f in g}
    for f in range(F):
        if f not in grouped:
            groups.append([f])
    if not any(len(g) > 1 for g in groups):
        return None
    # deterministic layout: order bundles by smallest member id
    groups.sort(key=lambda g: min(g))

    G = len(groups)
    f_group = np.zeros(F, np.int32)
    f_offset = np.zeros(F, np.int32)
    f_identity = np.zeros(F, bool)
    group_num_bin = np.zeros(G, np.int32)
    for gi, feats in enumerate(groups):
        if len(feats) == 1:
            f = feats[0]
            f_group[f] = gi
            f_identity[f] = True
            group_num_bin[gi] = num_bins[f]
            continue
        off = 1
        for f in sorted(feats):
            f_group[f] = gi
            f_offset[f] = off
            off += int(num_bins[f]) - 1
        group_num_bin[gi] = off
    groups = [sorted(g) for g in groups]

    info = BundleInfo(groups=groups, f_group=f_group, f_offset=f_offset,
                      f_identity=f_identity, group_num_bin=group_num_bin,
                      max_group_bin=int(group_num_bin.max()))
    bundled, rates = apply_bundles(bins, info, num_bins, default_bins,
                                   count_conflicts=True)
    # the encode pass covers padded rows (all-default, conflict-free);
    # report rates over the real rows
    rates = rates * (N / max(num_data, 1))

    n_multi = sum(1 for g in groups if len(g) > 1)
    info = info._replace(conflict_rates=rates)
    Log.info("EFB: bundled %d features into %d columns "
             "(%d multi-feature bundles, max %d bins); realized conflict "
             "rate on full data: max %.4f, mean %.4f",
             F, G, n_multi, int(group_num_bin.max()),
             float(rates.max()) if len(rates) else 0.0,
             float(rates.mean()) if len(rates) else 0.0)
    if len(rates) and rates.max() > max(max_conflict_rate, 1e-12):
        Log.warning("EFB: realized conflict rate %.4f exceeds the "
                    "max_conflict_rate budget %.4f (the budget is enforced "
                    "on the bundling sample); colliding rows keep the "
                    "later-written member's bin", float(rates.max()),
                    max_conflict_rate)
    return bundled, info
