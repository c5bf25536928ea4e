"""Binned dataset: the training matrix as a packed integer array in HBM.

Role parity with the reference Dataset/DatasetLoader/Metadata
(include/LightGBM/dataset.h:282-618, src/io/dataset.cpp Construct:212-322,
src/io/dataset_loader.cpp CostructFromSampleData:501+, src/io/metadata.cpp).

Copied from the JAX package (numpy only): instead of per-feature-group Bin
objects with push iterators, the dataset is one [num_features, num_rows]
integer matrix (uint8 for <=256 bins) padded to the row chunk, plus small
per-feature metadata arrays (bin counts, missing types, default bins)
consumed by the split finder.  The binary dataset cache and the native
encoder are not ported; host binning runs the per-feature numpy path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.log import Log
from ..utils.random import Random
from .binning import (BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper)
from .bundling import BundleInfo, bundle_features


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _map_features(fn, num_features: int, config) -> list:
    """[fn(j) for j in range(num_features)], on worker threads when
    is_parallel_find_bin holds and there are more than 8 features
    (num_threads workers, else up to 16)."""
    if bool(getattr(config, "is_parallel_find_bin", True)) \
            and num_features > 8:
        import concurrent.futures as cf
        import os
        nt = int(getattr(config, "num_threads", 0) or 0)
        workers = nt if nt > 0 else min(16, os.cpu_count() or 1)
        with cf.ThreadPoolExecutor(workers) as pool:
            return list(pool.map(fn, range(num_features)))
    return [fn(j) for j in range(num_features)]


class Metadata:
    """Labels / weights / query boundaries / init scores (src/io/metadata.cpp)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            Log.fatal("Length of label is not same with #data")
        self.label = label

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.ascontiguousarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            Log.fatal("Length of weight is not same with #data")
        self.weight = weight

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.ascontiguousarray(init_score, dtype=np.float64)

    def set_query(self, group) -> None:
        if group is None:
            self.query_boundaries = None
            return
        group = np.ascontiguousarray(group, dtype=np.int64).reshape(-1)
        if group.sum() != self.num_data:
            Log.fatal("Sum of query counts is not same with #data")
        self.query_boundaries = np.concatenate([[0], np.cumsum(group)])


class BinnedDataset:
    """Host-side binned training matrix + per-feature metadata."""

    def __init__(self):
        self.num_data = 0
        self.num_total_features = 0
        self.bin_mappers: List[BinMapper] = []
        self.bins: Optional[np.ndarray] = None  # [G, N_pad] uint8/uint16
        self.bundle_info: Optional[BundleInfo] = None  # EFB grouping (G<F)
        self.num_data_padded = 0
        self.max_num_bin = 0
        self.metadata: Optional[Metadata] = None
        self.feature_names: List[str] = []
        self.monotone_constraints: Optional[np.ndarray] = None
        self.feature_penalty: Optional[np.ndarray] = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_matrix(cls, X: np.ndarray, config, *, bin_mappers: Optional[List[BinMapper]] = None,
                    feature_names: Optional[Sequence[str]] = None,
                    categorical_feature: Sequence[int] = (),
                    row_chunk: int = 16384,
                    reference_bundle: Optional[BundleInfo] = None) -> "BinnedDataset":
        """Bin a raw [N, F] float matrix.  When bin_mappers is given (validation
        sets), reuse the training mappers (reference Dataset::CreateValid) and
        the training bundling (reference_bundle)."""
        X = np.asarray(X)
        if X.ndim != 2:
            Log.fatal("Data should be 2 dimensional")
        n, f = X.shape
        ds = cls()
        ds.num_data = n
        ds.num_total_features = f
        ds.feature_names = list(feature_names) if feature_names \
            else ["Column_%d" % i for i in range(f)]

        if bin_mappers is None:
            bin_mappers = cls._find_bin_mappers(X, config, categorical_feature)
        ds.bin_mappers = bin_mappers
        ds.max_num_bin = max((m.num_bin for m in bin_mappers), default=1)

        n_pad = _round_up(n, row_chunk) if n > row_chunk else _round_up(max(n, 1), 128)
        dtype = np.uint8 if ds.max_num_bin <= 256 else np.uint16
        bins = np.zeros((f, n_pad), dtype=dtype)

        def bin_one(j: int) -> None:
            if not bin_mappers[j].is_trivial:
                bins[j, :n] = bin_mappers[j].values_to_bins(
                    X[:, j].astype(np.float64))

        # one feature per task on worker threads (numpy's searchsorted and
        # elementwise passes release the GIL): wide data bins in a fraction
        # of the serial time
        _map_features(bin_one, f, config)

        # Exclusive Feature Bundling (reference dataset.cpp:66-210): pack
        # mutually-exclusive sparse features into shared storage columns.
        # Validation sets reuse the training layout.  Row-sharded parallel
        # learners (data/voting) train bundled on the mesh fast path;
        # feature-parallel keeps unbundled storage (its feature sharding
        # predates bundles).
        num_bins_arr = [m.num_bin for m in bin_mappers]
        default_bins_arr = [m.default_bin for m in bin_mappers]
        if reference_bundle is not None:
            from .bundling import apply_bundles
            ds.bundle_info = reference_bundle
            bins = apply_bundles(bins, reference_bundle, num_bins_arr,
                                 default_bins_arr)
        elif (bool(getattr(config, "enable_bundle", True))
              and str(getattr(config, "tree_learner", "serial"))
              in ("serial", "data", "voting")
              and f >= 2):
            # features mostly at their zero bin are bundling candidates;
            # denser ones isolate themselves anyway via the conflict budget
            # but would make conflict counting quadratic-expensive
            bundleable = [
                (not m.is_trivial) and m.sparse_rate >= 0.5
                and m.num_bin >= 2 for m in bin_mappers]
            if sum(bundleable) >= 2:
                out = bundle_features(
                    bins, num_bins_arr, default_bins_arr, bundleable, n,
                    max_conflict_rate=float(
                        getattr(config, "max_conflict_rate", 0.0) or 0.0),
                    max_bundle_bins=max(ds.max_num_bin, 255),
                    sample_cnt=int(getattr(config,
                                           "bin_construct_sample_cnt",
                                           200000)),
                    seed=int(getattr(config, "data_random_seed", 1)))
                if out is not None:
                    bins, ds.bundle_info = out
        if ds.bundle_info is not None:
            ds.max_num_bin = max(ds.max_num_bin,
                                 ds.bundle_info.max_group_bin)
        ds.bins = bins
        ds.num_data_padded = n_pad
        ds.metadata = Metadata(n)

        mono = getattr(config, "monotone_constraints", None) or []
        ds.monotone_constraints = np.zeros(f, dtype=np.int32)
        ds.monotone_constraints[: len(mono)] = np.asarray(mono, dtype=np.int32)[:f]
        pen = getattr(config, "feature_contri", None) or []
        ds.feature_penalty = np.ones(f, dtype=np.float32)
        ds.feature_penalty[: len(pen)] = np.asarray(pen, dtype=np.float32)[:f]
        return ds


    @staticmethod
    def _find_bin_mappers(X: np.ndarray, config,
                          categorical_feature: Sequence[int]) -> List[BinMapper]:
        n, f = X.shape
        sample_cnt = min(int(getattr(config, "bin_construct_sample_cnt", 200000)), n)
        rng = Random(int(getattr(config, "data_random_seed", 1)))
        sample_idx = rng.sample(n, sample_cnt)
        cat = set(int(c) for c in categorical_feature)
        mappers: List[BinMapper] = []
        max_bin = int(getattr(config, "max_bin", 255))
        min_data_in_bin = int(getattr(config, "min_data_in_bin", 3))
        use_missing = bool(getattr(config, "use_missing", True))
        zero_as_missing = bool(getattr(config, "zero_as_missing", False))
        def find_one(j: int) -> BinMapper:
            m = BinMapper()
            values = X[sample_idx, j].astype(np.float64)
            bin_type = BIN_TYPE_CATEGORICAL if j in cat else BIN_TYPE_NUMERICAL
            m.find_bin(values, len(sample_idx), max_bin,
                       min_data_in_bin=min_data_in_bin, bin_type=bin_type,
                       use_missing=use_missing, zero_as_missing=zero_as_missing)
            return m

        # feature-sharded find-bin (reference ParallelFindBin /
        # is_parallel_find_bin, src/io/dataset_loader.cpp:842-924: each rank
        # bins a feature slice and the mappers are allgathered; here the
        # shards are host worker threads, and the "allgather" is the shared
        # result list — one process owns all device shards)
        mappers = _map_features(find_one, f, config)
        num_trivial = sum(1 for m in mappers if m.is_trivial)
        if num_trivial:
            Log.info("%d features are ignored (constant value)", num_trivial)
        Log.info("Total bins: %d over %d features",
                 sum(m.num_bin for m in mappers), f - num_trivial)
        return mappers

    # -- accessors -----------------------------------------------------------
    @property
    def num_features(self) -> int:
        return self.num_total_features

    def feature_infos(self) -> List[str]:
        return [m.feature_info() for m in self.bin_mappers]

    def real_threshold(self, feature: int, bin_idx: int) -> float:
        """Bin threshold → double threshold for the model file
        (Dataset::RealThreshold)."""
        return self.bin_mappers[feature].bin_to_value(bin_idx)

    def valid_row_mask(self) -> np.ndarray:
        mask = np.zeros(self.num_data_padded, dtype=np.float32)
        mask[: self.num_data] = 1.0
        return mask

    def padded(self, arr: Optional[np.ndarray], fill: float = 0.0,
               dtype=np.float32) -> np.ndarray:
        """Pad a per-row array to the padded row count."""
        out = np.full(self.num_data_padded, fill, dtype=dtype)
        if arr is not None:
            out[: self.num_data] = arr
        return out
