"""Binned dataset: the training matrix as a packed integer array in HBM.

Role parity with the reference Dataset/DatasetLoader/Metadata
(include/LightGBM/dataset.h:282-618, src/io/dataset.cpp Construct:212-322,
src/io/dataset_loader.cpp CostructFromSampleData:501+, src/io/metadata.cpp).

Copied from the JAX package (numpy only): instead of per-feature-group Bin
objects with push iterators, the dataset is one [G, num_rows] integer
matrix (uint8 for <=256 bins; G storage columns, the features or their EFB
bundles) padded to the row chunk, plus small per-feature metadata arrays
(bin counts, missing types, default bins) consumed by the split finder.
The binary dataset cache (`save_binary` / `load_binary`, the JAX
package's npz format with its JSON header, bundles, mappers, metadata and
nibble packing, so either package loads the other's) and the binned row
subset (`subset`, for datasets with no raw matrix) are ported.  Host
binning runs the per-feature numpy path on worker threads; the native
encoder (io/native.encode_bins) gives the same bins but is slower at
wide widths, so no path takes it.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.log import Log
from ..utils.random import Random
from .binning import (BIN_TYPE_CATEGORICAL, BIN_TYPE_NUMERICAL, BinMapper)
from .bundling import BundleInfo, bundle_features
from .nbits import pack_nibbles, should_pack, unpack_nibbles


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


    # -- binary dataset cache (reference save_binary / DatasetLoader::
    #    LoadFromBinFile, src/io/dataset_loader.cpp:267+) -------------------
    BINARY_MAGIC = "lightgbm_tpu.dataset.v1"
    #: cache-format version stamp, the JAX package's: bumped whenever the
    #: on-disk layout or the binning semantics it froze change, so a stale
    #: cache refuses to load with a rebuild instruction instead of
    #: training on bins a newer build would not have produced.  v2 is the
    #: first stamped format (v1 files predate the stamp).  The magic and
    #: the version are shared, so a cache written by either package loads
    #: in the other.
    BINARY_FORMAT_VERSION = 2

    def save_binary(self, path: str) -> None:
        """Serialize the fully-constructed dataset (bins, mappers, bundles,
        metadata) so later runs skip parsing + find-bin + bundling."""
        header = {
            "magic": self.BINARY_MAGIC,
            "format_version": self.BINARY_FORMAT_VERSION,
            "num_data": self.num_data,
            "num_total_features": self.num_total_features,
            "num_data_padded": self.num_data_padded,
            "max_num_bin": self.max_num_bin,
            "feature_names": self.feature_names,
            "num_columns": int(self.bins.shape[0]),
        }
        if should_pack(self):
            # dense_nbits_bin parity at the storage boundary: <=16-bin
            # columns cache at two per byte
            header["nbits4"] = True
            arrays = {"bins": pack_nibbles(self.bins)}
        else:
            arrays = {"bins": self.bins}
        arrays.update({"monotone": self.monotone_constraints,
                       "penalty": self.feature_penalty})
        for i, m in enumerate(self.bin_mappers):
            ma = m.to_arrays()
            header.setdefault("mappers", []).append(
                {k: v for k, v in ma.items()
                 if not isinstance(v, np.ndarray)})
            arrays["mapper%d_upper" % i] = ma["bin_upper_bound"]
            arrays["mapper%d_cats" % i] = ma["bin_2_categorical"]
        if self.bundle_info is not None:
            bi = self.bundle_info
            header["bundle_groups"] = [list(map(int, g)) for g in bi.groups]
            arrays["bundle_f_group"] = bi.f_group
            arrays["bundle_f_offset"] = bi.f_offset
            arrays["bundle_f_identity"] = bi.f_identity
            arrays["bundle_group_num_bin"] = bi.group_num_bin
            if bi.conflict_rates is not None:
                arrays["bundle_conflict_rates"] = bi.conflict_rates
        md = self.metadata
        if md is not None:
            for name in ("label", "weight", "init_score", "query_boundaries"):
                v = getattr(md, name)
                if v is not None:
                    arrays["md_" + name] = v
        arrays["header"] = np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8)
        with open(path, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        Log.info("Saved binary dataset cache to %s", path)

    @staticmethod
    def is_binary_file(path: str) -> bool:
        try:
            with np.load(path, allow_pickle=False) as z:
                if "header" not in z.files:
                    return False
                header = json.loads(bytes(z["header"].tobytes()).decode())
                return header.get("magic") == BinnedDataset.BINARY_MAGIC
        except Exception:
            return False

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("magic") != cls.BINARY_MAGIC:
                Log.fatal("%s is not a lightgbm_tpu binary dataset", path)
            version = int(header.get("format_version", 1))
            if version != cls.BINARY_FORMAT_VERSION:
                Log.fatal(
                    "binary dataset cache %s has format version %d but "
                    "this build reads version %d; the cache is stale — "
                    "delete it and rebuild with save_binary", path, version,
                    cls.BINARY_FORMAT_VERSION)
            ds = cls()
            ds.num_data = int(header["num_data"])
            ds.num_total_features = int(header["num_total_features"])
            ds.num_data_padded = int(header["num_data_padded"])
            ds.max_num_bin = int(header["max_num_bin"])
            ds.feature_names = list(header["feature_names"])
            if header.get("nbits4"):
                ds.bins = unpack_nibbles(z["bins"],
                                         int(header["num_columns"]))
            else:
                ds.bins = z["bins"]
            ds.monotone_constraints = z["monotone"]
            ds.feature_penalty = z["penalty"]
            for i, mh in enumerate(header["mappers"]):
                d = dict(mh)
                d["bin_upper_bound"] = z["mapper%d_upper" % i]
                d["bin_2_categorical"] = z["mapper%d_cats" % i]
                ds.bin_mappers.append(BinMapper.from_arrays(d))
            if "bundle_groups" in header:
                ds.bundle_info = BundleInfo(
                    groups=[list(g) for g in header["bundle_groups"]],
                    f_group=z["bundle_f_group"],
                    f_offset=z["bundle_f_offset"],
                    f_identity=z["bundle_f_identity"],
                    group_num_bin=z["bundle_group_num_bin"],
                    max_group_bin=int(z["bundle_group_num_bin"].max()),
                    conflict_rates=z["bundle_conflict_rates"]
                    if "bundle_conflict_rates" in z.files else None)
            ds.metadata = Metadata(ds.num_data)
            for name in ("label", "weight", "init_score", "query_boundaries"):
                if "md_" + name in z.files:
                    setattr(ds.metadata, name, z["md_" + name])
        Log.info("Loaded binary dataset cache from %s (%d rows, %d features)",
                 path, ds.num_data, ds.num_total_features)
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

    # -- row subsetting (reference Dataset::CopySubrow via
    #    LGBM_DatasetGetSubset): gather BINNED rows directly, sharing the
    #    mappers/bundles — no raw data needed, so it also serves datasets
    #    built from a stream whose raw chunks were dropped ------------------
    def subset(self, used_indices) -> "BinnedDataset":
        idx = np.asarray(used_indices, dtype=np.int64).reshape(-1)
        if idx.size == 0:
            Log.fatal("used_indices must not be empty")
        if idx.min() < 0 or idx.max() >= self.num_data:
            Log.fatal("used_indices out of range [0, %d)", self.num_data)
        if np.any(np.diff(idx) <= 0):
            Log.fatal("used_indices must be sorted ascending and unique "
                      "(the reference GetSubset contract)")
        k = int(idx.size)
        ds = BinnedDataset()
        ds.num_data = k
        ds.num_total_features = self.num_total_features
        ds.bin_mappers = list(self.bin_mappers)
        ds.max_num_bin = self.max_num_bin
        ds.bundle_info = self.bundle_info
        n_pad = _round_up(k, 16384) if k > 16384 else _round_up(k, 128)
        bins = np.zeros((self.bins.shape[0], n_pad), dtype=self.bins.dtype)
        bins[:, :k] = self.bins[:, idx]
        ds.bins = bins
        ds.num_data_padded = n_pad
        ds.feature_names = list(self.feature_names)
        ds.monotone_constraints = self.monotone_constraints
        ds.feature_penalty = self.feature_penalty
        md = Metadata(k)
        src = self.metadata
        if src is not None:
            if src.query_boundaries is not None:
                # ranking subset: slice the query structure
                # along with the rows.  Each kept row maps to its source
                # query; since idx is sorted ascending, rows of one query
                # stay contiguous, so the subset's boundaries are the
                # run lengths of that mapping.  Whole kept groups keep
                # their size; partially-kept groups shrink (the
                # rolling-window trainer cuts on group boundaries, so in
                # that path groups are always whole).
                qb = src.query_boundaries
                row_query = np.searchsorted(qb, idx, side="right") - 1
                starts = np.flatnonzero(np.diff(row_query)) + 1
                counts = np.diff(np.concatenate([[0], starts, [k]]))
                md.set_query(counts)
            if src.label is not None:
                md.set_label(src.label[idx])
            if src.weight is not None:
                md.set_weight(src.weight[idx])
            if src.init_score is not None:
                if len(src.init_score) != self.num_data:
                    Log.fatal("cannot subset a multi-class init_score "
                              "through GetSubset")
                md.set_init_score(src.init_score[idx])
        ds.metadata = md
        return ds

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

    def storage_num_bins(self) -> np.ndarray:
        """[G] bin count of each STORAGE column (bundle width when EFB is
        active, the feature's own bins otherwise)."""
        if self.bundle_info is not None:
            return np.asarray(self.bundle_info.group_num_bin)
        return np.asarray([m.num_bin for m in self.bin_mappers])
