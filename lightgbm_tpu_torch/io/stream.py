"""Zero-copy streaming dataset ingest: chunked CSR/CSC/dense construction
(counterpart of lightgbm_tpu/io/stream.py).

Role parity with the reference's dataset-from-memory block (c_api.h:48-232,
src/c_api.cpp Dataset sections): ``LGBM_DatasetCreateFromCSR/CSC/Mat``,
``LGBM_DatasetCreateByReference`` + ``LGBM_DatasetPushRows[ByCSR]``
streaming.  Feature-store pipelines and other-language bindings push
in-memory chunks and get the exact same binned ``BinnedDataset`` the CSV
parser path produces — no file detour, no re-parse.

Two operating modes, mirroring the reference's sample-then-bin flow:

* **buffered** (fresh stream, no reference): pushed chunks are retained by
  reference (zero-copy — dense chunks and CSR triplets are not copied or
  densified at push time) while a BOUNDED reservoir sample, capped at
  ``bin_construct_sample_cnt`` rows, is maintained online for bin
  construction.  ``finalize()`` materializes the matrix once and runs the
  exact ``BinnedDataset.from_matrix`` pipeline.  While the stream fits the
  reservoir (the default 200k-row cap) the bins/bundles/metadata are
  byte-identical to what the file parser path produces on the same rows;
  beyond the cap both paths bin from a size-``sample_cnt`` uniform sample
  and differ only in which indices were drawn (docs/INGEST.md).
* **by-reference** (``LGBM_DatasetCreateByReference`` + push): the
  reference dataset's mappers are fixed up front, packed-integer storage
  is preallocated at the declared row count, and every pushed chunk is
  ENCODED IMMEDIATELY then dropped — memory is bounded by the uint8/uint16
  bin matrix, not the raw float stream.

CSR semantics follow the reference C API: absent entries are 0.0 (so
``zero_as_missing`` applies to them exactly as it does to explicit zeros
from a parsed file).

The JAX package's push-time quarantine (``quarantine=``, its
runtime/quality.py) is not ported yet: asking for it raises
NotImplementedError.  Chunks are binned by the per-feature numpy encoder
(io/dataset.py's), where the JAX package first tries its native one
(io/native.encode_bins here, which no path takes: it is slower at wide
widths).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.log import LightGBMError, Log
from ..utils.random import partition_seed
from .binning import BinMapper
from .dataset import BinnedDataset, Metadata, _round_up

#: partition_seed stream id for the reservoir sampler (disjoint from the
#: bagging/feature/binning streams used elsewhere)
_RESERVOIR_STREAM = 77


def _is_scipy_sparse(data) -> bool:
    return data.__class__.__module__.startswith("scipy.sparse")


class _Chunk:
    """One pushed chunk.  Dense chunks keep the caller's array by
    reference; CSR chunks keep the raw (indptr, indices, values) triplet —
    nothing is densified until finalize."""

    __slots__ = ("start_row", "num_rows", "dense", "csr")

    def __init__(self, start_row: int, num_rows: int, dense=None, csr=None):
        self.start_row = start_row
        self.num_rows = num_rows
        self.dense = dense
        self.csr = csr          # (indptr, indices, values, num_col)

    def rows(self, local_idx: np.ndarray, num_features: int) -> np.ndarray:
        """Densify ONLY the requested local rows (reservoir feed)."""
        if self.dense is not None:
            return np.asarray(self.dense, dtype=np.float64)[local_idx]
        indptr, indices, values, _ = self.csr
        out = np.zeros((len(local_idx), num_features), dtype=np.float64)
        for k, i in enumerate(np.asarray(local_idx)):
            s, e = int(indptr[i]), int(indptr[i + 1])
            out[k, np.asarray(indices[s:e], dtype=np.int64)] = values[s:e]
        return out

    def fill(self, X: np.ndarray, at: int) -> None:
        """Write this chunk's rows into X[at : at+num_rows] (X is zeroed,
        so absent CSR entries stay 0.0 — the reference's CSR contract)."""
        if self.dense is not None:
            X[at:at + self.num_rows] = np.asarray(self.dense,
                                                  dtype=np.float64)
            return
        indptr, indices, values, _ = self.csr
        counts = np.diff(np.asarray(indptr, dtype=np.int64))
        rows = np.repeat(np.arange(self.num_rows, dtype=np.int64), counts)
        X[at + rows, np.asarray(indices, dtype=np.int64)] = \
            np.asarray(values, dtype=np.float64)


class StreamingDatasetBuilder:
    """Chunked dataset builder behind ``Dataset(data=<iterator>)`` and
    ``Dataset(StreamingDatasetBuilder)`` with ``push_rows`` /
    ``push_rows_csr`` (the reference's LGBM_Dataset* streaming entry
    points)."""

    def __init__(self, params: Optional[dict] = None,
                 num_features: Optional[int] = None,
                 reference=None, num_total_rows: Optional[int] = None,
                 feature_names: Optional[Sequence[str]] = None,
                 categorical_feature: Sequence[int] = (),
                 quarantine=None):
        """`quarantine` (the JAX package's push-time schema validation,
        which needs its runtime/quality.py) is not ported: anything but
        None raises NotImplementedError."""
        if quarantine is not None:
            raise NotImplementedError(
                "stream quarantine (runtime/quality.py) is not ported to "
                "the PyTorch package yet; it waits for the C ABI slice "
                "(ROADMAP queue A item 8)")
        self.params = dict(params or {})
        self.feature_names = list(feature_names) if feature_names else None
        self.categorical_feature = tuple(int(c) for c in categorical_feature)
        self._num_features = int(num_features) if num_features else None
        self._chunks: List[_Chunk] = []
        self._labels: List[Tuple[int, np.ndarray]] = []
        self._weights: List[Tuple[int, np.ndarray]] = []
        self._n = 0                      # rows pushed (append mode)
        self._explicit_rows = False      # any push carried a start_row
        self._finalized: Optional[BinnedDataset] = None

        # bounded reservoir (buffered mode find-bin sample)
        self._sample_cap = max(int(self.params.get(
            "bin_construct_sample_cnt", 200000) or 200000), 1)
        seed = int(self.params.get("data_random_seed", 1) or 1)
        self._res_rng = np.random.Generator(np.random.Philox(
            partition_seed(seed, _RESERVOIR_STREAM)))
        self._res: Optional[np.ndarray] = None
        self._res_seen = 0

        # by-reference streaming mode: mappers fixed, storage preallocated,
        # chunks encoded eagerly and dropped
        self._ref_binned = None
        self._bins: Optional[np.ndarray] = None
        self._covered: Optional[np.ndarray] = None
        self._num_total_rows = None
        if reference is not None:
            binned = getattr(reference, "binned", reference)
            if not isinstance(binned, BinnedDataset):
                raise LightGBMError(
                    "StreamingDatasetBuilder reference must be a Dataset "
                    "or BinnedDataset")
            self._ref_binned = binned
            self._num_features = binned.num_total_features
            if num_total_rows is not None:
                n = int(num_total_rows)
                if n <= 0:
                    raise LightGBMError(
                        "num_total_rows must be positive, got %d" % n)
                self._num_total_rows = n
                n_pad = _round_up(n, 16384) if n > 16384 \
                    else _round_up(max(n, 1), 128)
                max_bin = max((m.num_bin for m in binned.bin_mappers),
                              default=1)
                dtype = np.uint8 if max_bin <= 256 else np.uint16
                self._bins = np.zeros((self._num_features, n_pad),
                                      dtype=dtype)
                self._covered = np.zeros(n, dtype=bool)

    # -- introspection -------------------------------------------------------
    @property
    def num_pushed_rows(self) -> int:
        return self._n

    @property
    def num_features(self) -> Optional[int]:
        return self._num_features

    @property
    def streaming(self) -> bool:
        """True in the bounded-memory by-reference mode (raw chunks are
        encoded eagerly and never retained)."""
        return self._bins is not None

    @property
    def reservoir_rows(self) -> int:
        """Rows currently held by the bounded find-bin reservoir."""
        return 0 if self._res is None else min(self._res_seen,
                                               self._sample_cap)

    def labels(self) -> Optional[np.ndarray]:
        if not self._labels:
            return None
        y = np.empty(self._n, dtype=np.float64)
        for start, part in self._labels:
            y[start:start + len(part)] = part
        return y

    def weights(self) -> Optional[np.ndarray]:
        if not self._weights:
            return None
        w = np.empty(self._n, dtype=np.float64)
        for start, part in self._weights:
            w[start:start + len(part)] = part
        return w

    # -- push API ------------------------------------------------------------
    def push(self, chunk) -> "StreamingDatasetBuilder":
        """Duck-typed push for ``lgb.Dataset(data=<iterator>)`` chunks:
        a 2-D array, an ``(X, y)`` or ``(X, y, w)`` tuple, or a
        scipy.sparse matrix."""
        if isinstance(chunk, tuple):
            if len(chunk) == 2:
                X, y = chunk
                return self.push_dense(X, label=y)
            if len(chunk) == 3:
                X, y, w = chunk
                return self.push_dense(X, label=y, weight=w)
            raise LightGBMError("stream chunks must be X, (X, y) or "
                                "(X, y, w); got a %d-tuple" % len(chunk))
        if _is_scipy_sparse(chunk):
            csr = chunk.tocsr()
            return self.push_csr(csr.indptr, csr.indices, csr.data,
                                 csr.shape[1])
        return self.push_dense(chunk)

    def push_dense(self, X, label=None, weight=None,
                   start_row: int = -1) -> "StreamingDatasetBuilder":
        """Push a dense [m, F] chunk.  The array is kept by reference
        (zero-copy) in buffered mode and encoded immediately in
        by-reference mode; don't mutate it afterwards."""
        if getattr(X, "ndim", None) == 1:
            X = np.asarray(X).reshape(1, -1)
        if getattr(X, "ndim", None) != 2:
            raise LightGBMError("pushed chunks must be 2-dimensional")
        m, f = X.shape
        self._check_features(f)
        chunk = _Chunk(start_row, m, dense=X)
        return self._push(chunk, label, weight)

    def push_csr(self, indptr, indices, values, num_col: int,
                 label=None, weight=None,
                 start_row: int = -1) -> "StreamingDatasetBuilder":
        """Push a CSR chunk: indptr [m+1] row offsets, indices [nnz]
        column ids, values [nnz].  Absent entries are 0.0 (the reference
        C-API contract, so zero-as-missing semantics match a parsed
        file's explicit zeros)."""
        indptr = np.asarray(indptr)
        m = len(indptr) - 1
        if m < 0 or int(indptr[0]) != 0:
            raise LightGBMError("CSR indptr must start at 0 and have one "
                                "entry per row plus one")
        nnz = int(indptr[-1])
        if len(indices) < nnz or len(values) < nnz:
            raise LightGBMError("CSR indices/values shorter than indptr[-1]")
        idx = np.asarray(indices)
        if nnz and int(idx[:nnz].max()) >= int(num_col):
            raise LightGBMError("CSR column index %d out of range for "
                                "num_col=%d" % (int(idx[:nnz].max()),
                                                int(num_col)))
        self._check_features(int(num_col))
        chunk = _Chunk(start_row, m, csr=(indptr, idx, values, int(num_col)))
        return self._push(chunk, label, weight)

    def push_csc(self, col_ptr, indices, values, num_row: int,
                 label=None, weight=None) -> "StreamingDatasetBuilder":
        """One-shot CSC push (``LGBM_DatasetCreateFromCSC``): a CSC matrix
        carries whole columns, so it arrives as a single chunk covering
        all ``num_row`` rows; it is transposed to a dense chunk here."""
        col_ptr = np.asarray(col_ptr, dtype=np.int64)
        ncol = len(col_ptr) - 1
        self._check_features(ncol)
        n = int(num_row)
        X = np.zeros((n, ncol), dtype=np.float64)
        idx = np.asarray(indices, dtype=np.int64)
        vals = np.asarray(values, dtype=np.float64)
        for j in range(ncol):
            s, e = int(col_ptr[j]), int(col_ptr[j + 1])
            X[idx[s:e], j] = vals[s:e]
        return self.push_dense(X, label=label, weight=weight)

    # -- internals -----------------------------------------------------------
    def _check_features(self, f: int) -> None:
        if self._finalized is not None:
            raise LightGBMError("cannot push rows into a finalized stream")
        if self._num_features is None:
            self._num_features = int(f)
        elif int(f) != self._num_features:
            raise LightGBMError(
                "pushed chunk has %d features; the stream is %d-wide"
                % (f, self._num_features))

    def _push(self, chunk: _Chunk, label, weight) -> "StreamingDatasetBuilder":
        if chunk.start_row >= 0:
            if self._bins is None and self._n > 0 and not self._explicit_rows:
                raise LightGBMError(
                    "cannot mix positioned (start_row) and appended pushes")
            self._explicit_rows = True
            start = chunk.start_row
        else:
            if self._explicit_rows:
                raise LightGBMError(
                    "cannot mix positioned (start_row) and appended pushes")
            start = self._n
            chunk.start_row = start
        if self._bins is not None:
            end = start + chunk.num_rows
            if end > self._num_total_rows:
                raise LightGBMError(
                    "push of rows [%d, %d) exceeds the declared "
                    "num_total_rows=%d" % (start, end, self._num_total_rows))
            if self._covered[start:end].any():
                raise LightGBMError(
                    "rows [%d, %d) were already pushed" % (start, end))
            self._encode_into(chunk, start)
            self._covered[start:end] = True
            self._n += chunk.num_rows
        else:
            self._feed_reservoir(chunk)
            self._chunks.append(chunk)
            self._n += chunk.num_rows
        if label is not None:
            y = np.asarray(label, dtype=np.float64).reshape(-1)
            if len(y) != chunk.num_rows:
                raise LightGBMError("label chunk length %d != row chunk %d"
                                    % (len(y), chunk.num_rows))
            self._labels.append((start, y))
        if weight is not None:
            w = np.asarray(weight, dtype=np.float64).reshape(-1)
            if len(w) != chunk.num_rows:
                raise LightGBMError("weight chunk length %d != row chunk %d"
                                    % (len(w), chunk.num_rows))
            self._weights.append((start, w))
        return self

    def _encode_into(self, chunk: _Chunk, start: int) -> None:
        """By-reference mode: bin the chunk with the FIXED reference
        mappers straight into the preallocated storage; the raw chunk is
        dropped when this returns."""
        mappers = self._ref_binned.bin_mappers
        m = chunk.num_rows
        Xc = np.zeros((m, self._num_features), dtype=np.float64)
        chunk.fill(Xc, 0)
        for j, mapper in enumerate(mappers):
            if not mapper.is_trivial:
                self._bins[j, start:start + m] = mapper.values_to_bins(Xc[:, j])

    def _feed_reservoir(self, chunk: _Chunk) -> None:
        """Online bounded reservoir over the pushed stream (uniform,
        deterministic given the seed and push sequence).  Only the rows
        the reservoir actually keeps are densified."""
        cap = self._sample_cap
        F = self._num_features
        m = chunk.num_rows
        t = self._res_seen
        need = min(cap, t + m)
        if self._res is None or len(self._res) < need:
            # grow geometrically toward the cap instead of paying the full
            # cap (default 200k rows) for small streams
            size = max(min(cap, 1024), need)
            if self._res is not None:
                size = min(cap, max(size, 2 * len(self._res)))
            grown = np.empty((size, F), dtype=np.float64)
            if self._res is not None and t > 0:
                grown[:min(t, len(self._res))] = \
                    self._res[:min(t, len(self._res))]
            self._res = grown
        fill = min(max(cap - t, 0), m)
        if fill:
            self._res[t:t + fill] = chunk.rows(np.arange(fill), F)
        rest = m - fill
        if rest > 0:
            # classic reservoir step, vectorized: row with global index g
            # replaces a random slot with probability cap / (g + 1)
            g = np.arange(t + fill, t + m, dtype=np.int64)
            r = self._res_rng.integers(0, g + 1)
            hit = r < cap
            if hit.any():
                local = np.nonzero(hit)[0] + fill
                self._res[r[hit]] = chunk.rows(local, F)
        self._res_seen = t + m

    def _reservoir_mappers(self, config) -> List[BinMapper]:
        """Find bin mappers from the bounded reservoir (only taken when
        the stream outgrew the cap; otherwise the exact offline sampling
        path runs over the full buffered rows)."""
        rows = self._res[:min(self._res_seen, self._sample_cap)]
        Log.info("stream ingest: binning from a %d-row reservoir over a "
                 "%d-row stream", len(rows), self._n)
        # reuse the offline find-bin verbatim with a sample that covers
        # the whole reservoir (Random.sample(n, n) keeps every row)
        import copy as _copy
        cfg = _copy.copy(config)
        try:
            cfg.bin_construct_sample_cnt = len(rows)
        except Exception:
            pass
        return BinnedDataset._find_bin_mappers(
            rows, cfg, self.categorical_feature)

    def _materialize(self) -> np.ndarray:
        """Buffered mode: assemble the full [n, F] float64 matrix exactly
        once (the same materialization the file parser performs)."""
        order = sorted(self._chunks, key=lambda c: c.start_row)
        expect = 0
        for c in order:
            if c.start_row != expect:
                raise LightGBMError(
                    "pushed rows do not tile [0, %d): gap/overlap at row "
                    "%d (next chunk starts at %d)"
                    % (self._n, expect, c.start_row))
            expect += c.num_rows
        X = np.zeros((self._n, self._num_features), dtype=np.float64)
        for c in order:
            c.fill(X, c.start_row)
        return X

    # -- finalize ------------------------------------------------------------
    def finalize(self, config=None, *, bin_mappers=None,
                 reference_bundle=None, feature_names=None,
                 categorical_feature=None) -> BinnedDataset:
        """Produce the binned dataset.  Idempotent — the first call's
        result is cached and returned thereafter."""
        if self._finalized is not None:
            return self._finalized
        if self._n <= 0:
            raise LightGBMError("cannot finalize an empty stream: push at "
                                "least one chunk first")
        if config is None:
            from ..config import Config
            config = Config(self.params)
        names = feature_names or self.feature_names
        cats = categorical_feature if categorical_feature \
            else self.categorical_feature

        if self._bins is not None:
            ds = self._finalize_streaming(config, names)
        else:
            if bin_mappers is None and self._ref_binned is not None:
                bin_mappers = self._ref_binned.bin_mappers
                if reference_bundle is None:
                    reference_bundle = self._ref_binned.bundle_info
            if bin_mappers is None and self._n > self._sample_cap:
                bin_mappers = self._reservoir_mappers(config)
            X = self._materialize()
            ds = BinnedDataset.from_matrix(
                X, config, bin_mappers=bin_mappers, feature_names=names,
                categorical_feature=cats,
                reference_bundle=reference_bundle)
        y = self.labels()
        if y is not None and ds.metadata.label is None:
            ds.metadata.set_label(y)
        w = self.weights()
        if w is not None and ds.metadata.weight is None:
            ds.metadata.set_weight(w)
        self._finalized = ds
        self._chunks = []        # raw chunks are no longer needed
        self._res = None
        return ds

    def _finalize_streaming(self, config, names) -> BinnedDataset:
        """By-reference mode assembly: the bins were encoded at push time;
        here only bundling + metadata remain (mirrors from_matrix's tail
        so the result is byte-identical to binning the same rows through
        from_matrix with the reference mappers)."""
        n = self._num_total_rows
        if not self._covered.all():
            missing = int((~self._covered).sum())
            raise LightGBMError(
                "stream is incomplete: %d of the declared %d rows were "
                "never pushed (first missing row: %d)"
                % (missing, n, int(np.argmax(~self._covered))))
        ref = self._ref_binned
        ds = BinnedDataset()
        ds.num_data = n
        ds.num_total_features = self._num_features
        ds.feature_names = list(names) if names \
            else list(ref.feature_names)
        ds.bin_mappers = list(ref.bin_mappers)
        ds.max_num_bin = max((m.num_bin for m in ds.bin_mappers), default=1)
        bins = self._bins
        if ref.bundle_info is not None:
            from .bundling import apply_bundles
            ds.bundle_info = ref.bundle_info
            bins = apply_bundles(bins, ref.bundle_info,
                                 [m.num_bin for m in ds.bin_mappers],
                                 [m.default_bin for m in ds.bin_mappers])
            ds.max_num_bin = max(ds.max_num_bin,
                                 ds.bundle_info.max_group_bin)
        ds.bins = bins
        ds.num_data_padded = bins.shape[1]
        ds.metadata = Metadata(n)
        f = ds.num_total_features
        mono = getattr(config, "monotone_constraints", None) or []
        ds.monotone_constraints = np.zeros(f, dtype=np.int32)
        ds.monotone_constraints[: len(mono)] = \
            np.asarray(mono, dtype=np.int32)[:f]
        pen = getattr(config, "feature_contri", None) or []
        ds.feature_penalty = np.ones(f, dtype=np.float32)
        ds.feature_penalty[: len(pen)] = \
            np.asarray(pen, dtype=np.float32)[:f]
        self._bins = None
        return ds
