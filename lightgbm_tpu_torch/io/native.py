"""ctypes wrappers for the native ingest fast paths (counterpart of
lightgbm_tpu/io/native.py, over cpp/ingest.cc).

The reference's loader is native code end to end (dataset_loader.cpp +
parser.cpp + bin.h ValueToBin); these wrappers give the Python loader the
same native parse and bin-encode stages.  The symbols live in the C ABI's
base library, which `capi.ensure_built` compiles from cpp/ with g++ at
first use; a library that does not build or load raises with the
compiler's output.  An entry returns None (or False) only for an input
it declines, which the numpy and pure-Python readers then take and give
the same arrays.  `encode_bins` gives the Python binning's bins bit for
bit, but no binning path takes it: row-parallel over every feature, it
was slower than the per-feature numpy threads at 968 and 2,000 features.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

_lib = None


def _load():
    """The ingest symbols live in the same shared library as the
    prediction C API; reuse its build-and-load machinery."""
    global _lib
    if _lib is None:
        from ..capi import load_lib
        lib = load_lib()
        lib.LGBMT_CountRows.restype = ctypes.c_longlong
        lib.LGBMT_CountRows.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_char]
        lib.LGBMT_ParseDense.restype = ctypes.c_int
        lib.LGBMT_ParseDense.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.LGBMT_EncodeBins.restype = ctypes.c_int
        lib.LGBMT_EncodeBins.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong]
        _lib = lib
    return _lib


def parse_dense(path: str, sep: str, label_column: int, has_header: bool,
                n_cols: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """mmap + OpenMP parse of a numeric CSV/TSV -> (X [n, n_cols-1], y [n]).
    None when the parse declines the file (a text token that is not a
    missing marker, a row wider than the first)."""
    if n_cols < 2 or not (0 <= label_column < n_cols):
        return None
    lib = _load()
    pathb = path.encode()
    n = lib.LGBMT_CountRows(pathb, int(has_header), sep.encode()[:1])
    if n <= 0:
        return None
    X = np.empty((n, n_cols - 1), dtype=np.float64)
    # NaN-filled: short lines that end before the label column leave
    # y rows unwritten (the C side NaN-fills only the feature row)
    y = np.full(n, np.nan, dtype=np.float64)
    rc = lib.LGBMT_ParseDense(
        pathb, sep.encode()[:1], int(has_header),
        ctypes.c_longlong(n), n_cols, label_column,
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return X, y


def encode_bins(X: np.ndarray, mappers: List,
                bins_out: np.ndarray) -> bool:
    """Native ValueToBin over the whole matrix into the feature-major
    uint8 storage (bins_out [F, >= n], rows of features, any row
    stride, unit column stride: a column slice of a wider store works).
    Handles numerical features only: returns False (the caller keeps the
    Python path) when any non-trivial feature is categorical or has more
    than 256 bins.  Trivial features are skipped (their storage stays
    zeros), as in the Python loop."""
    from .binning import BIN_TYPE_CATEGORICAL
    if bins_out.dtype != np.uint8 or bins_out.strides[1] != 1:
        return False
    n, F = X.shape
    if F != len(mappers) or bins_out.shape[0] != F or bins_out.shape[1] < n:
        return False
    offs = np.zeros(F, dtype=np.int64)
    cnts = np.zeros(F, dtype=np.int32)
    miss = np.zeros(F, dtype=np.int32)
    nbin = np.zeros(F, dtype=np.int32)
    triv = np.zeros(F, dtype=np.int32)
    chunks = []
    off = 0
    for f, m in enumerate(mappers):
        if m.is_trivial:
            triv[f] = 1
            continue
        if m.bin_type == BIN_TYPE_CATEGORICAL or m.num_bin > 256:
            return False
        b = np.asarray(m.bin_upper_bound, dtype=np.float64)
        offs[f] = off
        cnts[f] = len(b)
        miss[f] = int(m.missing_type)
        nbin[f] = int(m.num_bin)
        chunks.append(b)
        off += len(b)
    lib = _load()
    bounds = (np.concatenate(chunks) if chunks
              else np.zeros(1, dtype=np.float64))
    # chunk the f64 conversion: a whole-matrix ascontiguousarray of a
    # float32 Higgs-scale X would be a multi-GB transient
    already = (X.dtype == np.float64 and X.flags.c_contiguous)
    block = n if already else max(1, (1 << 24) // max(F, 1))
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        Xc = np.ascontiguousarray(X[b0:b1], dtype=np.float64)
        rc = lib.LGBMT_EncodeBins(
            Xc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_longlong(b1 - b0), F,
            bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            miss.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            nbin.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            triv.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            bins_out[:, b0:].ctypes.data_as(
                ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.c_longlong(bins_out.strides[0]))
        if rc != 0:
            return False
    return True
