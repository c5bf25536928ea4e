"""Text data parsers: CSV / TSV / LibSVM with auto-detection
(counterpart of lightgbm_tpu/io/parser.py).

Role parity with the reference Parser (src/io/parser.cpp:169 CreateParser,
include/LightGBM/dataset.h:252-277): sniff the format from sample lines,
parse label + features into a dense matrix.  Host-side ingest; the result
feeds BinnedDataset.from_matrix.  CSV and TSV go first through the native
mmap parser (io/native.py, cpp/ingest.cc), as in the JAX package; a file
it declines (a text token, a row wider than the first) and LibSVM go
through numpy's C-backed parsing when every value is a number and the
rows are regular, anything else (missing-value markers, ragged rows)
through the tolerant pure-Python parser.  Each gives every value as the
decimal's nearest double, as float() does, so the readers' arrays agree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.log import Log


def _is_libsvm_pair(tok: str) -> bool:
    """True only for `<int>:<number>` — a colon inside a timestamp or URL
    must not flip the whole file to libsvm."""
    k, sep, v = tok.partition(":")
    if not sep:
        return False
    try:
        int(k)
        float(v)
        return True
    except ValueError:
        return False


def detect_format(sample_lines) -> str:
    """'libsvm' | 'tsv' | 'csv' (parser.cpp GetDataType semantics: index:value
    pairs -> libsvm, tabs -> tsv, commas -> csv)."""
    for line in sample_lines:
        line = line.strip()
        if not line:
            continue
        tokens = line.replace("\t", " ").replace(",", " ").split()
        if any(_is_libsvm_pair(t) for t in tokens[1:]):
            return "libsvm"
        if "\t" in line:
            return "tsv"
        if "," in line:
            return "csv"
    return "tsv"


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def sniff(path: str, has_header: Optional[bool] = None):
    """Format/header sniff of parse_file -> (fmt, sep, has_header,
    head_lines).
    sep is None for libsvm.  Reads only the file head — materializing the
    whole file as Python strings would dwarf the chunked fast path."""
    import itertools
    with open(path) as fh:
        head = [l for l in itertools.islice(fh, 200) if l.strip()][:20]
    fmt = detect_format(head)
    if has_header is None:
        first = head[0].strip() if head else ""
        seps = {"csv": ",", "tsv": "\t"}
        toks = first.split(seps[fmt]) if fmt in seps else first.split()
        # a header needs a token that is neither numeric nor a missing marker
        has_header = bool(toks) and not all(
            _is_number(t.split(":")[0]) or t.strip().lower() in _MISSING
            for t in toks)
    return fmt, {"csv": ",", "tsv": "\t"}.get(fmt), bool(has_header), head


def parse_file(path: str, label_column: int = 0, has_header: Optional[bool] = None,
               num_features: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a data file -> (X [n, F], y [n]).  Auto-detects format and
    header; missing values ('', 'na', 'nan', 'null') become NaN."""
    fmt, sep, has_header, head = sniff(path, has_header)
    if fmt != "libsvm":
        # the native mmap + OpenMP parser first (cpp/ingest.cc, the role
        # of the reference's native Parser), then numpy's reader, then the
        # tolerant pure-Python parser
        n_cols = len(head[1 if has_header and len(head) > 1 else 0]
                     .rstrip("\n\r").split(sep)) if head else 0
        if n_cols >= 2:
            from .native import parse_dense
            out = parse_dense(path, sep, label_column, has_header, n_cols)
            if out is not None:
                X, y = out
                return _fix_width(X, num_features), y
        out = _parse_delimited_numpy(path, sep, label_column, num_features,
                                     has_header)
        if out is not None:
            return out
    # the delimited file the numpy reader refused, or libsvm in one numpy
    # pass; then the tolerant pure-Python parser; each reads the file fully
    with open(path) as fh:
        lines = [l for l in fh.readlines() if l.strip()]
    body = lines[1:] if has_header else lines
    if fmt == "libsvm":
        out = _parse_libsvm_numpy(body, num_features)
        return out if out is not None else _parse_libsvm(body, num_features)
    return _parse_delimited(body, sep, label_column, num_features)


def _parse_delimited_numpy(path, sep, label_column, num_features,
                           has_header):
    """numpy's C reader for a regular all-numeric file; None when a row
    is ragged or a value is not a number (a missing-value marker: the
    pure-Python parser handles it)."""
    import warnings
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            arr = np.loadtxt(path, delimiter=sep, dtype=np.float64,
                             skiprows=1 if has_header else 0, ndmin=2,
                             comments=None)
    except ValueError:
        return None
    if arr.size == 0:
        return None
    y = arr[:, label_column].copy()
    return _fix_width(np.delete(arr, label_column, axis=1), num_features), y


def _parse_libsvm_numpy(lines, num_features):
    """LibSVM lines (`label index:value ...`) in one vectorized pass:
    every label, index and value a number; None otherwise (the
    pure-Python parser then reads them).  A later duplicate index of a
    row wins, as there."""
    counts = np.asarray([ln.count(":") for ln in lines], np.int64)
    try:
        flat = np.asarray(" ".join(lines).replace(":", " ").split(),
                          dtype=np.float64)
    except ValueError:
        return None
    n = len(lines)
    if n == 0 or flat.size != n + 2 * int(counts.sum()):
        return None
    starts = np.concatenate([[0], np.cumsum(1 + 2 * counts)[:-1]])
    is_pair = np.ones(flat.size, bool)
    is_pair[starts] = False
    pairs = flat[is_pair]
    idx_f, vals = pairs[0::2], pairs[1::2]
    if not np.all((idx_f >= 0) & (idx_f == np.floor(idx_f))):
        return None
    idx = idx_f.astype(np.int64)
    rows = np.repeat(np.arange(n), counts)
    F = num_features if num_features else (int(idx.max()) + 1
                                            if idx.size else 0)
    X = np.zeros((n, F))
    keep = idx < F
    X[rows[keep], idx[keep]] = vals[keep]
    return X, flat[starts].copy()


def _fix_width(X, num_features):
    """Reconcile a parsed matrix to the requested feature count
    (validation files must align to the training schema)."""
    if num_features is None or X.shape[1] == num_features:
        return X
    fixed = np.full((X.shape[0], num_features), np.nan)
    fixed[:, :min(X.shape[1], num_features)] = X[:, :num_features]
    return fixed


_MISSING = {"", "na", "nan", "null", "n/a", "none", "?"}


def _parse_value(tok: str) -> float:
    tok = tok.strip()
    if tok.lower() in _MISSING:
        return np.nan
    return float(tok)


def _parse_delimited(lines, sep, label_column, num_features):
    rows = []
    labels = []
    for line in lines:
        line = line.rstrip("\n\r")
        if not line.strip():
            continue
        toks = line.split(sep)
        vals = [_parse_value(t) for t in toks]
        labels.append(vals[label_column])
        del vals[label_column]
        rows.append(vals)
    if not rows:
        Log.fatal("Data file is empty or unparseable")
    F = num_features if num_features else max(len(r) for r in rows)
    X = np.full((len(rows), F), np.nan)
    for i, r in enumerate(rows):
        X[i, :min(len(r), F)] = r[:F]
    return X, np.asarray(labels, dtype=np.float64)


def _parse_libsvm(lines, num_features):
    rows = []
    labels = []
    maxf = -1
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        labels.append(float(parts[0]))
        feats = {}
        for tok in parts[1:]:
            if ":" not in tok:
                continue
            k, v = tok.split(":", 1)
            feats[int(k)] = _parse_value(v)
            maxf = max(maxf, int(k))
        rows.append(feats)
    if not rows:
        Log.fatal("Data file is empty or unparseable")
    F = num_features if num_features else maxf + 1
    X = np.zeros((len(rows), F))
    for i, feats in enumerate(rows):
        for k, v in feats.items():
            if k < F:
                X[i, k] = v
    return X, np.asarray(labels, dtype=np.float64)


def load_sidecar(path: str) -> Optional[np.ndarray]:
    """Optional one-value-per-line sidecar (<data>.weight / <data>.query,
    metadata.cpp LoadWeights/LoadQueryBoundaries)."""
    import os
    if not os.path.exists(path):
        return None
    vals = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                vals.append(float(line))
    return np.asarray(vals, dtype=np.float64) if vals else None
