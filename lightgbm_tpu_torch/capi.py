"""ctypes loader for the native C API (cpp/lightgbm_tpu_c_api.h), for the
PyTorch/CUDA package (counterpart of lightgbm_tpu/capi.py).

Two shared libraries, compiled with g++ at first use into
``build/capi/<hash>/`` beside the package (never into cpp/):

* ``lib_lightgbm_tpu_torch.so``: the prediction runtime and the native
  ingest (cpp/c_api.cc + cpp/ingest.cc as they stand; pure C++, no
  Python);
* ``lib_lightgbm_tpu_torch_train.so``: the training ABI
  (lightgbm_tpu_torch/cpp/c_train.cc), which embeds CPython and trains
  through ``import lightgbm_tpu_torch``; it links the base library and
  finds it through ``$ORIGIN``.

The base library's name differs from the JAX package's
(``lib_lightgbm_tpu.so``): the dynamic loader matches a dependency by
name, so a training library asking for ``lib_lightgbm_tpu.so`` would
bind to the JAX package's base library when a process already holds it,
and register its hooks there.  Builds are keyed by a hash of the sources,
the flags and the Python they embed, written under a temporary name and
renamed, one process at a time (a lock file); each library's build is a
build of site ``build.<library>`` in the program ledger
(runtime/graph_obs.py).  A build that fails raises with the compiler's
output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from .runtime import graph_obs
from .utils.log import LightGBMError

_ROOT = Path(__file__).resolve().parent.parent
CPP_DIR = _ROOT / "cpp"
TRAIN_SOURCE = Path(__file__).resolve().parent / "cpp" / "c_train.cc"
BUILD_DIR = _ROOT / "build" / "capi"
BASE_SOURCES = ("c_api.cc", "ingest.cc")
HEADERS = ("lightgbm_tpu_c_api.h", "c_internal.h")
LIB_NAME = "lib_lightgbm_tpu_torch.so"
TRAIN_LIB_NAME = "lib_lightgbm_tpu_torch_train.so"
#: cpp/Makefile's flags
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fopenmp")

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3
C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_FEATURE_IMPORTANCE_SPLIT = 0
C_API_FEATURE_IMPORTANCE_GAIN = 1

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    # g++ from PATH, as cpp/Makefile's default: a $CXX set for other
    # builds may be a compiler without OpenMP's runtime
    return "g++"


def python_flags() -> tuple:
    """(compile flags, link flags) that embed this interpreter: what
    `python3-config --includes` / `--ldflags --embed` print for it, with
    an rpath to its libpython."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    inc = ["-I" + sysconfig.get_paths()["include"]]
    link = ["-L" + libdir, "-Wl,-rpath," + libdir, "-lpython" + ldver,
            "-ldl", "-lm"]
    return inc, link


def build_dir() -> Path:
    """The directory of this tree's build: keyed by the sources, the
    flags and the embedded Python."""
    h = hashlib.sha256()
    for path in ([CPP_DIR / n for n in BASE_SOURCES + HEADERS]
                 + [TRAIN_SOURCE]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    inc, link = python_flags()
    h.update(" ".join((_cxx(),) + CXX_FLAGS + tuple(inc + link)).encode())
    return BUILD_DIR / h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> None:
    """Run the compiler commands side by side; raise with the output of
    every one that failed, once all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    bad = [(cmd, log) for cmd, log, rc in logs if rc != 0]
    if bad:
        raise RuntimeError("building the C API library failed:\n" + "\n".join(
            "$ %s\n%s" % (" ".join(cmd), log) for cmd, log in bad))


def ensure_built(train: bool = False) -> str:
    """Build (or find) the base library, and the training library too
    when `train`; returns the base library's path.  The base library and
    the training library's object compile side by side."""
    d = build_dir()
    base, tlib = d / LIB_NAME, d / TRAIN_LIB_NAME
    want = [base] + ([tlib] if train else [])
    built: List[Path] = []
    wall = 0.0
    if not all(p.exists() for p in want):
        d.mkdir(parents=True, exist_ok=True)
        with open(d / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)       # one builder at a time
            t0 = time.perf_counter()
            inc, link = python_flags()
            tag = ".tmp%d" % os.getpid()
            tmp_base = base.with_name(base.name + tag)
            obj = d / ("c_train.o" + tag)
            cmds = []
            if not base.exists():
                cmds.append([_cxx(), *CXX_FLAGS, "-shared", "-I",
                             str(CPP_DIR), "-o", str(tmp_base)]
                            + [str(CPP_DIR / n) for n in BASE_SOURCES])
            if train and not tlib.exists():
                cmds.append([_cxx(), *CXX_FLAGS, *inc, "-I", str(CPP_DIR),
                             "-c", "-o", str(obj), str(TRAIN_SOURCE)])
            _run_all(cmds)
            if not base.exists():
                os.replace(tmp_base, base)
                built.append(base)
            if train and not tlib.exists():
                tmp = tlib.with_name(tlib.name + tag)
                _run_all([[_cxx(), *CXX_FLAGS, "-shared", "-o", str(tmp),
                           str(obj), "-L", str(d), "-l:" + LIB_NAME,
                           "-Wl,-rpath,$ORIGIN", *link]])
                os.remove(obj)
                os.replace(tmp, tlib)
                built.append(tlib)
            wall = time.perf_counter() - t0
    for p in want:
        if p in built:
            graph_obs.build_event(p.stem, "miss", wall, (p.name, _cxx()))
        else:
            graph_obs.build_event(p.stem, "hit")
    return str(base)


def train_lib_path() -> str:
    """The training library's path, built first if needed."""
    ensure_built(train=True)
    return str(build_dir() / TRAIN_LIB_NAME)


def load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.LGBM_GetLastError.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int) -> None:
    if rc != 0:
        raise LightGBMError(load_lib().LGBM_GetLastError().decode())


_train_lib: Optional[ctypes.CDLL] = None


def load_train_lib() -> ctypes.CDLL:
    """The TRAINING-side library (embedded-CPython ABI).  Its dlopen pulls
    the base library via its $ORIGIN rpath and registers the dispatch
    hooks there, so symbols from BOTH surfaces resolve through this
    handle.  Training runs on the card unless the parameter string says
    device_type=cpu."""
    global _train_lib
    if _train_lib is None:
        lib = ctypes.CDLL(train_lib_path())
        lib.LGBM_GetLastError.restype = ctypes.c_char_p
        _train_lib = lib
    return _train_lib


def _check_train(rc: int) -> None:
    if rc != 0:
        raise LightGBMError(load_train_lib().LGBM_GetLastError().decode())


def booster_reset_parameter(handle, parameters: str) -> None:
    """LGBM_BoosterResetParameter over a raw training BoosterHandle:
    live-apply "key=value ..." parameters (e.g. learning_rate) so they
    take effect on the next LGBM_BoosterUpdateOneIter."""
    _check_train(load_train_lib().LGBM_BoosterResetParameter(
        handle, parameters.encode()))


def booster_refit(handle, X: np.ndarray, y: np.ndarray) -> None:
    """LGBM_BoosterRefit over a raw training BoosterHandle: keep every
    split, refit leaf values to (X, y) — the handle's model is replaced
    in place (reference Booster.refit semantics, adapted signature: the
    data travels directly instead of pre-computed leaf assignments)."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float32).reshape(-1)
    nrow, ncol = X.shape
    if y.size != nrow:
        raise LightGBMError("label length %d != nrow %d" % (y.size, nrow))
    _check_train(load_train_lib().LGBM_BoosterRefit(
        handle, X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int32(nrow), ctypes.c_int32(ncol)))


def network_init(machines: str, local_listen_port: int = 12400,
                 listen_time_out: int = 120, num_machines: int = 1) -> None:
    """LGBM_NetworkInit: the reference's machine-list bootstrap.  One
    machine is a no-op; more bring the torch.distributed process group up
    (parallel/launch.py: the first machine holds its store, this
    process's rank is its ip:port's position, listen_time_out in minutes
    bounds the bring-up), which tree_learner=data|voting|feature then
    trains over."""
    _check_train(load_train_lib().LGBM_NetworkInit(
        machines.encode(), ctypes.c_int(local_listen_port),
        ctypes.c_int(listen_time_out), ctypes.c_int(num_machines)))


def network_free() -> None:
    """LGBM_NetworkFree: tears the process group down (idempotent,
    reference Network::Dispose)."""
    _check_train(load_train_lib().LGBM_NetworkFree())


def _dtype_code(arr: np.ndarray) -> int:
    code = {np.dtype(np.float32): C_API_DTYPE_FLOAT32,
            np.dtype(np.float64): C_API_DTYPE_FLOAT64,
            np.dtype(np.int32): C_API_DTYPE_INT32,
            np.dtype(np.int64): C_API_DTYPE_INT64}.get(arr.dtype)
    if code is None:
        raise LightGBMError("unsupported dtype %s" % arr.dtype)
    return code


class TrainDataset:
    """ctypes handle over the training-side LGBM_Dataset* surface,
    including the zero-copy streaming ingest block:
    CreateFromMat/CSR/CSC/File, CreateByReference + PushRows[ByCSR],
    GetSubset, SaveBinary and the feature-name accessors."""

    def __init__(self, handle: ctypes.c_void_p):
        self._handle = handle

    def __del__(self, _finalizing=sys.is_finalizing):
        # at interpreter exit the process frees everything itself
        if getattr(self, "_handle", None) and not _finalizing():
            load_train_lib().LGBM_DatasetFree(self._handle)
            self._handle = None

    # -- constructors --------------------------------------------------------
    @staticmethod
    def _ref_handle(reference: Optional["TrainDataset"]):
        return reference._handle if reference is not None else None

    @classmethod
    def from_mat(cls, X: np.ndarray, params: str = "",
                 reference: Optional["TrainDataset"] = None) -> "TrainDataset":
        X = np.ascontiguousarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = np.ascontiguousarray(X, dtype=np.float64)
        h = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_DatasetCreateFromMat(
            X.ctypes.data_as(ctypes.c_void_p), _dtype_code(X),
            ctypes.c_int32(X.shape[0]), ctypes.c_int32(X.shape[1]), 1,
            params.encode(), cls._ref_handle(reference), ctypes.byref(h)))
        return cls(h)

    @classmethod
    def from_csr(cls, indptr, indices, values, num_col: int,
                 params: str = "",
                 reference: Optional["TrainDataset"] = None) -> "TrainDataset":
        indptr = np.ascontiguousarray(indptr)
        if indptr.dtype not in (np.int32, np.int64):
            indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        values = np.ascontiguousarray(values)
        if values.dtype not in (np.float32, np.float64):
            values = np.ascontiguousarray(values, dtype=np.float64)
        h = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_DatasetCreateFromCSR(
            indptr.ctypes.data_as(ctypes.c_void_p), _dtype_code(indptr),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.c_void_p), _dtype_code(values),
            ctypes.c_int64(len(indptr)), ctypes.c_int64(len(values)),
            ctypes.c_int64(num_col), params.encode(),
            cls._ref_handle(reference), ctypes.byref(h)))
        return cls(h)

    @classmethod
    def from_csc(cls, col_ptr, indices, values, num_row: int,
                 params: str = "",
                 reference: Optional["TrainDataset"] = None) -> "TrainDataset":
        col_ptr = np.ascontiguousarray(col_ptr)
        if col_ptr.dtype not in (np.int32, np.int64):
            col_ptr = np.ascontiguousarray(col_ptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        values = np.ascontiguousarray(values)
        if values.dtype not in (np.float32, np.float64):
            values = np.ascontiguousarray(values, dtype=np.float64)
        h = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_DatasetCreateFromCSC(
            col_ptr.ctypes.data_as(ctypes.c_void_p), _dtype_code(col_ptr),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.c_void_p), _dtype_code(values),
            ctypes.c_int64(len(col_ptr)), ctypes.c_int64(len(values)),
            ctypes.c_int64(num_row), params.encode(),
            cls._ref_handle(reference), ctypes.byref(h)))
        return cls(h)

    @classmethod
    def from_file(cls, path: str, params: str = "",
                  reference: Optional["TrainDataset"] = None) -> "TrainDataset":
        h = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_DatasetCreateFromFile(
            path.encode(), params.encode(), cls._ref_handle(reference),
            ctypes.byref(h)))
        return cls(h)

    @classmethod
    def by_reference(cls, reference: "TrainDataset",
                     num_total_rows: int) -> "TrainDataset":
        h = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_DatasetCreateByReference(
            reference._handle, ctypes.c_int64(num_total_rows),
            ctypes.byref(h)))
        return cls(h)

    # -- streaming push ------------------------------------------------------
    def push_rows(self, X: np.ndarray, start_row: int) -> "TrainDataset":
        X = np.ascontiguousarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = np.ascontiguousarray(X, dtype=np.float64)
        _check_train(load_train_lib().LGBM_DatasetPushRows(
            self._handle, X.ctypes.data_as(ctypes.c_void_p), _dtype_code(X),
            ctypes.c_int32(X.shape[0]), ctypes.c_int32(X.shape[1]),
            ctypes.c_int32(start_row)))
        return self

    def push_rows_csr(self, indptr, indices, values, num_col: int,
                      start_row: int) -> "TrainDataset":
        indptr = np.ascontiguousarray(indptr)
        if indptr.dtype not in (np.int32, np.int64):
            indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        values = np.ascontiguousarray(values)
        if values.dtype not in (np.float32, np.float64):
            values = np.ascontiguousarray(values, dtype=np.float64)
        _check_train(load_train_lib().LGBM_DatasetPushRowsByCSR(
            self._handle, indptr.ctypes.data_as(ctypes.c_void_p),
            _dtype_code(indptr),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.c_void_p), _dtype_code(values),
            ctypes.c_int64(len(indptr)), ctypes.c_int64(len(values)),
            ctypes.c_int64(num_col), ctypes.c_int64(start_row)))
        return self

    # -- surface -------------------------------------------------------------
    @classmethod
    def from_mats(cls, mats, params: str = "",
                  reference: Optional["TrainDataset"] = None
                  ) -> "TrainDataset":
        """LGBM_DatasetCreateFromMats: concatenate row blocks sharing a
        column count into one dataset."""
        blocks = [np.ascontiguousarray(m, dtype=np.float64) for m in mats]
        ncol = blocks[0].shape[1]
        ptrs = (ctypes.c_void_p * len(blocks))(
            *[b.ctypes.data_as(ctypes.c_void_p).value for b in blocks])
        rows = (ctypes.c_int32 * len(blocks))(
            *[b.shape[0] for b in blocks])
        h = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_DatasetCreateFromMats(
            ctypes.c_int32(len(blocks)), ptrs, C_API_DTYPE_FLOAT64, rows,
            ctypes.c_int32(ncol), 1, params.encode(),
            cls._ref_handle(reference), ctypes.byref(h)))
        return cls(h)

    def set_field(self, name: str, data) -> "TrainDataset":
        arr = np.ascontiguousarray(data)
        if arr.dtype not in (np.float32, np.float64, np.int32, np.int64):
            arr = np.ascontiguousarray(arr, dtype=np.float32)
        _check_train(load_train_lib().LGBM_DatasetSetField(
            self._handle, name.encode(),
            arr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(arr.size),
            _dtype_code(arr)))
        return self

    def get_field(self, name: str) -> np.ndarray:
        """LGBM_DatasetGetField: label/weight as float32, init_score as
        float64, group as CUMULATIVE int32 query boundaries (the
        reference layout).  The returned array is a COPY — the C buffer
        is only valid until the next get_field call on this handle."""
        out_len = ctypes.c_int(0)
        out_ptr = ctypes.c_void_p()
        out_type = ctypes.c_int(-1)
        _check_train(load_train_lib().LGBM_DatasetGetField(
            self._handle, name.encode(), ctypes.byref(out_len),
            ctypes.byref(out_ptr), ctypes.byref(out_type)))
        dt = {C_API_DTYPE_FLOAT32: np.float32,
              C_API_DTYPE_FLOAT64: np.float64,
              C_API_DTYPE_INT32: np.int32,
              C_API_DTYPE_INT64: np.int64}[out_type.value]
        n = out_len.value
        buf = ctypes.cast(out_ptr,
                          ctypes.POINTER(ctypes.c_char * (n * dt().nbytes)))
        return np.frombuffer(bytes(buf.contents), dtype=dt).copy()

    def feature_num_bin(self, feature_idx: int) -> int:
        """LGBM_DatasetGetFeatureNumBin: bins of one constructed
        feature."""
        out = ctypes.c_int32(0)
        _check_train(load_train_lib().LGBM_DatasetGetFeatureNumBin(
            self._handle, ctypes.c_int(feature_idx), ctypes.byref(out)))
        return out.value

    @property
    def num_data(self) -> int:
        out = ctypes.c_int32(0)
        _check_train(load_train_lib().LGBM_DatasetGetNumData(
            self._handle, ctypes.byref(out)))
        return out.value

    @property
    def num_feature(self) -> int:
        out = ctypes.c_int32(0)
        _check_train(load_train_lib().LGBM_DatasetGetNumFeature(
            self._handle, ctypes.byref(out)))
        return out.value

    def get_subset(self, used_indices, params: str = "") -> "TrainDataset":
        idx = np.ascontiguousarray(used_indices, dtype=np.int32)
        h = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_DatasetGetSubset(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(len(idx)), params.encode(), ctypes.byref(h)))
        return TrainDataset(h)

    def save_binary(self, path: str) -> "TrainDataset":
        _check_train(load_train_lib().LGBM_DatasetSaveBinary(
            self._handle, path.encode()))
        return self

    def dump_text(self, path: str) -> "TrainDataset":
        """LGBM_DatasetDumpText: debug dump — self-describing header
        (num_data/num_features/feature names/bin counts/label presence)
        followed by the post-bundling integer bin matrix, one row per
        data row."""
        _check_train(load_train_lib().LGBM_DatasetDumpText(
            self._handle, path.encode()))
        return self

    def set_feature_names(self, names) -> "TrainDataset":
        arr = (ctypes.c_char_p * len(names))(
            *[str(n).encode() for n in names])
        _check_train(load_train_lib().LGBM_DatasetSetFeatureNames(
            self._handle, arr, ctypes.c_int(len(names))))
        return self

    def get_feature_names(self) -> list:
        n = self.num_feature
        bufs = [ctypes.create_string_buffer(128) for _ in range(n)]
        arr = (ctypes.c_char_p * n)(
            *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
        out_n = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_DatasetGetFeatureNames(
            self._handle, arr, ctypes.byref(out_n)))
        return [bufs[i].value.decode() for i in range(out_n.value)]


class TrainBooster:
    """ctypes handle over the training-side Booster surface
    (LGBM_BoosterCreate / AddValidData / UpdateOneIter[Custom] /
    RollbackOneIter / GetEval*); model IO and predict flow through the
    shared BoosterHandle entry points (NativeBooster's surface works on
    training handles too)."""

    def __init__(self, train_set: TrainDataset, params: str = ""):
        self._train_set = train_set           # keep the dataset alive
        self._handle = ctypes.c_void_p()
        _check_train(load_train_lib().LGBM_BoosterCreate(
            train_set._handle, params.encode(), ctypes.byref(self._handle)))

    def __del__(self, _finalizing=sys.is_finalizing):
        # at interpreter exit the process frees everything itself
        if getattr(self, "_handle", None) and not _finalizing():
            load_train_lib().LGBM_BoosterFree(self._handle)
            self._handle = None

    def add_valid(self, valid_set: TrainDataset) -> "TrainBooster":
        _check_train(load_train_lib().LGBM_BoosterAddValidData(
            self._handle, valid_set._handle))
        return self

    def update(self) -> bool:
        fin = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_BoosterUpdateOneIter(
            self._handle, ctypes.byref(fin)))
        return bool(fin.value)

    def update_custom(self, grad: np.ndarray, hess: np.ndarray) -> bool:
        g = np.ascontiguousarray(grad, dtype=np.float32)
        h = np.ascontiguousarray(hess, dtype=np.float32)
        fin = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_BoosterUpdateOneIterCustom(
            self._handle, g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(fin)))
        return bool(fin.value)

    def rollback_one_iter(self) -> "TrainBooster":
        _check_train(load_train_lib().LGBM_BoosterRollbackOneIter(
            self._handle))
        return self

    @property
    def current_iteration(self) -> int:
        out = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_BoosterGetCurrentIteration(
            self._handle, ctypes.byref(out)))
        return out.value

    def eval_counts(self) -> int:
        out = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_BoosterGetEvalCounts(
            self._handle, ctypes.byref(out)))
        return out.value

    def eval_names(self) -> list:
        n = self.eval_counts()
        bufs = [ctypes.create_string_buffer(128) for _ in range(n)]
        arr = (ctypes.c_char_p * n)(
            *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
        out_n = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_BoosterGetEvalNames(
            self._handle, ctypes.byref(out_n), arr))
        return [bufs[i].value.decode() for i in range(out_n.value)]

    def get_eval(self, data_idx: int = 0) -> np.ndarray:
        n = self.eval_counts()
        out = np.zeros(max(n, 1), dtype=np.float64)
        out_len = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_BoosterGetEval(
            self._handle, ctypes.c_int(data_idx), ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        return out[: out_len.value]

    def model_to_string(self, num_iteration: int = -1) -> str:
        lib = load_train_lib()
        out_len = ctypes.c_int64(0)
        _check_train(lib.LGBM_BoosterSaveModelToString(
            self._handle, num_iteration, 0, ctypes.byref(out_len), None))
        buf = ctypes.create_string_buffer(out_len.value)
        _check_train(lib.LGBM_BoosterSaveModelToString(
            self._handle, num_iteration, out_len.value,
            ctypes.byref(out_len), buf))
        return buf.value.decode()

    # -- inner prediction buffer (reference GetNumPredict/GetPredict) --------
    def num_predict(self, data_idx: int = 0) -> int:
        """LGBM_BoosterGetNumPredict: size of the engine's current score
        buffer for the training data (0) or the data_idx-th valid set."""
        out = ctypes.c_int64(0)
        _check_train(load_train_lib().LGBM_BoosterGetNumPredict(
            self._handle, ctypes.c_int(data_idx), ctypes.byref(out)))
        return out.value

    def get_predict(self, data_idx: int = 0) -> np.ndarray:
        """LGBM_BoosterGetPredict: the incrementally-maintained scores
        with the objective transform applied, [num_class, num_data]
        (class-major, the reference GetPredictAt layout); squeezed to
        [num_data] for single-output objectives."""
        n = self.num_predict(data_idx)
        out = np.zeros(max(n, 1), dtype=np.float64)
        out_len = ctypes.c_int64(0)
        _check_train(load_train_lib().LGBM_BoosterGetPredict(
            self._handle, ctypes.c_int(data_idx), ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        out = out[: out_len.value]
        k = max(self.num_class, 1)
        return out.reshape(k, -1) if k > 1 else out

    @property
    def num_class(self) -> int:
        out = ctypes.c_int(0)
        _check_train(load_train_lib().LGBM_BoosterGetNumClasses(
            self._handle, ctypes.byref(out)))
        return out.value

    def calc_num_predict(self, num_row: int, predict_type: int = 0,
                         num_iteration: int = -1) -> int:
        """LGBM_BoosterCalcNumPredict: doubles a predict over num_row
        rows will write (works on training AND loaded boosters)."""
        out = ctypes.c_int64(0)
        _check_train(load_train_lib().LGBM_BoosterCalcNumPredict(
            self._handle, ctypes.c_int(num_row),
            ctypes.c_int(predict_type), ctypes.c_int(num_iteration),
            ctypes.byref(out)))
        return out.value


class NativeBooster:
    """Minimal handle over the C API, mirroring Booster's predict surface."""

    def __init__(self, model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        lib = load_lib()
        self._handle = ctypes.c_void_p()
        out_iters = ctypes.c_int(0)
        if model_file is not None:
            _check(lib.LGBM_BoosterCreateFromModelfile(
                model_file.encode(), ctypes.byref(out_iters),
                ctypes.byref(self._handle)))
        elif model_str is not None:
            _check(lib.LGBM_BoosterLoadModelFromString(
                model_str.encode(), ctypes.byref(out_iters),
                ctypes.byref(self._handle)))
        else:
            raise ValueError("model_file or model_str required")
        self.num_iterations = out_iters.value

    def __del__(self, _finalizing=sys.is_finalizing):
        # at interpreter exit the process frees everything itself
        if getattr(self, "_handle", None) and not _finalizing():
            load_lib().LGBM_BoosterFree(self._handle)
            self._handle = None

    @property
    def num_class(self) -> int:
        out = ctypes.c_int(0)
        _check(load_lib().LGBM_BoosterGetNumClasses(self._handle,
                                                    ctypes.byref(out)))
        return out.value

    @property
    def num_feature(self) -> int:
        out = ctypes.c_int(0)
        _check(load_lib().LGBM_BoosterGetNumFeature(self._handle,
                                                    ctypes.byref(out)))
        return out.value

    @property
    def num_model_per_iteration(self) -> int:
        """Trees per iteration (LGBM_BoosterNumModelPerIteration): 1 for
        binary/regression, num_class for multiclass."""
        out = ctypes.c_int(0)
        _check(load_lib().LGBM_BoosterNumModelPerIteration(
            self._handle, ctypes.byref(out)))
        return out.value

    @property
    def current_iteration(self) -> int:
        """Completed iterations (LGBM_BoosterGetCurrentIteration)."""
        out = ctypes.c_int(0)
        _check(load_lib().LGBM_BoosterGetCurrentIteration(
            self._handle, ctypes.byref(out)))
        return out.value

    @property
    def num_total_model(self) -> int:
        """Total trees in the booster (LGBM_BoosterNumberOfTotalModel):
        iterations x trees-per-iteration."""
        out = ctypes.c_int(0)
        _check(load_lib().LGBM_BoosterNumberOfTotalModel(
            self._handle, ctypes.byref(out)))
        return out.value

    def feature_names(self) -> list:
        """Model feature names (LGBM_BoosterGetFeatureNames; fixed
        128-byte buffers like the eval-names convention); Column_<i>
        when the model carries none."""
        n = self.num_feature
        bufs = [ctypes.create_string_buffer(128) for _ in range(n)]
        arr = (ctypes.c_char_p * n)(
            *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
        out_n = ctypes.c_int(0)
        _check(load_lib().LGBM_BoosterGetFeatureNames(
            self._handle, ctypes.byref(out_n), arr))
        return [bufs[i].value.decode() for i in range(out_n.value)]

    def predict_single_row(self, row: np.ndarray, raw_score: bool = False,
                           num_iteration: int = -1) -> np.ndarray:
        """Stateless one-row prediction
        (LGBM_BoosterPredictForMatSingleRow).  For hot serving loops use
        FastSingleRowPredictor, which pays schema validation once."""
        row = np.ascontiguousarray(row, dtype=np.float64).reshape(-1)
        out = np.zeros(max(self.num_class, 1), dtype=np.float64)
        out_len = ctypes.c_int64(0)
        ptype = C_API_PREDICT_RAW_SCORE if raw_score else C_API_PREDICT_NORMAL
        _check(load_lib().LGBM_BoosterPredictForMatSingleRow(
            self._handle, row.ctypes.data_as(ctypes.c_void_p),
            C_API_DTYPE_FLOAT64, ctypes.c_int(row.size), 1, ptype,
            ctypes.c_int(num_iteration), b"", ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        return out[: out_len.value]

    def predict_csr(self, indptr, indices, values, num_col: int,
                    raw_score: bool = False,
                    num_iteration: int = -1) -> np.ndarray:
        """Sparse prediction (LGBM_BoosterPredictForCSR): absent entries
        are 0.0."""
        indptr = np.ascontiguousarray(indptr)
        if indptr.dtype not in (np.int32, np.int64):
            indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        values = np.ascontiguousarray(values)
        if values.dtype not in (np.float32, np.float64):
            values = np.ascontiguousarray(values, dtype=np.float64)
        nrow = len(indptr) - 1
        k = self.num_class
        ptype = C_API_PREDICT_RAW_SCORE if raw_score else C_API_PREDICT_NORMAL
        out = np.zeros(nrow * max(k, 1), dtype=np.float64)
        out_len = ctypes.c_int64(0)
        _check(load_lib().LGBM_BoosterPredictForCSR(
            self._handle, indptr.ctypes.data_as(ctypes.c_void_p),
            _dtype_code(indptr),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.c_void_p), _dtype_code(values),
            ctypes.c_int64(len(indptr)), ctypes.c_int64(len(values)),
            ctypes.c_int64(num_col), ptype, ctypes.c_int(num_iteration),
            b"", ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        out = out[: out_len.value]
        per_row = out_len.value // max(nrow, 1)
        return out.reshape(nrow, per_row) if per_row > 1 else out

    def predict_csc(self, col_ptr, indices, values, num_row: int,
                    raw_score: bool = False,
                    num_iteration: int = -1) -> np.ndarray:
        """Column-major sparse prediction (LGBM_BoosterPredictForCSC):
        col_ptr per column, indices carry ROW ids; absent entries are
        0.0.  Bit-identical to transposing to CSR/dense client-side."""
        col_ptr = np.ascontiguousarray(col_ptr)
        if col_ptr.dtype not in (np.int32, np.int64):
            col_ptr = np.ascontiguousarray(col_ptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        values = np.ascontiguousarray(values)
        if values.dtype not in (np.float32, np.float64):
            values = np.ascontiguousarray(values, dtype=np.float64)
        k = self.num_class
        ptype = C_API_PREDICT_RAW_SCORE if raw_score else C_API_PREDICT_NORMAL
        out = np.zeros(num_row * max(k, 1), dtype=np.float64)
        out_len = ctypes.c_int64(0)
        _check(load_lib().LGBM_BoosterPredictForCSC(
            self._handle, col_ptr.ctypes.data_as(ctypes.c_void_p),
            _dtype_code(col_ptr),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.c_void_p), _dtype_code(values),
            ctypes.c_int64(len(col_ptr)), ctypes.c_int64(len(values)),
            ctypes.c_int64(num_row), ptype, ctypes.c_int(num_iteration),
            b"", ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        out = out[: out_len.value]
        per_row = out_len.value // max(num_row, 1)
        return out.reshape(num_row, per_row) if per_row > 1 else out

    def predict_csr_single_row(self, indices, values, num_col: int,
                               raw_score: bool = False,
                               num_iteration: int = -1) -> np.ndarray:
        """One sparse row (LGBM_BoosterPredictForCSRSingleRow): indices/
        values of the non-zero entries; absent entries are 0.0."""
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        values = np.ascontiguousarray(values, dtype=np.float64)
        indptr = np.asarray([0, len(values)], dtype=np.int64)
        k = self.num_class
        ptype = C_API_PREDICT_RAW_SCORE if raw_score else C_API_PREDICT_NORMAL
        out = np.zeros(max(k, 1), dtype=np.float64)
        out_len = ctypes.c_int64(0)
        _check(load_lib().LGBM_BoosterPredictForCSRSingleRow(
            self._handle, indptr.ctypes.data_as(ctypes.c_void_p),
            _dtype_code(indptr),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.c_void_p), _dtype_code(values),
            ctypes.c_int64(2), ctypes.c_int64(len(values)),
            ctypes.c_int64(num_col), ptype, ctypes.c_int(num_iteration),
            b"", ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        return out[: out_len.value]

    def calc_num_predict(self, num_row: int, predict_type: int = 0,
                         num_iteration: int = -1) -> int:
        """LGBM_BoosterCalcNumPredict: the number of doubles a predict
        over num_row rows writes — num_row*num_class for normal/raw,
        num_row*used_trees for leaf indices.  Size predict buffers with
        this instead of duplicating the width arithmetic."""
        out = ctypes.c_int64(0)
        _check(load_lib().LGBM_BoosterCalcNumPredict(
            self._handle, ctypes.c_int(num_row),
            ctypes.c_int(predict_type), ctypes.c_int(num_iteration),
            ctypes.byref(out)))
        return out.value

    def get_leaf_value(self, tree_idx: int, leaf_idx: int) -> float:
        """One leaf's output value (LGBM_BoosterGetLeafValue — the
        Python Booster.get_leaf_output mirror)."""
        out = ctypes.c_double(0.0)
        _check(load_lib().LGBM_BoosterGetLeafValue(
            self._handle, ctypes.c_int(tree_idx), ctypes.c_int(leaf_idx),
            ctypes.byref(out)))
        return out.value

    def set_leaf_value(self, tree_idx: int, leaf_idx: int,
                       value: float) -> None:
        """Patch one leaf in place (LGBM_BoosterSetLeafValue): the
        serving-side patch primitive.  Takes effect on every predict
        entry point AND on SaveModel/model_to_string round-trips (the
        stored model text is patched too)."""
        _check(load_lib().LGBM_BoosterSetLeafValue(
            self._handle, ctypes.c_int(tree_idx), ctypes.c_int(leaf_idx),
            ctypes.c_double(value)))

    def save_model(self, filename: str) -> None:
        _check(load_lib().LGBM_BoosterSaveModel(self._handle, -1,
                                                filename.encode()))

    def model_to_string(self) -> str:
        lib = load_lib()
        out_len = ctypes.c_int64(0)
        _check(lib.LGBM_BoosterSaveModelToString(
            self._handle, -1, 0, ctypes.byref(out_len), None))
        buf = ctypes.create_string_buffer(out_len.value)
        _check(lib.LGBM_BoosterSaveModelToString(
            self._handle, -1, out_len.value, ctypes.byref(out_len), buf))
        return buf.value.decode()

    def dump_model(self, start_iteration: int = 0,
                   num_iteration: int = -1) -> dict:
        """JSON model dump through LGBM_BoosterDumpModel (same recursive
        tree_structure schema as Booster.dump_model), parsed to a dict."""
        import json
        lib = load_lib()
        out_len = ctypes.c_int64(0)
        _check(lib.LGBM_BoosterDumpModel(
            self._handle, start_iteration, num_iteration, 0, 0,
            ctypes.byref(out_len), None))
        buf = ctypes.create_string_buffer(out_len.value)
        _check(lib.LGBM_BoosterDumpModel(
            self._handle, start_iteration, num_iteration, 0, out_len.value,
            ctypes.byref(out_len), buf))
        return json.loads(buf.value.decode())

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Per-feature importance through LGBM_BoosterFeatureImportance
        ('split' counts, 'gain' sums non-negative split gains)."""
        itype = C_API_FEATURE_IMPORTANCE_GAIN if importance_type == "gain" \
            else C_API_FEATURE_IMPORTANCE_SPLIT
        out = np.zeros(self.num_feature, dtype=np.float64)
        _check(load_lib().LGBM_BoosterFeatureImportance(
            self._handle, ctypes.c_int(num_iteration), itype,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
        return out

    def predict_for_file(self, data_path: str, result_path: str,
                         data_has_header: bool = False,
                         raw_score: bool = False, pred_leaf: bool = False,
                         num_iteration: int = -1,
                         parameter: str = "") -> None:
        """File-to-file prediction in pure C (LGBM_BoosterPredictForFile):
        parse, predict and write without any Python in the loop — output
        files are byte-identical to `application.py task=predict` with the
        host predictor."""
        if pred_leaf:
            ptype = C_API_PREDICT_LEAF_INDEX
        else:
            ptype = C_API_PREDICT_RAW_SCORE if raw_score \
                else C_API_PREDICT_NORMAL
        _check(load_lib().LGBM_BoosterPredictForFile(
            self._handle, data_path.encode(),
            1 if data_has_header else 0, ptype,
            ctypes.c_int(num_iteration), parameter.encode(),
            result_path.encode()))

    def predict(self, X: np.ndarray, raw_score: bool = False,
                pred_leaf: bool = False,
                num_iteration: int = -1) -> np.ndarray:
        X = np.ascontiguousarray(X, dtype=np.float64)
        nrow, ncol = X.shape
        k = self.num_class
        iters = self.num_iterations if num_iteration <= 0 \
            else min(num_iteration, self.num_iterations)
        if pred_leaf:
            ptype = C_API_PREDICT_LEAF_INDEX
            # trees used = iters * num_tree_per_iteration (== num_class)
            width = iters * max(1, k)
        else:
            ptype = C_API_PREDICT_RAW_SCORE if raw_score else C_API_PREDICT_NORMAL
            width = k
        out = np.zeros(nrow * max(width, k), dtype=np.float64)
        out_len = ctypes.c_int64(0)
        _check(load_lib().LGBM_BoosterPredictForMat(
            self._handle, X.ctypes.data_as(ctypes.c_void_p),
            C_API_DTYPE_FLOAT64, ctypes.c_int32(nrow), ctypes.c_int32(ncol),
            1, ptype, ctypes.c_int(num_iteration), b"",
            ctypes.byref(out_len), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_double))))
        out = out[:out_len.value]
        per_row = out_len.value // nrow
        return out.reshape(nrow, per_row) if per_row > 1 else out


class FastSingleRowPredictor:
    """Reuse handle over LGBM_BoosterPredictForMatSingleRowFast: schema
    validation and buffers are paid once at construction, each predict()
    is a single C call — the low-latency point-lookup serving path."""

    def __init__(self, booster: NativeBooster, ncol: int,
                 raw_score: bool = False, num_iteration: int = -1):
        lib = load_lib()
        self._booster = booster          # keep the model handle alive
        self._fast = ctypes.c_void_p()
        ptype = C_API_PREDICT_RAW_SCORE if raw_score else C_API_PREDICT_NORMAL
        _check(lib.LGBM_BoosterPredictForMatSingleRowFastInit(
            booster._handle, ptype, C_API_DTYPE_FLOAT64,
            ctypes.c_int32(ncol), b"", ctypes.c_int(num_iteration),
            ctypes.byref(self._fast)))
        self._out = np.zeros(max(booster.num_class, 1), np.float64)
        self._out_ptr = self._out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double))
        self._len = ctypes.c_int64(0)

    def __del__(self, _finalizing=sys.is_finalizing):
        # at interpreter exit the process frees everything itself
        if getattr(self, "_fast", None) and not _finalizing():
            load_lib().LGBM_FastConfigFree(self._fast)
            self._fast = None

    def predict(self, row: np.ndarray) -> np.ndarray:
        row = np.ascontiguousarray(row, dtype=np.float64)
        _check(load_lib().LGBM_BoosterPredictForMatSingleRowFast(
            self._fast, row.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(self._len), self._out_ptr))
        return self._out[: self._len.value].copy()
