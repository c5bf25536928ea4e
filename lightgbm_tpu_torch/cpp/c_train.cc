// Training side of the C ABI for the PyTorch/CUDA package: LGBM_Dataset* /
// LGBM_BoosterCreate / LGBM_BoosterUpdateOneIter[Custom] parity with the
// reference c_api (include/LightGBM/c_api.h:48-460, src/c_api.cpp
// Booster/Dataset sections), driving lightgbm_tpu_torch's training engine
// in-process by embedding CPython.  A copy of cpp/c_train.cc (the JAX
// package's library) that differs only where the packages differ: the
// embedded helpers import lightgbm_tpu_torch, the package is found by
// walking up from this library, the helper module has its own name, the
// model text carries its parameters section (Booster.save_model's file)
// and LGBM_NetworkInit / LGBM_NetworkFree bring the port's
// torch.distributed process group up and down (parallel/launch.py).
//
// Design: the reference's C training surface is a marshalling layer over
// its C++ Booster; ours is a marshalling layer over the port's engine (the
// C caller gets the same CUDA kernels as a Python caller: the card unless
// the parameters say device_type=cpu).  A trained booster carries a native
// Model* cache (c_api.cc) re-parsed from its model text after every
// update, so every existing prediction/save entry point serves trained
// and loaded boosters with the exact same hardware-validated code.
//
// The embedded interpreter initializes lazily on the first training
// call; prediction-only users never start Python.  All entry points are
// GIL-correct (PyGILState_Ensure/Release) and may be called from any
// thread.
#include "lightgbm_tpu_c_api.h"
#include "c_internal.h"

#include <Python.h>
#include <dlfcn.h>
#include <unistd.h>

#include <atomic>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <string>

namespace {

using lgbm_tpu_internal::kTrainBoosterMagic;
using lgbm_tpu_internal::kTrainDatasetMagic;
using lgbm_tpu_internal::HandleMagic;
using lgbm_tpu_internal::SetLastError;

struct TrainDataset {
  const uint32_t magic = kTrainDatasetMagic;
  PyObject* ds = nullptr;  // lightgbm_tpu_torch.Dataset
  // GetField contract: the returned pointer stays valid until the next
  // GetField on this handle (or DatasetFree) — the bytes live here
  std::string field_buf;
};

struct TrainBooster {
  const uint32_t magic = kTrainBoosterMagic;
  PyObject* bst = nullptr;      // lightgbm_tpu_torch.Booster
  void* native = nullptr;       // cached LGBM_BoosterLoadModelFromString
  std::atomic<bool> dirty{true};  // model changed since last native sync
  std::mutex sync_mu;           // serializes the parse-and-swap itself
  // Reader/writer guard on the cached Model*: every predict/save holds it
  // SHARED for the whole time it dereferences the pointer (taken inside
  // TrainBoosterNative, released via the booster_native_release hook), and
  // the resync takes it EXCLUSIVE only around the free/swap — so an
  // UpdateOneIter racing an in-flight predict can no longer free the
  // model under the reader, making the header's "any thread" contract
  // actually true (the reference c_api guards Booster the same way).
  std::shared_mutex model_mu;
};

// Helper functions executed inside the embedded interpreter.  Keeping the
// marshalling in Python keeps the C side to plain PyObject_CallMethod
// calls; everything here routes straight into the public package API.
const char* kHelperSource = R"PY(
import numpy as np
import lightgbm_tpu_torch as lgb


def _params(s):
    out = {}
    for tok in (s or '').replace('\t', ' ').replace(',', ' ').split():
        if '=' in tok:
            k, v = tok.split('=', 1)
            out[k] = v
    return out


def dataset_from_file(fname, params, ref):
    return lgb.Dataset(fname, reference=ref, params=_params(params))


def dataset_from_mat(mv, dtype_code, nrow, ncol, is_row_major, params, ref):
    dt = np.float32 if dtype_code == 0 else np.float64
    a = np.frombuffer(mv, dtype=dt)
    a = a.reshape(nrow, ncol) if is_row_major else a.reshape(ncol, nrow).T
    return lgb.Dataset(np.array(a, copy=True), reference=ref,
                       params=_params(params))


def dataset_set_field(ds, name, mv, dtype_code):
    dt = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}[dtype_code]
    ds.set_field(name, np.frombuffer(mv, dtype=dt).copy())


def dataset_get_field(ds, name):
    ds.construct()
    v = ds.get_field(name)
    if v is None:
        raise KeyError('field %r is not set on this dataset' % name)
    v = np.asarray(v)
    if name in ('group', 'query'):
        # reference GetField('group') returns CUMULATIVE query
        # boundaries (num_queries + 1 int32), not the sizes SetField took
        v = np.concatenate([[0], np.cumsum(v.astype(np.int64))]) \
            .astype(np.int32)
        code = 2
    elif name == 'init_score':
        v = np.ascontiguousarray(v, dtype=np.float64).reshape(-1)
        code = 1
    else:
        v = np.ascontiguousarray(v, dtype=np.float32).reshape(-1)
        code = 0
    return (v.tobytes(), code, int(v.size))


def dataset_feature_num_bin(ds, i):
    ds.construct()
    mappers = ds.binned.bin_mappers
    if i < 0 or i >= len(mappers):
        raise IndexError('feature index %d out of range (%d features)'
                         % (i, len(mappers)))
    return int(mappers[i].num_bin)


def dataset_from_mats(mvs, dtype_code, nrows, ncol, is_row_major, params,
                      ref):
    dt = np.float32 if dtype_code == 0 else np.float64
    parts = []
    for mv, nr in zip(mvs, nrows):
        a = np.frombuffer(mv, dtype=dt)
        a = a.reshape(nr, ncol) if is_row_major else a.reshape(ncol, nr).T
        parts.append(np.array(a, copy=True))
    X = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    return lgb.Dataset(X, reference=ref, params=_params(params))


def _as_np(mv, dtype_code, count):
    # copy: the C caller's buffer lifetime ends when the entry point
    # returns, but the chunk lives in the stream builder until finalize
    dt = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}[dtype_code]
    return np.frombuffer(mv, dtype=dt, count=count).copy()


def _stream_builder(params, num_features=None, reference=None,
                    num_total_rows=None):
    from lightgbm_tpu_torch.io.stream import StreamingDatasetBuilder
    return StreamingDatasetBuilder(params=params, num_features=num_features,
                                   reference=reference,
                                   num_total_rows=num_total_rows)


def dataset_from_csr(ipmv, ipcode, idxmv, dmv, dcode, nindptr, nelem,
                     num_col, params, ref):
    p = _params(params)
    indptr = _as_np(ipmv, ipcode, nindptr).astype(np.int64)
    indices = _as_np(idxmv, 2, nelem)
    values = _as_np(dmv, dcode, nelem).astype(np.float64)
    b = _stream_builder(p, num_features=int(num_col))
    b.push_csr(indptr, indices, values, int(num_col))
    return lgb.Dataset(b, reference=ref, params=p)


def dataset_from_csc(cpmv, cpcode, idxmv, dmv, dcode, ncol_ptr, nelem,
                     num_row, params, ref):
    p = _params(params)
    col_ptr = _as_np(cpmv, cpcode, ncol_ptr).astype(np.int64)
    indices = _as_np(idxmv, 2, nelem)
    values = _as_np(dmv, dcode, nelem).astype(np.float64)
    b = _stream_builder(p, num_features=len(col_ptr) - 1)
    b.push_csc(col_ptr, indices, values, int(num_row))
    return lgb.Dataset(b, reference=ref, params=p)


def dataset_by_reference(ref, num_total_row):
    ref.construct()
    p = dict(ref.params)
    b = _stream_builder(p, reference=ref, num_total_rows=int(num_total_row))
    return lgb.Dataset(b, reference=ref, params=p)


def dataset_push_rows(ds, mv, dcode, nrow, ncol, start_row):
    a = _as_np(mv, dcode, nrow * ncol).astype(np.float64)
    ds.push_rows(a.reshape(nrow, ncol), start_row=int(start_row))


def dataset_push_rows_csr(ds, ipmv, ipcode, idxmv, dmv, dcode, nindptr,
                          nelem, num_col, start_row):
    indptr = _as_np(ipmv, ipcode, nindptr).astype(np.int64)
    indices = _as_np(idxmv, 2, nelem)
    values = _as_np(dmv, dcode, nelem).astype(np.float64)
    ds.push_rows_csr(indptr, indices, values, int(num_col),
                     start_row=int(start_row))


def dataset_get_subset(ds, idxmv, n, params):
    idx = np.frombuffer(idxmv, dtype=np.int32, count=n).astype(np.int64)
    ds.construct()
    return lgb.Dataset._from_binned(ds.binned.subset(idx),
                                    params=_params(params) or dict(ds.params))


def dataset_save_binary(ds, fname):
    ds.construct()
    ds.save_binary(fname)


def dataset_dump_text(ds, fname):
    # reference LGBM_DatasetDumpText, adapted content: the dump shows
    # what training actually consumes — the post-bundling integer bin
    # matrix — under a small self-describing header
    ds.construct()
    b = ds.binned
    with open(fname, 'w') as fh:
        fh.write('num_data: %d\n' % int(b.num_data))
        fh.write('num_features: %d\n' % int(b.num_total_features))
        fh.write('feature_names: %s\n' % ','.join(b.feature_names))
        fh.write('num_bins: %s\n'
                 % ','.join(str(int(m.num_bin)) for m in b.bin_mappers))
        fh.write('storage_rows: %d\n' % int(b.bins.shape[0]))
        fh.write('has_label: %d\n'
                 % (0 if b.metadata.label is None else 1))
        fh.write('bin_data:\n')
        np.savetxt(fh, b.bins[:, :int(b.num_data)].T, fmt='%d')


def dataset_set_feature_names(ds, names):
    ds.set_feature_name([str(s) for s in names])


def dataset_feature_names(ds):
    ds.construct()
    return [str(s) for s in ds.binned.feature_names]


def dataset_num_data(ds):
    ds.construct()
    return int(ds.num_data())


def dataset_num_feature(ds):
    ds.construct()
    return int(ds.num_feature())


def booster_create(ds, params):
    return lgb.Booster(params=_params(params), train_set=ds)


def booster_add_valid(bst, ds, name):
    bst.add_valid(ds, name)


def booster_update(bst):
    return 1 if bst.update() else 0


def booster_update_custom(bst, gmv, hmv, n):
    g = np.frombuffer(gmv, dtype=np.float32, count=n).copy()
    h = np.frombuffer(hmv, dtype=np.float32, count=n).copy()
    return 1 if bst.update(fobj=lambda preds, ds: (g, h)) else 0


def booster_rollback(bst):
    bst.rollback_one_iter()


def booster_reset_parameter(bst, params):
    bst.reset_parameter(_params(params))


def booster_refit(bst, mv, lmv, nrow, ncol):
    X = np.frombuffer(mv, dtype=np.float64).reshape(nrow, ncol)
    y = np.frombuffer(lmv, dtype=np.float32, count=nrow).astype(np.float64)
    return bst.refit(np.array(X, copy=True), y)


def booster_current_iteration(bst):
    return int(bst.current_iteration())


def booster_model_string(bst, num_iteration):
    # what Booster.save_model writes, the parameters section included (as
    # the reference's LGBM_BoosterSaveModel[ToString] write it), so a C
    # caller's model file is the Python caller's and the CLI's byte for
    # byte
    return bst._model.save_model_to_string(
        0, num_iteration, parameters=bst.config.to_string()) + \
        bst._pandas_categorical_line()


def booster_get_eval(bst, data_idx):
    res = bst.eval_train() if data_idx == 0 else bst.eval_valid()
    if data_idx > 0:
        names = []
        for r in res:
            if r[0] not in names:
                names.append(r[0])
        if data_idx - 1 >= len(names):
            raise IndexError('data_idx %d out of range' % data_idx)
        want = names[data_idx - 1]
        res = [r for r in res if r[0] == want]
    return [float(r[2]) for r in res]


def booster_eval_names(bst):
    return [str(m.name) for m in bst._engine.train_metrics]


def booster_inner_predict(bst, data_idx):
    # reference GBDT::GetPredictAt: the scores the engine already
    # maintains for the training data (idx 0) or a validation set, with
    # the objective transform applied, laid out class-major [K*N]
    if data_idx == 0:
        raw = np.asarray(bst._engine.raw_train_score(), dtype=np.float64)
    else:
        n_valid = len(bst._valid_data)
        if data_idx - 1 >= n_valid:
            raise IndexError('data_idx %d out of range (%d valid sets)'
                             % (data_idx, n_valid))
        raw = np.asarray(bst._engine.raw_valid_score(data_idx - 1),
                         dtype=np.float64)
    obj = bst._objective
    if obj is not None:
        conv = np.asarray(obj.convert_output(raw.T), dtype=np.float64)
        raw = conv.T if conv.ndim == 2 else conv.reshape(1, -1)
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    return (raw.tobytes(), int(raw.size))


def booster_grad_len(bst):
    ds = bst.train_set
    ds.construct()
    k = getattr(bst._engine, 'num_tree_per_iteration', 1)
    return int(ds.num_data()) * int(k)


def network_init(machines, local_listen_port, listen_time_out,
                 num_machines):
    if num_machines <= 1:
        return 0
    from lightgbm_tpu_torch.parallel import launch
    return launch.init_distributed(
        machines=machines, local_listen_port=local_listen_port,
        timeout_s=max(int(listen_time_out), 1) * 60)


def network_free():
    from lightgbm_tpu_torch.parallel import launch
    launch.shutdown_distributed()
    return 0
)PY";

PyObject* g_helpers = nullptr;  // module dict holding the helpers
std::once_flag g_py_once;
bool g_py_ok = false;
void InitPython();

std::string PyErrString() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

void InitPython() {
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  // make the package importable: LIGHTGBM_TPU_ROOT wins, then the first
  // directory above this shared library that holds lightgbm_tpu_torch/
  // (the repo root for a build under build/capi/<hash>/, located via
  // dladdr); a pip install resolves through the normal sys.path instead.
  // The candidate paths travel as REAL Python objects
  // (PyUnicode_DecodeFSDefault + PySys_SetObject), never spliced into
  // source text — a quote run or trailing backslash in a path must stay
  // path data, not become code inside the embedded interpreter.
  {
    PyObject* cands = PyList_New(0);
    auto append_path = [&](const std::string& p) {
      PyObject* s = PyUnicode_DecodeFSDefault(p.c_str());
      if (s != nullptr) {
        PyList_Append(cands, s);
        Py_DECREF(s);
      } else {
        PyErr_Clear();  // undecodable path: skip the candidate
      }
    };
    const char* env_root = std::getenv("LIGHTGBM_TPU_ROOT");
    if (env_root != nullptr) append_path(env_root);
    Dl_info info;
    if (dladdr(reinterpret_cast<void*>(&InitPython), &info) != 0 &&
        info.dli_fname != nullptr) {
      std::string dir(info.dli_fname);
      for (auto cut = dir.find_last_of('/'); cut != std::string::npos &&
                                             cut > 0;
           cut = dir.find_last_of('/')) {
        dir = dir.substr(0, cut);
        std::string pkg = dir + "/lightgbm_tpu_torch/__init__.py";
        if (access(pkg.c_str(), F_OK) == 0) {
          append_path(dir);
          break;
        }
      }
    }
    PySys_SetObject("_lgbm_tpu_torch_path_candidates", cands);
    Py_DECREF(cands);
    PyRun_SimpleString(
        "import os, sys\n"
        "for _cand in sys._lgbm_tpu_torch_path_candidates:\n"
        "    if _cand and os.path.isdir(_cand) and _cand not in sys.path:\n"
        "        sys.path.insert(0, _cand)\n"
        "del sys._lgbm_tpu_torch_path_candidates\n");
  }
  // its own name: a process that holds both packages' training libraries
  // tells their helper modules apart
  PyObject* mod = PyModule_New("_lgbm_tpu_torch_c_helpers");
  PyObject* mdict = PyModule_GetDict(mod);
  PyDict_SetItemString(mdict, "__builtins__", PyEval_GetBuiltins());
  PyObject* res = PyRun_String(kHelperSource, Py_file_input, mdict, mdict);
  if (res == nullptr) {
    SetLastError("failed to initialize embedded training helpers: " +
                 PyErrString());
    Py_DECREF(mod);
  } else {
    Py_DECREF(res);
    g_helpers = mod;  // keep the module (and its dict) alive forever
    g_py_ok = true;
  }
  PyGILState_Release(g);
  if (we_initialized) {
    // release the GIL acquired by Py_Initialize so other threads can use
    // PyGILState_Ensure; the interpreter stays alive for the process
    PyEval_SaveThread();
  }
}

// RAII: ensure interpreter + helpers + GIL for the current scope.
struct PyScope {
  PyGILState_STATE g;
  bool ok;
  PyScope() : ok(false) {
    std::call_once(g_py_once, InitPython);
    if (!g_py_ok) return;
    g = PyGILState_Ensure();
    ok = true;
  }
  ~PyScope() {
    if (ok) PyGILState_Release(g);
  }
};

PyObject* Helper(const char* name) {
  return PyObject_GetAttrString(g_helpers, name);
}

// Call helpers[name](*args) with a fresh reference result; nullptr on
// error (message recorded).
PyObject* CallHelper(const char* name, PyObject* args) {
  PyObject* fn = Helper(name);
  PyObject* out = nullptr;
  if (fn != nullptr) {
    out = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
  }
  if (out == nullptr) SetLastError(std::string(name) + ": " + PyErrString());
  Py_XDECREF(args);
  return out;
}

int FailPy(const char* where) {
  SetLastError(std::string(where) + ": " + PyErrString());
  PyErr_Clear();
  return -1;
}

TrainBooster* AsTrain(BoosterHandle h) { return static_cast<TrainBooster*>(h); }
TrainDataset* AsDataset(DatasetHandle h) {
  if (HandleMagic(h) != kTrainDatasetMagic) return nullptr;
  return static_cast<TrainDataset*>(h);
}

// Returns the current native model with tb->model_mu held SHARED (see
// TrainHooks::booster_native); nullptr on error (nothing held).
void* TrainBoosterNative(void* h) {
  TrainBooster* tb = AsTrain(h);
  {
    // serialize the parse-and-swap: two concurrent first-predicts must
    // not both parse-and-free (use-after-free / double-free); after the
    // winner syncs, the loser sees !dirty and reuses the cache
    std::lock_guard<std::mutex> sync(tb->sync_mu);
    if (tb->dirty.load() || tb->native == nullptr) {
      PyScope py;
      if (!py.ok) return nullptr;
      PyObject* s = CallHelper("booster_model_string",
                               Py_BuildValue("(Oi)", tb->bst, -1));
      if (s == nullptr) return nullptr;
      const char* text = PyUnicode_AsUTF8(s);
      void* fresh = nullptr;
      int num_iter = 0;
      int rc = text == nullptr
                   ? -1
                   : LGBM_BoosterLoadModelFromString(text, &num_iter, &fresh);
      Py_DECREF(s);
      if (rc != 0) return nullptr;
      {
        // the free waits for every in-flight reader of the OLD model
        std::unique_lock<std::shared_mutex> w(tb->model_mu);
        if (tb->native != nullptr) LGBM_BoosterFree(tb->native);
        tb->native = fresh;
      }
      tb->dirty.store(false);
    }
  }
  // reader lock for the caller's whole predict/save; a resync triggered
  // by a concurrent update blocks at the unique_lock above until released
  tb->model_mu.lock_shared();
  void* native = tb->native;
  if (native == nullptr) {  // raced a failed resync
    tb->model_mu.unlock_shared();
    SetLastError("native model cache is empty");
  }
  return native;
}

void TrainBoosterNativeRelease(void* h) {
  AsTrain(h)->model_mu.unlock_shared();
}

int TrainBoosterFree(void* h) {
  TrainBooster* tb = AsTrain(h);
  if (tb->native != nullptr) LGBM_BoosterFree(tb->native);
  if (tb->bst != nullptr) {
    PyScope py;
    if (py.ok) Py_DECREF(tb->bst);
  }
  delete tb;
  return 0;
}

int TrainBoosterCurrentIteration(void* h, int* out) {
  PyScope py;
  if (!py.ok) return -1;
  PyObject* r = CallHelper("booster_current_iteration",
                           Py_BuildValue("(O)", AsTrain(h)->bst));
  if (r == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

// registered into the base library when this library loads
const lgbm_tpu_internal::TrainHooks g_hooks = {
    &TrainBoosterNative, &TrainBoosterNativeRelease, &TrainBoosterFree,
    &TrainBoosterCurrentIteration};

__attribute__((constructor)) void RegisterHooks() {
  lgbm_tpu_internal::RegisterTrainHooks(&g_hooks);
}

}  // namespace

extern "C" {

int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               DatasetHandle reference, DatasetHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* ref = AsDataset(reference);
  PyObject* r = CallHelper(
      "dataset_from_file",
      Py_BuildValue("(ssO)", filename, parameters ? parameters : "",
                    ref ? ref->ds : Py_None));
  if (r == nullptr) return -1;
  TrainDataset* d = new TrainDataset;
  d->ds = r;
  *out = d;
  return 0;
}

int LGBM_DatasetCreateFromMat(const void* data, int data_type, int32_t nrow,
                              int32_t ncol, int is_row_major,
                              const char* parameters, DatasetHandle reference,
                              DatasetHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  if (data_type != C_API_DTYPE_FLOAT32 && data_type != C_API_DTYPE_FLOAT64) {
    SetLastError("data_type must be float32/float64");
    return -1;
  }
  Py_ssize_t esz = data_type == C_API_DTYPE_FLOAT32 ? 4 : 8;
  PyObject* mv = PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data)),
      static_cast<Py_ssize_t>(nrow) * ncol * esz, PyBUF_READ);
  if (mv == nullptr) return FailPy("LGBM_DatasetCreateFromMat");
  TrainDataset* ref = AsDataset(reference);
  PyObject* r = CallHelper(
      "dataset_from_mat",
      Py_BuildValue("(NiiiisO)", mv, data_type, nrow, ncol, is_row_major,
                    parameters ? parameters : "", ref ? ref->ds : Py_None));
  if (r == nullptr) return -1;
  TrainDataset* d = new TrainDataset;
  d->ds = r;
  *out = d;
  return 0;
}

namespace {

// read-only memoryview over a C buffer; nullptr on failure
PyObject* MemView(const void* p, Py_ssize_t bytes) {
  return PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(p)), bytes, PyBUF_READ);
}

Py_ssize_t DTypeSize(int code) {
  return (code == C_API_DTYPE_FLOAT64 || code == C_API_DTYPE_INT64) ? 8 : 4;
}

bool CheckIntCode(int code, const char* what) {
  if (code != C_API_DTYPE_INT32 && code != C_API_DTYPE_INT64) {
    SetLastError(std::string(what) + " must be C_API_DTYPE_INT32/INT64");
    return false;
  }
  return true;
}

bool CheckFloatCode(int code, const char* what) {
  if (code != C_API_DTYPE_FLOAT32 && code != C_API_DTYPE_FLOAT64) {
    SetLastError(std::string(what) + " must be float32/float64");
    return false;
  }
  return true;
}

// shared CSR marshalling for CreateFromCSR / PushRowsByCSR: builds the
// three memoryviews or records an error and returns false
bool CsrViews(const void* indptr, int indptr_type, const int32_t* indices,
              const void* data, int data_type, int64_t nindptr,
              int64_t nelem, PyObject** ipmv, PyObject** idxmv,
              PyObject** dmv, const char* what) {
  if (!CheckIntCode(indptr_type, "indptr_type") ||
      !CheckFloatCode(data_type, "data_type"))
    return false;
  *ipmv = MemView(indptr, nindptr * DTypeSize(indptr_type));
  *idxmv = MemView(indices, nelem * 4);
  *dmv = MemView(data, nelem * DTypeSize(data_type));
  if (*ipmv == nullptr || *idxmv == nullptr || *dmv == nullptr) {
    Py_XDECREF(*ipmv);
    Py_XDECREF(*idxmv);
    Py_XDECREF(*dmv);
    SetLastError(std::string(what) + ": cannot wrap input buffers");
    PyErr_Clear();
    return false;
  }
  return true;
}

int WrapNewDataset(PyObject* r, DatasetHandle* out) {
  if (r == nullptr) return -1;
  TrainDataset* d = new TrainDataset;
  d->ds = r;
  *out = d;
  return 0;
}

}  // namespace

int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr, int64_t nelem,
                              int64_t num_col, const char* parameters,
                              DatasetHandle reference, DatasetHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  PyObject *ipmv, *idxmv, *dmv;
  if (!CsrViews(indptr, indptr_type, indices, data, data_type, nindptr,
                nelem, &ipmv, &idxmv, &dmv, "LGBM_DatasetCreateFromCSR"))
    return -1;
  TrainDataset* ref = AsDataset(reference);
  PyObject* r = CallHelper(
      "dataset_from_csr",
      Py_BuildValue("(NiNNiLLLsO)", ipmv, indptr_type, idxmv, dmv, data_type,
                    static_cast<long long>(nindptr),
                    static_cast<long long>(nelem),
                    static_cast<long long>(num_col),
                    parameters ? parameters : "",
                    ref ? ref->ds : Py_None));
  return WrapNewDataset(r, out);
}

int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, const char* parameters,
                              DatasetHandle reference, DatasetHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  PyObject *cpmv, *idxmv, *dmv;
  if (!CsrViews(col_ptr, col_ptr_type, indices, data, data_type, ncol_ptr,
                nelem, &cpmv, &idxmv, &dmv, "LGBM_DatasetCreateFromCSC"))
    return -1;
  TrainDataset* ref = AsDataset(reference);
  PyObject* r = CallHelper(
      "dataset_from_csc",
      Py_BuildValue("(NiNNiLLLsO)", cpmv, col_ptr_type, idxmv, dmv, data_type,
                    static_cast<long long>(ncol_ptr),
                    static_cast<long long>(nelem),
                    static_cast<long long>(num_row),
                    parameters ? parameters : "",
                    ref ? ref->ds : Py_None));
  return WrapNewDataset(r, out);
}

int LGBM_DatasetCreateByReference(DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* ref = AsDataset(reference);
  if (ref == nullptr) {
    SetLastError("LGBM_DatasetCreateByReference needs a dataset handle "
                 "as reference");
    return -1;
  }
  PyObject* r = CallHelper(
      "dataset_by_reference",
      Py_BuildValue("(OL)", ref->ds, static_cast<long long>(num_total_row)));
  return WrapNewDataset(r, out);
}

int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(dataset);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  if (!CheckFloatCode(data_type, "data_type")) return -1;
  PyObject* mv = MemView(data, static_cast<Py_ssize_t>(nrow) * ncol *
                                   DTypeSize(data_type));
  if (mv == nullptr) return FailPy("LGBM_DatasetPushRows");
  PyObject* r = CallHelper(
      "dataset_push_rows",
      Py_BuildValue("(ONiiii)", d->ds, mv, data_type, nrow, ncol, start_row));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(dataset);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject *ipmv, *idxmv, *dmv;
  if (!CsrViews(indptr, indptr_type, indices, data, data_type, nindptr,
                nelem, &ipmv, &idxmv, &dmv, "LGBM_DatasetPushRowsByCSR"))
    return -1;
  PyObject* r = CallHelper(
      "dataset_push_rows_csr",
      Py_BuildValue("(ONiNNiLLLL)", d->ds, ipmv, indptr_type, idxmv, dmv,
                    data_type, static_cast<long long>(nindptr),
                    static_cast<long long>(nelem),
                    static_cast<long long>(num_col),
                    static_cast<long long>(start_row)));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetSubset(DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* mv = MemView(used_row_indices,
                         static_cast<Py_ssize_t>(num_used_row_indices) * 4);
  if (mv == nullptr) return FailPy("LGBM_DatasetGetSubset");
  PyObject* r = CallHelper(
      "dataset_get_subset",
      Py_BuildValue("(ONis)", d->ds, mv, num_used_row_indices,
                    parameters ? parameters : ""));
  return WrapNewDataset(r, out);
}

int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper("dataset_save_binary",
                           Py_BuildValue("(Os)", d->ds, filename));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetDumpText(DatasetHandle handle, const char* filename) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper("dataset_dump_text",
                           Py_BuildValue("(Os)", d->ds, filename));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* names = PyList_New(0);
  for (int i = 0; i < num_feature_names; ++i) {
    PyObject* s = PyUnicode_DecodeFSDefault(
        feature_names[i] != nullptr ? feature_names[i] : "");
    if (s == nullptr) {
      Py_DECREF(names);
      return FailPy("LGBM_DatasetSetFeatureNames");
    }
    PyList_Append(names, s);
    Py_DECREF(s);
  }
  PyObject* r = CallHelper("dataset_set_feature_names",
                           Py_BuildValue("(ON)", d->ds, names));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetFeatureNames(DatasetHandle handle, char** feature_names,
                                int* num_feature_names) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper("dataset_feature_names",
                           Py_BuildValue("(O)", d->ds));
  if (r == nullptr) return -1;
  Py_ssize_t n = PyList_Size(r);
  *num_feature_names = static_cast<int>(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* name = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    // 128-byte caller buffers (the GetEvalNames contract)
    std::strncpy(feature_names[i], name != nullptr ? name : "", 127);
    feature_names[i][127] = '\0';
  }
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int num_element, int type) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  Py_ssize_t esz = (type == C_API_DTYPE_FLOAT64 || type == C_API_DTYPE_INT64)
                       ? 8
                       : 4;
  PyObject* mv = PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(field_data)),
      static_cast<Py_ssize_t>(num_element) * esz, PyBUF_READ);
  if (mv == nullptr) return FailPy("LGBM_DatasetSetField");
  PyObject* r = CallHelper(
      "dataset_set_field",
      Py_BuildValue("(OsNi)", d->ds, field_name, mv, type));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr,
                         int* out_type) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper(
      "dataset_get_field",
      Py_BuildValue("(Os)", d->ds, field_name ? field_name : ""));
  if (r == nullptr) return -1;
  PyObject* bytes_obj = PyTuple_GetItem(r, 0);
  char* buf = nullptr;
  Py_ssize_t nbytes = 0;
  if (PyBytes_AsStringAndSize(bytes_obj, &buf, &nbytes) != 0) {
    Py_DECREF(r);
    return FailPy("LGBM_DatasetGetField");
  }
  d->field_buf.assign(buf, static_cast<size_t>(nbytes));
  *out_type = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
  *out_len = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 2)));
  *out_ptr = d->field_buf.data();
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetFeatureNumBin(DatasetHandle handle, int feature_idx,
                                 int32_t* out) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper("dataset_feature_num_bin",
                           Py_BuildValue("(Oi)", d->ds, feature_idx));
  if (r == nullptr) return -1;
  *out = static_cast<int32_t>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data,
                               int data_type, int32_t* nrow, int32_t ncol,
                               int is_row_major, const char* parameters,
                               DatasetHandle reference,
                               DatasetHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  if (nmat <= 0 || data == nullptr || nrow == nullptr) {
    SetLastError("LGBM_DatasetCreateFromMats needs nmat > 0 blocks");
    return -1;
  }
  if (!CheckFloatCode(data_type, "data_type")) return -1;
  Py_ssize_t esz = DTypeSize(data_type);
  PyObject* mvs = PyList_New(0);
  PyObject* rows = PyList_New(0);
  for (int32_t i = 0; i < nmat; ++i) {
    PyObject* mv = MemView(
        data[i], static_cast<Py_ssize_t>(nrow[i]) * ncol * esz);
    if (mv == nullptr) {
      Py_DECREF(mvs);
      Py_DECREF(rows);
      return FailPy("LGBM_DatasetCreateFromMats");
    }
    PyList_Append(mvs, mv);
    Py_DECREF(mv);
    PyObject* n = PyLong_FromLong(nrow[i]);
    PyList_Append(rows, n);
    Py_DECREF(n);
  }
  TrainDataset* ref = AsDataset(reference);
  PyObject* r = CallHelper(
      "dataset_from_mats",
      Py_BuildValue("(NiNiisO)", mvs, data_type, rows, ncol, is_row_major,
                    parameters ? parameters : "",
                    ref ? ref->ds : Py_None));
  return WrapNewDataset(r, out);
}

int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper("dataset_num_data", Py_BuildValue("(O)", d->ds));
  if (r == nullptr) return -1;
  *out = static_cast<int32_t>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) {
    SetLastError("not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper("dataset_num_feature",
                           Py_BuildValue("(O)", d->ds));
  if (r == nullptr) return -1;
  *out = static_cast<int32_t>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_DatasetFree(DatasetHandle handle) {
  TrainDataset* d = AsDataset(handle);
  if (d == nullptr) return 0;
  PyScope py;
  if (py.ok) Py_XDECREF(d->ds);
  delete d;
  return 0;
}

int LGBM_BoosterCreate(DatasetHandle train_data, const char* parameters,
                       BoosterHandle* out) {
  PyScope py;
  if (!py.ok) return -1;
  TrainDataset* d = AsDataset(train_data);
  if (d == nullptr) {
    SetLastError("train_data is not a dataset handle");
    return -1;
  }
  PyObject* r = CallHelper(
      "booster_create",
      Py_BuildValue("(Os)", d->ds, parameters ? parameters : ""));
  if (r == nullptr) return -1;
  TrainBooster* b = new TrainBooster;
  b->bst = r;
  *out = b;
  return 0;
}

int LGBM_BoosterAddValidData(BoosterHandle handle, DatasetHandle valid_data) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  TrainDataset* d = AsDataset(valid_data);
  if (d == nullptr) {
    SetLastError("valid_data is not a dataset handle");
    return -1;
  }
  TrainBooster* tb = AsTrain(handle);
  PyObject* r = CallHelper("booster_add_valid",
                           Py_BuildValue("(OOs)", tb->bst, d->ds, "valid"));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  TrainBooster* tb = AsTrain(handle);
  PyObject* r = CallHelper("booster_update", Py_BuildValue("(O)", tb->bst));
  if (r == nullptr) return -1;
  if (is_finished) *is_finished = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  tb->dirty = true;
  return 0;
}

int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle, const float* grad,
                                    const float* hess, int* is_finished) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  TrainBooster* tb = AsTrain(handle);
  // gradient length = num_data * num_class, resolved on the python side
  PyObject* nobj = CallHelper("booster_grad_len",
                              Py_BuildValue("(O)", tb->bst));
  if (nobj == nullptr) return -1;
  long n = PyLong_AsLong(nobj);
  Py_DECREF(nobj);
  if (n <= 0) {
    SetLastError("cannot determine gradient length for custom update");
    return -1;
  }
  Py_ssize_t bytes = static_cast<Py_ssize_t>(n) * 4;
  PyObject* gmv = PyMemoryView_FromMemory(
      const_cast<char*>(reinterpret_cast<const char*>(grad)), bytes,
      PyBUF_READ);
  PyObject* hmv = PyMemoryView_FromMemory(
      const_cast<char*>(reinterpret_cast<const char*>(hess)), bytes,
      PyBUF_READ);
  if (gmv == nullptr || hmv == nullptr) {
    Py_XDECREF(gmv);
    Py_XDECREF(hmv);
    return FailPy("LGBM_BoosterUpdateOneIterCustom");
  }
  PyObject* r = CallHelper(
      "booster_update_custom",
      Py_BuildValue("(ONNl)", tb->bst, gmv, hmv, n));
  if (r == nullptr) return -1;
  if (is_finished) *is_finished = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  tb->dirty = true;
  return 0;
}

int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  TrainBooster* tb = AsTrain(handle);
  PyObject* r = CallHelper("booster_rollback", Py_BuildValue("(O)", tb->bst));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  tb->dirty = true;
  return 0;
}

int LGBM_BoosterResetParameter(BoosterHandle handle, const char* parameters) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  TrainBooster* tb = AsTrain(handle);
  PyObject* r = CallHelper(
      "booster_reset_parameter",
      Py_BuildValue("(Os)", tb->bst, parameters ? parameters : ""));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  // a parameter change (learning_rate, shrinkage) alters FUTURE trees,
  // not the saved model text, but resync anyway: the parameters block of
  // the model text records the live config
  tb->dirty = true;
  return 0;
}

int LGBM_BoosterRefit(BoosterHandle handle, const double* data,
                      const float* label, int32_t nrow, int32_t ncol) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  if (data == nullptr || label == nullptr || nrow <= 0 || ncol <= 0) {
    SetLastError("LGBM_BoosterRefit needs data, label and positive shape");
    return -1;
  }
  TrainBooster* tb = AsTrain(handle);
  PyObject* mv = PyMemoryView_FromMemory(
      const_cast<char*>(reinterpret_cast<const char*>(data)),
      static_cast<Py_ssize_t>(nrow) * ncol * 8, PyBUF_READ);
  PyObject* lmv = PyMemoryView_FromMemory(
      const_cast<char*>(reinterpret_cast<const char*>(label)),
      static_cast<Py_ssize_t>(nrow) * 4, PyBUF_READ);
  if (mv == nullptr || lmv == nullptr) {
    Py_XDECREF(mv);
    Py_XDECREF(lmv);
    return FailPy("LGBM_BoosterRefit");
  }
  PyObject* r = CallHelper("booster_refit",
                           Py_BuildValue("(ONNii)", tb->bst, mv, lmv,
                                         nrow, ncol));
  if (r == nullptr) return -1;
  // swap the handle's python booster to the refit result (under the GIL:
  // every other entry point touches tb->bst inside its own PyScope); the
  // native Model* cache resyncs lazily from the new model text
  PyObject* old = tb->bst;
  tb->bst = r;
  Py_DECREF(old);
  tb->dirty = true;
  return 0;
}

int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  PyObject* r = CallHelper(
      "booster_get_eval",
      Py_BuildValue("(Oi)", AsTrain(handle)->bst, data_idx));
  if (r == nullptr) return -1;
  Py_ssize_t n = PyList_Size(r);
  *out_len = static_cast<int>(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    out_results[i] = PyFloat_AsDouble(PyList_GetItem(r, i));
  Py_DECREF(r);
  return 0;
}

// shared body of GetNumPredict/GetPredict: the helper returns
// (float64 bytes, count); out_result == nullptr fetches the size only
static int InnerPredict(BoosterHandle handle, int data_idx, int64_t* out_len,
                        double* out_result, const char* where) {
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError(std::string(where) +
                 ": inner prediction buffers exist on training boosters "
                 "only (a loaded model has no attached data)");
    return -1;
  }
  PyScope py;
  if (!py.ok) return -1;
  PyObject* r = CallHelper(
      "booster_inner_predict",
      Py_BuildValue("(Oi)", AsTrain(handle)->bst, data_idx));
  if (r == nullptr) return -1;
  PyObject* bytes = PyTuple_GetItem(r, 0);
  int64_t n = PyLong_AsLongLong(PyTuple_GetItem(r, 1));
  if (out_len) *out_len = n;
  if (out_result != nullptr && n > 0) {
    char* buf = nullptr;
    Py_ssize_t blen = 0;
    if (PyBytes_AsStringAndSize(bytes, &buf, &blen) != 0 ||
        blen != static_cast<Py_ssize_t>(n * sizeof(double))) {
      Py_DECREF(r);
      SetLastError(std::string(where) + ": score buffer size mismatch");
      return -1;
    }
    std::memcpy(out_result, buf, blen);
  }
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len) {
  return InnerPredict(handle, data_idx, out_len, nullptr,
                      "LGBM_BoosterGetNumPredict");
}

int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result) {
  return InnerPredict(handle, data_idx, out_len, out_result,
                      "LGBM_BoosterGetPredict");
}

int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  PyObject* r = CallHelper("booster_eval_names",
                           Py_BuildValue("(O)", AsTrain(handle)->bst));
  if (r == nullptr) return -1;
  *out_len = static_cast<int>(PyList_Size(r));
  Py_DECREF(r);
  return 0;
}

int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                             char** out_strs) {
  PyScope py;
  if (!py.ok) return -1;
  if (!lgbm_tpu_internal::IsTrainBooster(handle)) {
    SetLastError("not a training booster");
    return -1;
  }
  PyObject* r = CallHelper("booster_eval_names",
                           Py_BuildValue("(O)", AsTrain(handle)->bst));
  if (r == nullptr) return -1;
  Py_ssize_t n = PyList_Size(r);
  *out_len = static_cast<int>(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* name = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    std::strcpy(out_strs[i], name != nullptr ? name : "");
  }
  Py_DECREF(r);
  return 0;
}

int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines) {
  PyScope py;
  if (!py.ok) return -1;
  PyObject* r = CallHelper(
      "network_init",
      Py_BuildValue("(siii)", machines ? machines : "", local_listen_port,
                    listen_time_out, num_machines));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int LGBM_NetworkFree() {
  // the reference's Network::Dispose contract: idempotent
  PyScope py;
  if (!py.ok) return -1;
  PyObject* r = CallHelper("network_free", PyTuple_New(0));
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

}  // extern "C"
