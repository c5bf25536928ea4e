"""The C ABI of the PyTorch port (lightgbm_tpu_torch/capi.py and its
training library, lightgbm_tpu_torch/cpp/c_train.cc) on the CPU.

One session build serves the file (a failed build fails it with the
compiler's output).  The JAX package's libraries are built as cpp/Makefile
builds them, into a scratch directory (make -C cpp would write into
cpp/), and loaded only by child processes.  Held: the C lifecycle (DatasetCreateFromMat ->
BoosterCreate "device_type=cpu ..." -> 10 updates -> SaveModelToString)
writes lt.train's save_model file byte for byte, and matches the JAX
package's training library node for node on the same weighted rows; a
compiled C program trains through the port's library from a thread that
did not load it and saves lt.train's file; both packages' training
libraries live in one process in either order, each registering its
hooks in its own base library and training through its own package, the
port's refusing a call without device_type=cpu on a machine without CUDA
with the port's message while the JAX package's trains; predictions race
updates safely; NativeBooster and FastSingleRowPredictor predict as
Booster.predict does; LGBM_NetworkInit refuses a machine list that does
not name this host; and helper/check_abi.py's drift checks hold for the
port (every header entry point bound in capi.py, the two training
libraries exporting the same LGBM_* set, every embedded helper of the
JAX library present in the port's copy)."""
import ctypes
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import capi

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 0
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              verbose=-1, min_data_in_leaf=20, min_gain_to_split=0.01,
              metric="auc")
C_PARAMS = " ".join("%s=%s" % kv for kv in PARAMS.items())
CPU = dict(PARAMS, device_type="cpu")
C_CPU = C_PARAMS + " device_type=cpu"
LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-6


@pytest.fixture(scope="session")
def built():
    """Both of the port's libraries, built once (or found built)."""
    capi.ensure_built(train=True)
    return capi.load_train_lib()


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(17)
    X = rng.standard_normal((800, 6)).astype(np.float32)
    y = (X[:, 0] + 0.4 * X[:, 1] + 0.3 * rng.standard_normal(800) > 0) \
        .astype(np.float32)
    w = rng.uniform(0.5, 1.5, 800).astype(np.float32)
    return X, y, w


def _save_text(bst, path):
    bst.save_model(str(path))
    return path.read_text()


def _c_train(mod, X, y, w, params, rounds=10):
    ds = mod.TrainDataset.from_mat(X).set_field("label", y) \
        .set_field("weight", w)
    bst = mod.TrainBooster(ds, params)
    for _ in range(rounds):
        bst.update()
    return bst


def _assert_same_trees(text_j, text_t, X):
    """Node for node: split features, topology, counts, every row in the
    same leaf, leaves at LEAF_RTOL / LEAF_ATOL."""
    mj = lj.Booster(model_str=text_j)._model
    mt = lt.Booster(model_str=text_t, params=dict(device_type="cpu"))._model
    assert len(mt.trees) == len(mj.trees)
    for tj, tt in zip(mj.trees, mt.trees):
        assert tt.num_leaves == tj.num_leaves
        nl = tj.num_leaves
        for k in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(tt, k)[:nl - 1],
                                          getattr(tj, k)[:nl - 1], err_msg=k)
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)
    np.testing.assert_array_equal(mt.predict_leaf_index(X),
                                  mj.predict_leaf_index(X))


def test_c_lifecycle_writes_lt_train_file(built, problem, tmp_path):
    X, y, w = problem
    bst = _c_train(capi, X, y, w, C_CPU)
    assert bst.current_iteration == 10
    assert bst.eval_names() == ["auc"]
    assert 0.5 < bst.get_eval(0)[0] <= 1.0
    ref = lt.train(CPU, lt.Dataset(X, label=y, weight=w), 10,
                   verbose_eval=False)
    want = _save_text(ref, tmp_path / "py.txt")
    assert bst.model_to_string() == want
    # LGBM_BoosterSaveModel through the training handle: the same file
    assert built.LGBM_BoosterSaveModel(bst._handle, -1,
                                       str(tmp_path / "c.txt").encode()) == 0
    assert (tmp_path / "c.txt").read_text() == want
    # predicting through the trained handle: the host model's numbers
    n = X.shape[0]
    out = (ctypes.c_double * n)()
    olen = ctypes.c_int64()
    assert built.LGBM_BoosterPredictForMat(
        bst._handle, X.ctypes.data_as(ctypes.c_void_p), F32,
        ctypes.c_int32(n), ctypes.c_int32(X.shape[1]), 1, 0, -1, b"",
        ctypes.byref(olen), out) == 0
    np.testing.assert_allclose(np.frombuffer(out, count=n), ref.predict(X),
                               rtol=0, atol=1e-12)


@pytest.fixture(scope="session")
def jax_libs(tmp_path_factory):
    """The JAX package's base and training libraries, compiled from cpp/
    with cpp/Makefile's recipe into a scratch directory."""
    d = tmp_path_factory.mktemp("jax_capi")
    cpp = os.path.join(REPO, "cpp")
    inc, link = capi.python_flags()
    flags = ["g++", *capi.CXX_FLAGS]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in ([*flags, "-shared", "-o",
                          str(d / "lib_lightgbm_tpu.so"),
                          os.path.join(cpp, "c_api.cc"),
                          os.path.join(cpp, "ingest.cc")],
                         [*flags, *inc, "-c", "-o", str(d / "c_train.o"),
                          os.path.join(cpp, "c_train.cc")])]
    for p in procs:
        out = p.communicate()[0]
        assert p.returncode == 0, out
    ld = subprocess.run([*flags, "-shared", "-o",
                         str(d / "lib_lightgbm_tpu_train.so"),
                         str(d / "c_train.o"), "-L", str(d),
                         "-l:lib_lightgbm_tpu.so", "-Wl,-rpath,$ORIGIN",
                         *link], capture_output=True, text=True)
    assert ld.returncode == 0, ld.stderr
    return d


C_PROGRAM = r"""
#include <pthread.h>
#include <stdio.h>
#include "lightgbm_tpu_c_api.h"

#define CHECK(rc) do { if ((rc) != 0) { \
  fprintf(stderr, "FAIL: %s\n", LGBM_GetLastError()); return 1; } } while (0)

static BoosterHandle g_bst;
static int g_iters, g_rc;

/* the updates run on a thread that did not load the library */
static void* updates(void* arg) {
  (void)arg;
  int fin = 0;
  for (int i = 0; i < g_iters && g_rc == 0; ++i)
    g_rc = LGBM_BoosterUpdateOneIter(g_bst, &fin);
  return NULL;
}

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  DatasetHandle ds;
  CHECK(LGBM_DatasetCreateFromFile(argv[1], "", NULL, &ds));
  CHECK(LGBM_BoosterCreate(ds, argv[2], &g_bst));
  g_iters = atoi(argv[3]);
  pthread_t t;
  if (pthread_create(&t, NULL, updates, NULL) != 0) return 3;
  pthread_join(t, NULL);
  CHECK(g_rc);
  int len = 0;
  double ev[8];
  CHECK(LGBM_BoosterGetEval(g_bst, 0, &len, ev));
  CHECK(LGBM_BoosterSaveModel(g_bst, -1, argv[4]));
  printf("C-ABI train ok: %d iterations, eval %.6f\n", g_iters, ev[0]);
  CHECK(LGBM_BoosterFree(g_bst));
  CHECK(LGBM_DatasetFree(ds));
  return 0;
}
"""


def compile_c_program(src: str, out: str) -> None:
    """cc against the port's training library (and its base library),
    with the training library's directory as the run path."""
    d = os.path.dirname(capi.train_lib_path())
    cc = subprocess.run(
        ["cc", "-O1", "-include", "stdlib.h", src, "-I",
         os.path.join(REPO, "cpp"), capi.train_lib_path(),
         os.path.join(d, capi.LIB_NAME), "-Wl,-rpath," + d, "-lpthread",
         "-o", out], capture_output=True, text=True)
    assert cc.returncode == 0, cc.stderr


def test_update_then_save_drains_the_pipeline(built, problem, monkeypatch,
                                              tmp_path):
    """The C ABI reaches the engine through Booster, so its model reads
    drain the dispatch pipeline: two LGBM_BoosterUpdateOneIter calls at
    pipeline_depth=2 whose trees are still held in the assembler (their
    record waits gated, the gate opened 0.3 s later), then
    LGBM_BoosterSaveModelToString holds both trees: lt.train's file at
    depth 0 up to its parameters."""
    from lightgbm_tpu_torch.boosting import gbdt as tgbdt
    gate = threading.Event()
    real = tgbdt.GBDT._wait_record

    def gated(slot, label):
        gate.wait()
        return real(slot, label)

    monkeypatch.setattr(tgbdt.GBDT, "_wait_record", staticmethod(gated))
    X, y, w = problem
    bst = _c_train(capi, X, y, w, C_CPU + " pipeline_depth=2", rounds=2)
    threading.Timer(0.3, gate.set).start()
    text = bst.model_to_string()
    ref = lt.train(dict(CPU, pipeline_depth=0),
                   lt.Dataset(X, label=y, weight=w), 2, verbose_eval=False)
    want = _save_text(ref, tmp_path / "py.txt")
    assert text.count("Tree=") == 2
    assert text.split("\nparameters:\n")[0] == \
        want.split("\nparameters:\n")[0]


def test_c_program_trains_through_the_port(built, problem, tmp_path):
    X, y, w = problem
    cache = str(tmp_path / "train.bin")
    lt.Dataset(X, label=y, weight=w, params=dict(verbose=-1)).construct() \
        .save_binary(cache)
    src = tmp_path / "train_demo.c"
    src.write_text(C_PROGRAM)
    exe = str(tmp_path / "train_demo")
    compile_c_program(str(src), exe)
    env = dict(os.environ)
    env.pop("LIGHTGBM_TPU_ROOT", None)
    # numpy's and torch's site-packages only: the library finds the
    # package by walking up from itself
    env["PYTHONPATH"] = os.pathsep.join(sorted({
        os.path.dirname(os.path.dirname(m.__file__)) for m in (np, torch)}))
    out = str(tmp_path / "c_model.txt")
    run = subprocess.run([exe, cache, C_CPU, "4", out], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "C-ABI train ok: 4 iterations" in run.stdout
    ref = lt.train(CPU, lt.Dataset(cache), 4, verbose_eval=False)
    assert open(out).read() == _save_text(ref, tmp_path / "py.txt")


BOTH = r"""
import ctypes, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import lightgbm_tpu_torch as lt
from lightgbm_tpu import capi as jcapi
from lightgbm_tpu_torch import capi as tcapi

jax_dir, order, data, out = sys.argv[2:6]


def preload():
    # the scratch build, never make -C cpp
    jcapi._lib = ctypes.CDLL(jax_dir + "/lib_lightgbm_tpu.so")
    jcapi._train_lib = ctypes.CDLL(jax_dir + "/lib_lightgbm_tpu_train.so")
    for lib in (jcapi._lib, jcapi._train_lib):
        lib.LGBM_GetLastError.restype = ctypes.c_char_p


z = np.load(data)
X, y, w = z["X"], z["y"], z["w"]
P = sys.argv[6]
for name in order.split(","):
    mod = {"jax": jcapi, "port": tcapi}[name]
    if name == "jax":
        preload()
    lib = mod.load_train_lib()
    ds = mod.TrainDataset.from_mat(X).set_field("label", y) \
        .set_field("weight", w)
    if name == "port":
        # without device_type=cpu: the card, or the port's refusal
        h = ctypes.c_void_p()
        rc = lib.LGBM_BoosterCreate(ds._handle, P.encode(), ctypes.byref(h))
        print("port without device_type:", rc,
              lib.LGBM_GetLastError().decode(), flush=True)
    bst = mod.TrainBooster(ds, P + (" device_type=cpu" if name == "port"
                                    else ""))
    for _ in range(10):
        bst.update()
    # the base library's own handle resolves a training handle only
    # through hooks registered in THAT base library
    base = mod.load_lib()
    n = ctypes.c_int64()
    rc = base.LGBM_BoosterSaveModelToString(bst._handle, -1, 0,
                                            ctypes.byref(n), None)
    assert rc == 0, base.LGBM_GetLastError()
    with open("%s/%s.txt" % (out, name), "w") as fh:
        fh.write(bst.model_to_string())
    print(name, "trained", flush=True)
maps = open("/proc/self/maps").read()
print("bases:", "/lib_lightgbm_tpu.so" in maps,
      "/lib_lightgbm_tpu_torch.so" in maps)
"""


@pytest.fixture(scope="module")
def both(built, jax_libs, problem, tmp_path_factory):
    """Both training libraries in one child process, in either order,
    each through its own package on the weighted problem (10 updates):
    {order: (the child's run, its output directory)}."""
    d = tmp_path_factory.mktemp("both")
    X, y, w = problem
    np.savez(d / "data.npz", X=X, y=y, w=w)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for order in ("jax,port", "port,jax"):
        out = d / order.replace(",", "_")
        out.mkdir()
        runs[order] = (subprocess.run(
            [sys.executable, "-c", BOTH, REPO, str(jax_libs), order,
             str(d / "data.npz"), str(out), C_PARAMS],
            capture_output=True, text=True, env=env, timeout=300), out)
    return runs


@pytest.mark.parametrize("order", ["jax,port", "port,jax"])
def test_both_training_libraries_in_one_process(both, order):
    run, out = both[order]
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    assert "jax trained" in run.stdout and "port trained" in run.stdout
    assert "bases: True True" in run.stdout
    # each trains through its own package, whichever came first
    for name in ("jax", "port"):
        assert (out / (name + ".txt")).read_text() == \
            (both["jax,port"][1] / (name + ".txt")).read_text()


def test_c_lifecycle_matches_the_jax_library(both, problem):
    out = both["jax,port"][1]
    _assert_same_trees((out / "jax.txt").read_text(),
                       (out / "port.txt").read_text(), problem[0])


def test_without_cpu_the_port_refuses_and_the_jax_library_trains(
        built, both, problem):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    X, y, _ = problem
    ds = capi.TrainDataset.from_mat(X).set_field("label", y)
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        capi.TrainBooster(ds, C_PARAMS)
    for run, _ in both.values():
        refused = [ln for ln in run.stdout.splitlines()
                   if ln.startswith("port without device_type")][0]
        assert refused.startswith("port without device_type: -1 ")
        assert "no CUDA device is available" in refused
        assert "device_type='cpu'" in refused
        assert "jax trained" in run.stdout      # no device_type, trains


def test_concurrent_predict_and_update(built, problem):
    """Predictions from worker threads race updates on the main thread;
    ctypes releases the GIL around the C calls, so the C side's locking
    is exercised (a regression shows as a crash or a non-probability)."""
    lib = built
    X, y, w = problem
    ds = capi.TrainDataset.from_mat(X).set_field("label", y)
    bst = capi.TrainBooster(ds, C_CPU)
    bst.update()
    n = X.shape[0]
    stop = threading.Event()
    errors = []

    def predict_loop():
        out = (ctypes.c_double * n)()
        olen = ctypes.c_int64()
        while not stop.is_set():
            rc = lib.LGBM_BoosterPredictForMat(
                bst._handle, X.ctypes.data_as(ctypes.c_void_p), F32,
                ctypes.c_int32(n), ctypes.c_int32(X.shape[1]), 1, 0, -1,
                b"", ctypes.byref(olen), out)
            if rc != 0:
                errors.append(lib.LGBM_GetLastError().decode())
                return
            p = np.frombuffer(out, count=n)
            if not np.isfinite(p).all() or not ((p >= 0) & (p <= 1)).all():
                errors.append("non-probability output under race")
                return

    threads = [threading.Thread(target=predict_loop) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in range(6):
            bst.update()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors
    assert bst.current_iteration == 7


def test_native_booster_predicts_as_booster_predict(built, problem,
                                                    tmp_path):
    X, y, w = problem
    ref = lt.train(CPU, lt.Dataset(X, label=y, weight=w), 8,
                   verbose_eval=False)
    path = str(tmp_path / "m.txt")
    ref.save_model(path)
    nb = capi.NativeBooster(model_file=path)
    assert nb.num_iterations == 8 and nb.num_feature == X.shape[1]
    np.testing.assert_allclose(nb.predict(X), ref.predict(X), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(nb.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(nb.predict(X, pred_leaf=True),
                                  ref.predict(X, pred_leaf=True))
    fast = capi.FastSingleRowPredictor(nb, X.shape[1])
    for row, want in zip(X[:20].astype(np.float64), ref.predict(X[:20])):
        np.testing.assert_allclose(fast.predict(row), [want], rtol=0,
                                   atol=1e-12)
    nb2 = capi.NativeBooster(model_str=ref.model_to_string())
    np.testing.assert_array_equal(nb2.predict(X), nb.predict(X))


def test_network_init_refuses_several_machines(built):
    """One machine is a no-op; several bring the process group up
    (tests/test_torch_launch.py brings two ranks up through this entry
    point), and a list that does not name this host is refused, naming
    why, before any connection is tried; LGBM_NetworkFree is
    idempotent."""
    import torch.distributed as dist
    capi.network_init("", num_machines=1)
    assert not dist.is_initialized()
    with pytest.raises(lt.LightGBMError, match="none of this host"):
        capi.network_init("10.255.255.1:12400,10.255.255.2:12400",
                          num_machines=2)
    assert not dist.is_initialized()
    capi.network_free()
    capi.network_free()


def test_builds_are_keyed_and_a_failed_build_raises(built, tmp_path,
                                                    monkeypatch):
    from lightgbm_tpu_torch.runtime import graph_obs
    path = capi.ensure_built(train=True)
    assert path == capi.ensure_built()
    assert os.path.dirname(path) == str(capi.build_dir())
    assert graph_obs.LEDGER.to_json()["sites"][
        "build." + capi.LIB_NAME[:-3]]["cache_hits"] >= 1
    monkeypatch.setattr(capi, "BUILD_DIR", tmp_path / "capi")
    monkeypatch.setattr(capi, "CXX_FLAGS",
                        capi.CXX_FLAGS + ("-fno-such-option",))
    assert capi.build_dir().parent == tmp_path / "capi"
    with pytest.raises(RuntimeError, match="building the C API library "
                                           "failed"):
        capi.ensure_built()
    assert not [p for p in (tmp_path / "capi").rglob("*.so")]


# ---------------------------------------------------------------------------
# helper/check_abi.py's drift checks, applied to the port
# ---------------------------------------------------------------------------

def test_abi_lint_is_clean_for_the_port():
    sys.path.insert(0, os.path.join(REPO, "helper"))
    import check_abi
    port_capi = os.path.join(REPO, "lightgbm_tpu_torch", "capi.py")
    assert check_abi.run(capi_path=port_capi) == []
    text = open(port_capi).read()
    missing = [s for s in check_abi.header_entry_points() if s not in text]
    assert missing == []


def _exported(path):
    out = subprocess.run(["nm", "-D", "--defined-only", path],
                         capture_output=True, text=True, check=True).stdout
    return {ln.split()[-1] for ln in out.splitlines()
            if ln.split() and ln.split()[-1].startswith("LGBM_")}


def test_training_libraries_export_the_same_abi(built, jax_libs):
    port = _exported(capi.train_lib_path())
    jax_lib = _exported(str(jax_libs / "lib_lightgbm_tpu_train.so"))
    assert port and port == jax_lib
    base_port = _exported(os.path.join(os.path.dirname(
        capi.train_lib_path()), capi.LIB_NAME))
    assert base_port == _exported(str(jax_libs / "lib_lightgbm_tpu.so"))
    assert "LGBM_BoosterCreate" not in base_port


def _helper_defs(path):
    text = open(path).read()
    src = text[text.index('R"PY('):text.index(')PY"')]
    return set(re.findall(r"^def (\w+)\(", src, re.MULTILINE))


def test_every_embedded_helper_is_in_the_port_copy():
    jax_defs = _helper_defs(os.path.join(REPO, "cpp", "c_train.cc"))
    port_defs = _helper_defs(capi.TRAIN_SOURCE)
    assert len(jax_defs) >= 35
    assert jax_defs <= port_defs
