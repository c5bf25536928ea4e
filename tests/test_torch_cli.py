"""The CLI of the PyTorch port (lightgbm_tpu_torch/application.py and
`python -m lightgbm_tpu_torch`) against the JAX package's on the CPU.

The same numpy-seeded files (weighted rows through a .weight sidecar,
min_gain_to_split=0.01, as the CPU parity rules ask) go through
lightgbm_tpu.application.Application and the port's with device_type=cpu.
Held: parse_parameters gives both packages' dict; the trained models
agree node for node and their predictions to the CPU parity tolerance;
the port's output_model is its in-process save_model file byte for byte,
as the JAX package's is; task=predict takes the device predictor on the
card and the host traversal under device_type=cpu unless predict_device
says, and keeps the caller's device; the host predictor's output file is
NativeBooster.predict_for_file's byte for byte on raw scores (the sigmoid
within 1e-15) and the device predictor's within rtol 1e-5; snapshot_freq
+ resume=true after an abrupt death gives the uninterrupted file byte for
byte, and a JAX CLI snapshot resumes in the port's CLI; refit;
convert_model's C++ is the JAX package's string for string and compiles
to the model's predictions; task=doctor's bundle carries probe.json and a
crashing task leaves a bundle; without device_type=cpu every task but
doctor fails on a machine without CUDA with the port's message, `python
-m lightgbm_tpu_torch` with a non-zero exit; task=serve and
task=train_online are refused naming their ROADMAP items, and a machine
list that does not name this host before any connection;
LGBM_TPU_METRICS_FILE and compile_cache_dir are read."""
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import application as japp
from lightgbm_tpu_torch import application as tapp
from lightgbm_tpu_torch import capi
from lightgbm_tpu_torch.runtime import resilience

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 6
TRAIN = ["objective=binary", "num_leaves=15", "learning_rate=0.1",
         "min_data_in_leaf=20", "min_gain_to_split=0.01", "max_bin=63",
         "verbose=-1", "num_trees=%d" % ROUNDS]
CPU = ["device_type=cpu"]
LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-6


def _data(n=1500, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n)
         > 0).astype(np.float64)
    return X, y, rng.uniform(0.5, 1.5, n)


def _write(path, X, y, w=None):
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.17g")
    if w is not None:
        np.savetxt(str(path) + ".weight", w, fmt="%.17g")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both CLIs trained on one weighted TSV; the port's also in process."""
    d = tmp_path_factory.mktemp("cli")
    X, y, w = _data()
    data = str(d / "train.tsv")
    _write(data, X, y, w)
    jm, tm = str(d / "jax.txt"), str(d / "port.txt")
    japp.Application(["task=train", "data=" + data, "output_model=" + jm]
                     + TRAIN).run()
    tapp.Application(["task=train", "data=" + data, "output_model=" + tm]
                     + TRAIN + CPU).run()
    params = dict(kv.split("=", 1) for kv in TRAIN + CPU)
    del params["num_trees"]
    bst = lt.train(params, lt.Dataset(X, label=y, weight=w), ROUNDS,
                   verbose_eval=False)
    py = str(d / "port_py.txt")
    bst.save_model(py)
    return dict(d=d, X=X, y=y, w=w, data=data, jm=jm, tm=tm, py=py,
                params=params)


def _assert_same_trees(jpath, tpath, X):
    mj = lj.Booster(model_file=jpath)._model
    mt = lt.Booster(model_file=tpath, params=dict(device_type="cpu"))._model
    assert len(mt.trees) == len(mj.trees) > 0
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


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_parse_parameters_matches_jax(tmp_path):
    conf = tmp_path / "train.conf"
    conf.write_text("task = train\nnum_leaves = 63  # comment\n"
                    "learning_rate = 0.05\n\n# only a comment\nbad line\n")
    argv = ["config=%s" % conf, "num_leaves=31", "data = x.tsv", "noise"]
    got = tapp.parse_parameters(argv)
    assert got == japp.parse_parameters(argv)
    assert got["num_leaves"] == "31" and got["learning_rate"] == "0.05"
    assert "config" not in got


def test_cli_model_is_the_in_process_file_and_matches_jax(run):
    assert _read(run["tm"]) == _read(run["py"])
    _assert_same_trees(run["jm"], run["tm"], run["X"])
    # the JAX package's CLI file is its in-process save_model file too
    params = dict(run["params"])
    del params["device_type"]
    jb = lj.train(params, lj.Dataset(run["X"], label=run["y"],
                                     weight=run["w"]), ROUNDS,
                  verbose_eval=False)
    jb.save_model(str(run["d"] / "jax_py.txt"))
    assert _read(run["jm"]) == _read(str(run["d"] / "jax_py.txt"))


def test_predict_host_device_and_native(run):
    d, data = run["d"], run["data"]
    outs = {}
    for name, extra in (("jax", []), ("host", CPU),
                        ("device", CPU + ["predict_device=true"])):
        out = str(d / ("pred_%s.txt" % name))
        model = run["jm"] if name == "jax" else run["tm"]
        (japp if name == "jax" else tapp).Application(
            ["task=predict", "data=" + data, "input_model=" + model,
             "output_result=" + out] + extra).run()
        outs[name] = out
    host = np.loadtxt(outs["host"])
    assert host.shape == (len(run["y"]),)
    np.testing.assert_allclose(host, np.loadtxt(outs["jax"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.loadtxt(outs["device"]), host, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        host, lt.Booster(model_file=run["tm"]).predict(run["X"]))
    # the pure-C file predictor: the host predictor's bytes on raw
    # scores; the sigmoid within 1e-15 (numpy's exp and libm's differ in
    # the last bit, which 1 / (1 + e) can double)
    nb = capi.NativeBooster(model_file=run["tm"])
    native = str(d / "pred_native.txt")
    nb.predict_for_file(data, native)
    np.testing.assert_allclose(np.loadtxt(native), host, rtol=1e-15, atol=0)
    raw = str(d / "pred_raw.txt")
    tapp.Application(["task=predict", "data=" + data, "input_model=" +
                      run["tm"], "output_result=" + raw,
                      "predict_raw_score=true"] + CPU).run()
    nb.predict_for_file(data, native, raw_score=True)
    assert _read(native) == _read(raw)


DIE = [sys.executable, "-m", "lightgbm_tpu_torch", "task=train"]


def test_snapshot_resume_is_byte_identical(run, tmp_path):
    out = str(tmp_path / "m.txt")
    argv = ["data=" + run["data"], "output_model=" + out,
            "snapshot_freq=1"] + TRAIN + CPU
    env = dict(os.environ, LGBM_TPU_FAULT="die_at_iter:3",
               PYTHONPATH=REPO, LGBM_TPU_DOCTOR_ON_CRASH="0")
    died = subprocess.run(DIE + argv, env=env, capture_output=True,
                          text=True, timeout=300)
    assert died.returncode == 137, died.stderr[-2000:]
    assert not os.path.exists(out)
    assert [i for i, _ in resilience.snapshot_paths(out)] == [3, 2, 1]
    tapp.Application(["task=train", "resume=true"] + argv).run()
    assert _read(out) == _read(run["tm"])


def test_jax_snapshot_resumes_in_the_port(run, tmp_path):
    jout, tout = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    japp.Application(["task=train", "data=" + run["data"],
                      "output_model=" + jout, "snapshot_freq=3"]
                     + TRAIN).run()
    snap = dict(resilience.snapshot_paths(jout))[3]
    os.replace(snap, tout + ".snapshot_iter_3")
    tapp.Application(["task=train", "data=" + run["data"],
                      "output_model=" + tout, "resume=true"]
                     + TRAIN + CPU).run()
    _assert_same_trees(run["jm"], tout, run["X"])


def test_refit_matches_jax(run, tmp_path):
    X, y, _ = _data(n=800, seed=5)
    data = str(tmp_path / "refit.tsv")
    _write(data, X, y)
    jout, tout = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    japp.Application(["task=refit", "data=" + data, "input_model=" + run["jm"],
                      "output_model=" + jout]).run()
    tapp.Application(["task=refit", "data=" + data, "input_model=" + run["jm"],
                      "output_model=" + tout] + CPU).run()
    _assert_same_trees(jout, tout, X)
    assert lt.Booster(model_file=tout).current_iteration() == ROUNDS


def test_convert_model_is_the_jax_code_and_compiles(run, tmp_path):
    with open(run["tm"]) as fh:
        text = fh.read()
    code = tapp.model_to_ifelse(
        lt.Booster(model_str=text)._model)
    assert code == japp.model_to_ifelse(lj.Booster(model_str=text)._model)
    src = str(tmp_path / "model.cpp")
    tapp.Application(["task=convert_model", "input_model=" + run["tm"],
                      "convert_model_file=" + src] + CPU).run()
    assert open(src).read() == code
    main_src = tmp_path / "main.cpp"
    main_src.write_text("""
#include <cstdio>
#include <cstdlib>
double Predict(const double* arr);
int main(int argc, char** argv) {
  double arr[64] = {0};
  for (int i = 1; i < argc && i <= 64; ++i) arr[i-1] = atof(argv[i]);
  printf("%.17g\\n", Predict(arr));
  return 0;
}
""")
    exe = str(tmp_path / "predictor")
    subprocess.run(["g++", "-O1", "-o", exe, src, str(main_src)],
                   check=True, capture_output=True)
    bst = lt.Booster(model_file=run["tm"])
    for row in run["X"][:5]:
        out = subprocess.run([exe] + ["%.17g" % v for v in row], check=True,
                             capture_output=True, text=True)
        want = float(bst.predict(row.reshape(1, -1), raw_score=True)[0])
        assert abs(float(out.stdout) - want) < 1e-10


def _bundle(path):
    with tarfile.open(path) as tar:
        return {i.name.split("/", 1)[1]: tar.extractfile(i).read()
                for i in tar.getmembers()}


def test_doctor_task_bundles_the_probe(tmp_path, capsys):
    tapp.Application(["task=doctor", "output_dir=%s" % tmp_path,
                      "probe_deadline=60"]).run()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("doctor bundle ")][0]
    members = _bundle(line.split(" ", 2)[2])
    probe = json.loads(members["probe.json"])
    assert probe["platform"] == "cuda"
    assert probe["ok"] == torch.cuda.is_available()
    if not probe["ok"]:
        assert "no CUDA device" in probe["tail"]


def test_crashing_task_leaves_a_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DOCTOR_DIR", str(tmp_path))
    monkeypatch.delenv("LGBM_TPU_DOCTOR_ON_CRASH", raising=False)
    with pytest.raises(FileNotFoundError):
        tapp.Application(["task=train", "data=%s" % (tmp_path / "none.tsv")]
                         + CPU).run()
    found = [f for f in os.listdir(tmp_path)
             if f.startswith("lgbm_debug_crash_train_")]
    assert len(found) == 1
    members = _bundle(str(tmp_path / found[0]))
    assert "probe.json" not in members
    manifest = json.loads(members["manifest.json"])
    assert "FileNotFoundError" in manifest["note"]
    assert json.loads(members["env.json"])["config"]["device_type"] == "cpu"


@pytest.mark.parametrize("task", ["train", "predict", "refit",
                                  "convert_model"])
def test_every_task_needs_the_card_or_device_type_cpu(run, task,
                                                      monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    monkeypatch.setenv("LGBM_TPU_DOCTOR_ON_CRASH", "0")
    with pytest.raises(lt.LightGBMError, match="no CUDA device"):
        tapp.Application(["task=" + task, "data=" + run["data"],
                          "input_model=" + run["tm"]]).run()


def test_module_entry_without_cpu_exits_non_zero(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    env = dict(os.environ, PYTHONPATH=REPO,
               LGBM_TPU_DOCTOR_DIR=str(tmp_path))
    r = subprocess.run(DIE + ["data=" + run["data"],
                              "output_model=%s" % (tmp_path / "m.txt")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "device_type=cuda but no CUDA device is available" in r.stderr
    assert "doctor: crash bundle written" in r.stderr
    assert not (tmp_path / "m.txt").exists()


@pytest.mark.parametrize("argv,item", [
    (["task=serve"], "item 6"),
    (["task=train_online"], "item 6")])
def test_what_waits_is_refused_naming_its_item(run, argv, item,
                                               monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DOCTOR_ON_CRASH", "0")
    with pytest.raises(NotImplementedError, match=item):
        tapp.Application(argv + ["data=" + run["data"]] + CPU).run()


@pytest.mark.parametrize("argv", [
    ["task=train", "num_machines=2",
     "machines=10.255.255.1:1,10.255.255.2:2"],
    ["task=train", "machines=10.255.255.1:1,10.255.255.2:2"]])
def test_a_machine_list_without_this_host_is_refused(run, argv,
                                                     monkeypatch):
    """A multi-machine config brings the process group up
    (tests/test_torch_launch.py trains two CLI ranks); a list that does not
    name this host is refused before any connection is tried."""
    monkeypatch.setenv("LGBM_TPU_DOCTOR_ON_CRASH", "0")
    with pytest.raises(ValueError, match="none of this host"):
        tapp.Application(argv + ["data=" + run["data"]] + CPU).run()


def test_a_serial_machine_list_trains(run, tmp_path):
    out = str(tmp_path / "m.txt")
    tapp.Application(["task=train", "data=" + run["data"],
                      "output_model=" + out, "machines=a:1,b:2",
                      "num_machines=1"] + TRAIN + CPU).run()
    assert os.path.exists(out)


def test_predict_device_refuses_leaves_and_contributions(run, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DOCTOR_ON_CRASH", "0")
    for flag in ("predict_leaf_index=true", "predict_contrib=true"):
        with pytest.raises(lt.LightGBMError, match="predict_device"):
            tapp.Application(["task=predict", "data=" + run["data"],
                              "input_model=" + run["tm"],
                              "predict_device=true", flag] + CPU).run()


@pytest.mark.parametrize("extra,card,want", [
    (CPU, False, False),
    (CPU + ["predict_device=true"], False, True),
    (["device=cpu", "predict_device=true"], False, True),
    (["predict_device=false", "device=cpu"], False, False),
    ([], True, True),
    (["predict_device=false"], True, False)])
def test_predict_runs_the_device_predictor_on_the_card(run, monkeypatch,
                                                       extra, card, want):
    # task=predict takes the device predictor on the card and the host
    # traversal under device_type=cpu, unless predict_device says; the
    # device the caller chose (device= is device_type's alias) stays the
    # Booster's.  The card is stood in for by resolve_device here.
    monkeypatch.setenv("LGBM_TPU_DOCTOR_ON_CRASH", "0")
    seen = []
    real = lt.Booster.predict

    def spy(self, X, **kw):
        seen.append((kw["device"], self.config.device_type))
        if card:
            return np.zeros(len(X))
        return real(self, X, **kw)
    monkeypatch.setattr(tapp.Booster, "predict", spy)
    if card:
        monkeypatch.setattr(tapp, "resolve_device",
                            lambda cfg: torch.device("cuda", 0))
    out = str(run["d"] / "pred_choice.txt")
    tapp.Application(["task=predict", "data=" + run["data"],
                      "input_model=" + run["tm"],
                      "output_result=" + out] + extra).run()
    assert seen == [(want, "cuda" if card else "cpu")]
    if not card:
        ref = str(run["d"] / "pred_ref.txt")
        tapp.Application(["task=predict", "data=" + run["data"],
                          "input_model=" + run["tm"],
                          "output_result=" + ref,
                          "predict_device=%s" % str(want).lower()]
                         + CPU).run()
        assert _read(out) == _read(ref)


@pytest.mark.parametrize("value", ["true", "false"])
def test_the_jax_device_flag_is_refused(run, monkeypatch, value):
    # device=true is the JAX package's alias of predict_device; here
    # device is the alias of device_type, and a truth value is refused
    monkeypatch.setenv("LGBM_TPU_DOCTOR_ON_CRASH", "0")
    with pytest.raises(lt.LightGBMError, match="alias of device_type"):
        tapp.Application(["task=predict", "data=" + run["data"],
                          "input_model=" + run["tm"],
                          "device=" + value]).run()


def test_metrics_file_and_compile_cache(run, tmp_path, monkeypatch):
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.runtime import telemetry, warmup
    metrics = str(tmp_path / "metrics.jsonl")
    monkeypatch.setenv(telemetry.METRICS_FILE_ENV, metrics)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    try:
        tapp.Application(["task=train", "data=" + run["data"],
                          "output_model=%s" % (tmp_path / "m.txt"),
                          "compile_cache_dir=%s" % (tmp_path / "cache")]
                         + TRAIN[:-1] + ["num_trees=2"] + CPU).run()
        status = warmup.cache_status()
        assert status["enabled"]
        assert status["dir"].startswith(str(tmp_path / "cache"))
        assert str(build.BUILD_DIR) == status["dir"]
    finally:
        warmup._reset_for_tests()
        writer = telemetry._file_writer
        if writer is not None:
            writer.stop()
        monkeypatch.setattr(telemetry, "_file_writer", None)
    lines = [json.loads(ln) for ln in open(metrics) if ln.strip()]
    assert lines and lines[-1]["context"] == "cli_train"
