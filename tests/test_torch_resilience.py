"""The training half of the fault-tolerant runtime in the PyTorch port
(lightgbm_tpu_torch/runtime/resilience.py): the in-process and subprocess
counterparts of tests/test_resilience.py (fault spec, backoff, atomic
checksummed snapshots with retention, the resume scan, the stage
watchdog, byte-identical resume across a snapshot boundary, abrupt death
and preemption), snapshots across the two packages, and the non-finite
sentinel against the JAX package's on the same burst."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.runtime import resilience as jres
from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.models.gbdt_model import GBDTModel
from lightgbm_tpu_torch.runtime import resilience, syncs

REPO = str(pathlib.Path(__file__).resolve().parents[1])

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, F = 1500, 6
BASE = dict(objective="binary", num_leaves=12, max_bin=63, verbose=-1,
            min_gain_to_split=0.01)


def _data(seed=0, n=N, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n)
    y = np.digitize(s, [-0.4, 0.4]).astype(np.float64) if classes == 3 \
        else (s > 0).astype(np.float64)
    return X, y, rng.uniform(0.5, 1.5, n)


def _cpu(params):
    return dict(params, device_type="cpu")


def _booster(params, seed=0, n=N, classes=2):
    X, y, w = _data(seed, n, classes)
    return lt.Booster(_cpu(params), lt.Dataset(X, label=y, weight=w))


# ---------------------------------------------------------------------------
# fault spec, backoff, the snapshot file format
# ---------------------------------------------------------------------------

def test_fault_spec_parsing(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FAULT",
                       "die_at_iter:7,corrupt_snapshot,nan_grad:2")
    assert resilience.fault_active("die_at_iter")
    assert resilience.fault_arg("die_at_iter") == "7"
    assert resilience.fault_arg("corrupt_snapshot", "x") == "x"
    assert resilience.fault_arg("nan_grad") == "2"
    assert not resilience.fault_active("sigterm_at_iter")
    monkeypatch.setenv("LGBM_TPU_FAULT", "explode_reactor")
    with pytest.raises(ValueError, match="unknown fault"):
        resilience.fault_active("die_at_iter")
    # the table names what the JAX package's table names
    assert set(resilience.FAULT_TABLE) == set(jres.FAULT_TABLE)
    for name, row in resilience.FAULT_TABLE.items():
        assert row["arg"] == jres.FAULT_TABLE[name]["arg"]


@pytest.mark.parametrize("name", ["slow_stage", "torn_write",
                                  "die_at_predict", "die_at_ring"])
def test_unported_faults_refused_naming_their_item(monkeypatch, name):
    """Every fault of the JAX package's table has its injection point in
    the port (no fault is refused any more): each parses beside another
    and stands in FAULT_TABLE; die_at_ring fires, killing the ring client
    with the JAX package's exit code at its K-th frame in flight, and
    not before."""
    monkeypatch.setenv("LGBM_TPU_FAULT", "nan_grad:1,%s:3" % name)
    assert resilience.fault_active("nan_grad")
    assert resilience.fault_active(name)
    assert resilience.fault_arg(name) == "3"
    assert name in resilience.FAULT_TABLE
    assert not hasattr(resilience, "UNPORTED_FAULTS")
    if name == "die_at_ring":
        code = ("from lightgbm_tpu_torch.runtime import resilience as r\n"
                "r.maybe_die_at_ring(1)\nr.maybe_die_at_ring(2)\n"
                "print('alive', flush=True)\nr.maybe_die_at_ring(3)\n"
                "print('survived', flush=True)\n")
        env = dict(os.environ, LGBM_TPU_FAULT="die_at_ring:3",
                   PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 137
        assert out.stdout.split() == ["alive"]
        assert "FAULT die_at_ring" in out.stderr
        assert "3 frames in flight" in out.stderr


def test_backoff_is_bounded_jittered_deterministic():
    d1 = resilience.backoff_delays(4, base=1.0, cap=3.0, seed=5)
    assert d1 == resilience.backoff_delays(4, base=1.0, cap=3.0, seed=5)
    assert len(d1) == 3 and all(0.4 <= d <= 3.0 for d in d1)
    assert resilience.backoff_delays(4, seed=1) != \
        resilience.backoff_delays(4, seed=2)
    assert d1 == jres.backoff_delays(4, base=1.0, cap=3.0, seed=5)


def test_atomic_write_and_snapshot_validation(tmp_path):
    path = str(tmp_path / "m.txt.snapshot_iter_2")
    body = resilience._with_footer("tree\nnum_leaves=2\n", {"total_iter": 2})
    resilience.atomic_write(path, body)
    assert resilience.validate_snapshot(path) == (True, "ok")
    assert resilience.load_snapshot_state(path)["total_iter"] == 2
    assert os.listdir(tmp_path) == ["m.txt.snapshot_iter_2"]
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    assert not resilience.validate_snapshot(path)[0]
    open(path, "wb").write(raw.replace(b"num_leaves=2", b"num_leaves=3"))
    ok, reason = resilience.validate_snapshot(path)
    assert not ok and "checksum" in reason
    open(path, "w").write("tree\nnum_leaves=2\n")
    assert not resilience.validate_snapshot(path)[0]


def test_snapshot_retention_keeps_last_k(tmp_path):
    bst = _booster(BASE)
    out = str(tmp_path / "m.txt")
    for _ in range(5):
        bst.update()
        resilience.write_snapshot(bst, out, retention=2)
    snaps = resilience.snapshot_paths(out)
    assert [it for it, _ in snaps] == [5, 4]
    for _, p in snaps:
        assert resilience.validate_snapshot(p)[0]
        assert GBDTModel.load_model(p).current_iteration == \
            int(p.rsplit("_", 1)[1])
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_resume_scan_past_three_mixed_corrupt_snapshots(tmp_path):
    bst = _booster(BASE, seed=9)
    out = str(tmp_path / "m.txt")
    for _ in range(5):
        bst.update()
        resilience.write_snapshot(bst, out)
    paths = dict(resilience.snapshot_paths(out))
    raw5 = open(paths[5], "rb").read()
    open(paths[5], "wb").write(raw5[: len(raw5) // 3])          # truncated
    raw4 = open(paths[4], "rb").read()
    open(paths[4], "wb").write(raw4.replace(b"leaf_value", b"leaf_valXe"))
    raw3 = open(paths[3]).read()                                # footerless
    open(paths[3], "w").write(raw3.split(resilience._STATE_PREFIX)[0])
    snap, state = resilience.find_resume_snapshot(out)
    assert snap == paths[2] and state["total_iter"] == 2
    reasons = {it: resilience.validate_snapshot(paths[it]) for it in (3, 4, 5)}
    assert not any(ok for ok, _ in reasons.values()), reasons


def test_write_snapshot_refuses_nonfinite_scores(tmp_path):
    bst = _booster(BASE)
    bst.update()
    eng = bst._engine
    eng._leave_fast()
    eng.score[0, 3] = float("nan")
    assert resilience.write_snapshot(bst, str(tmp_path / "m.txt")) is None
    assert resilience.snapshot_paths(str(tmp_path / "m.txt")) == []


# ---------------------------------------------------------------------------
# the stage watchdog
# ---------------------------------------------------------------------------

def test_watchdog_soft_timeout_names_culprit_and_dumps_threads(tmp_path):
    report = str(tmp_path / "stages.json")
    wd = resilience.Watchdog(1, hard=False, report_path=report,
                             label="test stage")
    wd("fast stage", seconds=30)
    wd("stuck stage", seconds=1)
    with pytest.raises(resilience.StageTimeout, match="stuck stage"):
        time.sleep(5)
    wd.done()
    rep = json.load(open(report))
    assert rep["culprit"] == "stuck stage"
    assert [s["name"] for s in rep["stages"]] == ["fast stage", "stuck stage"]
    assert all("t_start" in s for s in rep["stages"])
    assert "test_watchdog_soft_timeout" in rep["tracebacks"]


def test_watchdog_stage_scope_records_errors(tmp_path):
    wd = resilience.Watchdog(30, hard=False,
                             report_path=str(tmp_path / "r.json"))
    with wd.stage_scope("good"):
        pass
    with pytest.raises(RuntimeError):
        with wd.stage_scope("bad"):
            raise RuntimeError("boom")
    rep = resilience.read_stage_report(str(tmp_path / "r.json"))
    assert {s["name"]: s["status"] for s in rep["stages"]} == \
        {"good": "ok", "bad": "error"}
    assert rep["culprit"] == "bad"


def test_watchdog_thread_mode_keeps_last(tmp_path):
    """Off the main thread the watchdog keeps the trail only; the owner
    reports an expiry, which closes the stage as timeout."""
    import threading
    out = {}

    def owner():
        wd = resilience.Watchdog(5, report_path=str(tmp_path / "t.json"),
                                 keep_last=2)
        out["alarm"] = wd.use_alarm
        for i in range(4):
            wd("batch %d" % i)
        wd.record_timeout(note="slow")
        out["rep"] = wd.report()
    t = threading.Thread(target=owner)
    t.start()
    t.join()
    assert out["alarm"] is False
    assert [s["name"] for s in out["rep"]["stages"]] == ["batch 2", "batch 3"]
    assert out["rep"]["dropped_stages"] == 2
    assert out["rep"]["stages"][-1]["status"] == "timeout"
    assert out["rep"]["culprit"] == "batch 3"


# ---------------------------------------------------------------------------
# byte-identical resume in process
# ---------------------------------------------------------------------------

RESUME_CASES = {
    "gbdt bagging feature_fraction": (dict(bagging_fraction=0.6,
                                           bagging_freq=2,
                                           feature_fraction=0.7, seed=3), 2),
    "dart": (dict(boosting="dart", drop_rate=0.5, drop_seed=11), 2),
    "goss": (dict(boosting="goss", learning_rate=0.5, top_rate=0.2,
                  other_rate=0.1), 2),
    "multiclass": (dict(objective="multiclass", num_class=3,
                        bagging_fraction=0.7, bagging_freq=1), 3),
    "rf": (dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
                feature_fraction=0.8), 2),
}


def _resume_matches(params, classes, total=8, cut=4, **data_kw):
    a = _booster(params, classes=classes, **data_kw)
    state = text = None
    for i in range(total):
        a.update()
        if i + 1 == cut:
            before = syncs.snapshot()
            state = resilience.capture_training_state(a)
            # one fetch of its own; the capture drains the pipeline first,
            # so the last tree's own drain may land inside it
            by = syncs.delta(before)["by_label"]
            assert by.pop("pipeline_drain", 0) <= 1
            assert by == {"snapshot": 1}
            text = a._model.save_model_to_string()
    b = lt.Booster(_cpu(params), a.train_set,
                   init_model=GBDTModel.load_model_from_string(text))
    resilience.restore_training_state(b, state)
    for _ in range(total - cut):
        b.update()
    return a, b, state


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_in_process_byte_identical(case):
    extra, classes = RESUME_CASES[case]
    a, b, state = _resume_matches(dict(BASE, **extra), classes)
    assert b.model_to_string() == a.model_to_string()
    assert state["perm_len"] == a._engine._fast.n_rows
    assert state["boosting"] == type(a._engine).__name__


def test_resume_wide_index_byte_identical(monkeypatch):
    """The radix-split row index (past 2^24 rows; forced here): capture
    decodes it, restore moves whole rows, so both index columns follow."""
    monkeypatch.setattr(tgbdt, "_IDX_WIDE_THRESHOLD", 1)
    a, b, state = _resume_matches(dict(BASE, bagging_fraction=0.6,
                                       bagging_freq=1), 2)
    assert a._engine._fast.wide_idx and b._engine._fast.wide_idx
    assert b.model_to_string() == a.model_to_string()
    perm = resilience._np_b64(state["perm"], np.int32, (state["perm_len"],))
    assert sorted(perm[perm < a._engine._fast.n_pad]) == \
        list(range(a._engine._fast.n_pad))


def test_resume_state_shape_mismatch_degrades_gracefully(capsys):
    bst = _booster(BASE, seed=4)
    bst.update()
    state = resilience.capture_training_state(bst)
    bst2 = _booster(BASE, seed=5, n=256)
    resilience.restore_training_state(bst2, state)   # must not raise
    assert "does not match" in capsys.readouterr().err
    bst2.update()
    assert bst2.num_trees() == 1


# ---------------------------------------------------------------------------
# abrupt death, corrupt snapshot and preemption in a subprocess (the JAX
# package's CLI wiring, application.py:182-300, driven from Python)
# ---------------------------------------------------------------------------

DRIVER = r'''
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.runtime import resilience
root, out, data, resume, rounds, freq = sys.argv[1:7]
rounds, freq = int(rounds), int(freq)
d = np.load(data)
params = dict(objective="binary", num_leaves=12, max_bin=63, verbose=-1,
              bagging_fraction=0.7, bagging_freq=1, feature_fraction=0.8,
              seed=7, device_type="cpu")
state = init = None
if resume == "1":
    snap, state = resilience.find_resume_snapshot(out)
    if snap is not None:
        print("Resuming from snapshot %s (iteration %d)"
              % (snap, state["total_iter"]), flush=True)
        init = snap
callbacks = []
if state is not None:
    callbacks.append(resilience.make_resume_callback(state))
if freq > 0:
    def snapshot(env):
        total = env.model.current_iteration()
        if total % freq == 0:
            resilience.write_snapshot(env.model, out, total_iter=total)
    callbacks.append(snapshot)
guard = resilience.PreemptionGuard(out)
callbacks.append(guard.callback)
remaining = rounds - (state["total_iter"] if state is not None else 0)
try:
    with guard:
        bst = lt.train(params, lt.Dataset(d["X"], label=d["y"]), remaining,
                       init_model=init, callbacks=callbacks,
                       verbose_eval=False)
except resilience.TrainingPreempted as e:
    print("preempted at iteration %d, snapshot %s" % (e.iteration,
                                                      e.snapshot))
    sys.exit(0)
bst.save_model(out)
'''


def _drive(d, out, resume=False, rounds=8, freq=2, fault=None):
    env = dict(os.environ)
    env.pop("LGBM_TPU_FAULT", None)
    if fault:
        env["LGBM_TPU_FAULT"] = fault
    return subprocess.run(
        [sys.executable, "-c", DRIVER, str(ROOT), str(d / out),
         str(d / "data.npz"), "1" if resume else "0", str(rounds),
         str(freq)], env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    """An uninterrupted run, one killed abruptly entering iteration 5 with
    its newest snapshot (4) torn, and the resumed continuation."""
    d = tmp_path_factory.mktemp("resume")
    X, y, _ = _data(seed=12)
    np.savez(d / "data.npz", X=X, y=y)
    a = _drive(d, "a.txt")
    assert a.returncode == 0, a.stderr
    crash = _drive(d, "b.txt", fault="die_at_iter:5,corrupt_snapshot:4")
    post = {"model_written": (d / "b.txt").exists(),
            "ok2": resilience.validate_snapshot(
                str(d / "b.txt.snapshot_iter_2"))[0],
            "ok4": resilience.validate_snapshot(
                str(d / "b.txt.snapshot_iter_4"))[0]}
    resumed = _drive(d, "b.txt", resume=True)
    return d, crash, resumed, post


def test_abrupt_death_leaves_snapshots_not_models(driven):
    _, crash, _, post = driven
    assert crash.returncode == 137, crash.stderr
    assert "FAULT die_at_iter" in crash.stderr
    assert not post["model_written"]
    assert post["ok2"] and not post["ok4"]


def test_resume_falls_back_past_corrupt_snapshot_with_warning(driven):
    _, _, resumed, _ = driven
    text = resumed.stdout + resumed.stderr
    assert resumed.returncode == 0, resumed.stderr
    assert "snapshot_iter_4" in text and "invalid" in text
    assert "Resuming from snapshot" in text and "snapshot_iter_2" in text


def test_resume_reproduces_uninterrupted_model_byte_for_byte(driven):
    d = driven[0]
    assert (d / "b.txt").read_bytes() == (d / "a.txt").read_bytes()
    assert not [f for f in os.listdir(d) if ".tmp" in f]


def test_sigterm_writes_final_snapshot_and_resume_is_byte_identical(driven):
    d = driven[0]
    r = _drive(d, "c.txt", freq=0, fault="sigterm_at_iter:5")
    assert r.returncode == 0, r.stderr
    assert "preempt" in (r.stdout + r.stderr).lower()
    assert not (d / "c.txt").exists()
    snaps = resilience.snapshot_paths(str(d / "c.txt"))
    assert len(snaps) == 1 and snaps[0][0] == 6
    assert resilience.validate_snapshot(snaps[0][1])[0]
    assert _drive(d, "c.txt", resume=True, freq=0).returncode == 0
    assert (d / "c.txt").read_bytes() == (d / "a.txt").read_bytes()


# ---------------------------------------------------------------------------
# snapshots across the two packages
# ---------------------------------------------------------------------------

CROSS = dict(BASE, bagging_fraction=0.6, bagging_freq=2,
             feature_fraction=0.8, seed=3)
LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-6


def _assert_models_match(bj, bt, X):
    """Node for node: split features, topology, counts, every row in the
    same leaf, leaves at LEAF_RTOL / LEAF_ATOL."""
    assert bt.num_trees() == bj.num_trees()
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        assert tt.num_leaves == tj.num_leaves
        nl = tj.num_leaves
        for k in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(tt, k)[:nl - 1],
                                          getattr(tj, k)[:nl - 1], err_msg=k)
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)
    np.testing.assert_array_equal(bt._model.predict_leaf_index(X),
                                  bj._model.predict_leaf_index(X))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's uninterrupted 8 iterations, with its snapshot of
    iteration 4."""
    d = tmp_path_factory.mktemp("cross")
    X, y, w = _data(seed=21)
    bst = lj.Booster(dict(CROSS), lj.Dataset(X, label=y, weight=w))
    snap = None
    for i in range(8):
        bst.update()
        if i + 1 == 4:
            snap = jres.write_snapshot(bst, str(d / "j.txt"))
    return bst, snap, (X, y, w), d


def test_jax_snapshot_resumed_by_port_matches_jax(jax_run):
    bj, snap, (X, y, w), _ = jax_run
    assert resilience.validate_snapshot(snap)[0]
    state = resilience.load_snapshot_state(snap)
    bt = lt.train(_cpu(CROSS), lt.Dataset(X, label=y, weight=w), 4,
                  init_model=snap,
                  callbacks=[resilience.make_resume_callback(state)],
                  verbose_eval=False)
    _assert_models_match(bj, bt, X)


def test_port_snapshot_validates_and_loads_in_jax(jax_run, tmp_path):
    _, _, (X, y, w), _ = jax_run
    bt = lt.Booster(_cpu(CROSS), lt.Dataset(X, label=y, weight=w))
    for _ in range(4):
        bt.update()
    path = resilience.write_snapshot(bt, str(tmp_path / "t.txt"))
    assert jres.validate_snapshot(path) == (True, "ok")
    state = jres.load_snapshot_state(path)
    assert state["total_iter"] == 4 and state["K"] == 1
    assert set(state) == set(resilience.load_snapshot_state(path))
    from lightgbm_tpu.models.gbdt_model import GBDTModel as JModel
    assert JModel.load_model(path).current_iteration == 4
    # and the JAX package resumes from it to a model matching the port's
    # uninterrupted run
    bj = lj.train(dict(CROSS), lj.Dataset(X, label=y, weight=w), 4,
                  init_model=path,
                  callbacks=[jres.make_resume_callback(state)],
                  verbose_eval=False)
    for _ in range(4):
        bt.update()
    _assert_models_match(bj, bt, X)


# ---------------------------------------------------------------------------
# the non-finite sentinel against the JAX package
# ---------------------------------------------------------------------------

BURST_AT = 3


def _burst_fobj(y, w, kind):
    calls = {"n": 0}

    def fobj(preds, dataset):
        p = 1.0 / (1.0 + np.exp(-preds))
        g, h = (p - y) * w, p * (1.0 - p) * w
        if calls["n"] == BURST_AT:
            g, h = g.copy(), h.copy()
            if kind == "nan grad":
                g[::7] = np.nan
            elif kind == "inf grad":
                g[::7] = np.inf
            elif kind == "nan hess":
                h[::7] = np.nan
        calls["n"] += 1
        return g, h
    return fobj


def _sentinel_run(mod, res, kind, policy):
    X, y, w = _data(seed=6)
    params = dict(BASE, sentinel_nonfinite=policy)
    fobj = None
    if kind != "nan_grad fault":
        params["objective"] = "none"
        fobj = _burst_fobj(y, w, kind)
    if mod is lt:
        params["device_type"] = "cpu"
    bst = mod.Booster(params, mod.Dataset(X, label=y, weight=w))
    done, raised = [], None
    try:
        for _ in range(6):
            done.append(bst.update(fobj=fobj))
            if done[-1]:
                break
    except res.NonFiniteDetected as e:
        raised = e
    return bst, done, raised


@pytest.mark.parametrize("policy", ["abort", "rollback"])
@pytest.mark.parametrize("kind", ["nan grad", "inf grad", "nan hess",
                                  "nan_grad fault"])
def test_sentinel_matches_jax(monkeypatch, kind, policy):
    """A real burst from a custom objective, or nan_grad:3 on the builtin
    one: caught at the same iteration as the JAX package (abort: the same
    raised iteration and field; rollback: the same surviving trees, the
    same finished report, scores within tolerance)."""
    if kind == "nan_grad fault":
        monkeypatch.setenv("LGBM_TPU_FAULT", "nan_grad:%d" % BURST_AT)
    bt, dt, et = _sentinel_run(lt, resilience, kind, policy)
    bj, dj, ej = _sentinel_run(lj, jres, kind, policy)
    if policy == "abort":
        assert et is not None and ej is not None
        assert (et.iteration, et.field) == (ej.iteration, ej.field) == \
            (BURST_AT, "leaf values")
        return
    assert et is None and ej is None
    assert dt == dj == [False] * BURST_AT + [True]
    assert bt.num_trees() == bj.num_trees() == BURST_AT
    st, sj = bt._engine.raw_train_score(), np.asarray(
        bj._engine.raw_train_score())
    assert np.isfinite(st).all()
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)
    assert bt.host_syncs_per_tree() == \
        [2 if kind != "nan_grad fault" else 1] * BURST_AT


def test_sentinel_rollback_restores_scores_bit_for_bit():
    """K = 3 with a validation set: the rollback drops the iteration's
    three trees, puts back the pre-iteration training and validation
    scores bit for bit and stops; the guard's copies stay on the device,
    so every tree keeps its one blocking sync."""
    X, y, w = _data(seed=8, classes=3)
    params = _cpu(dict(BASE, objective="multiclass", num_class=3,
                       sentinel_nonfinite="rollback"))
    ds = lt.Dataset(X[:1200], label=y[:1200], weight=w[:1200])
    bst = lt.Booster(params, ds)
    bst.add_valid(lt.Dataset(X[1200:], label=y[1200:], reference=ds), "v")
    for _ in range(BURST_AT):
        assert bst.update() is False
    pre = (bst._engine.raw_train_score(), bst._engine.raw_valid_score(0))
    os.environ["LGBM_TPU_FAULT"] = "nan_grad:%d" % BURST_AT
    try:
        assert bst.update() is True
    finally:
        del os.environ["LGBM_TPU_FAULT"]
    assert bst.num_trees() == 3 * BURST_AT
    post = (bst._engine.raw_train_score(), bst._engine.raw_valid_score(0))
    for a, b in zip(pre, post):
        assert a.view(np.int32).tobytes() == b.view(np.int32).tobytes()
    assert bst.host_syncs_per_tree() == [1] * (3 * BURST_AT)
    # training goes on from the restored scores when driven again
    assert bst.update() is False
    assert np.isfinite(bst._engine.raw_train_score()).all()


def test_sentinel_off_by_default_costs_nothing(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FAULT", "nan_grad:0")
    bst = _booster(BASE, seed=6)
    assert bst.update() is False
    assert bst.num_trees() == 1
    assert resilience.NONFINITE_KEY not in tgbdt.GBDT.__dict__


def test_sentinel_unknown_policy_is_abort():
    """The JAX package's validation: a policy other than off, abort or
    rollback warns and aborts."""
    bst = _booster(dict(BASE, sentinel_nonfinite="panic"))
    assert bst._engine._sentinel_policy == "abort"
    bj = lj.Booster(dict(BASE, sentinel_nonfinite="panic"),
                    lj.Dataset(*_data()[:2]))
    assert bj._engine._sentinel_policy == "abort"


def test_sentinel_flag_catches_finite_leaves():
    """The fill's flag: a tree whose leaf values came out finite from
    non-finite gradients (the card's fixed-point sums can do that) is
    still caught, by the gradients."""
    bst = _booster(dict(BASE, sentinel_nonfinite="abort"))
    bst.update()
    host = {"num_leaves": np.int32(1), "leaf_value": np.zeros(12),
            "internal_value": np.zeros(11),
            resilience.NONFINITE_KEY: np.ones(1, np.float32)}
    with pytest.raises(resilience.NonFiniteDetected, match="gradients"):
        resilience.sentinel_check(bst._engine, host)
    host[resilience.NONFINITE_KEY] = np.zeros(1, np.float32)
    resilience.sentinel_check(bst._engine, host)
