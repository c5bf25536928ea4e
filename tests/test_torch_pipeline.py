"""The port's dispatch pipeline (pipeline_depth; tests/test_pipeline.py
mirrored on the CPU): models byte for byte with the pipeline on and off
across the boosting families, 0 blocking fetches on the tree-to-tree
critical path at depth 1, the flush barriers at model reads and at the
snapshot, fault-counter and online-cycle reads, the deferred no-split
stop, one packed fetch an eval round, the packed record's round trip, the
sentinel's synchronous path, the assembler's queue itself, the
distributed learners pipelined, and the pipelined port against the JAX
package run with the same knob."""
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.boosting.pipeline import TreeAssembler
from lightgbm_tpu_torch.runtime import continuous, resilience, syncs, telemetry

import torch_dist_worker as W
from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)


def _data(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 10)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2
         + rng.standard_normal(n) * 0.3 > 0).astype(float)
    return X, y


def _train(extra, depth, rounds=10, y=None, valid=False, seed=0):
    X, yb = _data(seed=seed)
    y = yb if y is None else y
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "pipeline_depth": depth, "device_type": "cpu"}
    params.update(extra)
    ds = lt.Dataset(X, label=y)
    kwargs = {}
    if valid:
        Xv = X[:400] + 0.01
        kwargs = dict(valid_sets=[lt.Dataset(Xv, label=y[:400],
                                             reference=ds)],
                      early_stopping_rounds=3)
    return lt.train(params, ds, num_boost_round=rounds, verbose_eval=False,
                    **kwargs)


def _booster(depth, **extra):
    X, y = _data()
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "pipeline_depth": depth, "device_type": "cpu", **extra}
    return lt.Booster(params, lt.Dataset(X, label=y))


CONFIGS = {
    "gbdt": {"metric": "auc"},
    "bagging": {"bagging_freq": 2, "bagging_fraction": 0.7,
                "metric": "auc"},
    "dart": {"boosting": "dart", "drop_rate": 0.3, "metric": "auc"},
    "goss": {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.2,
             "learning_rate": 0.3, "metric": "auc"},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_byte_identical_on_vs_off(name):
    extra = CONFIGS[name]
    b1 = _train(extra, depth=1, rounds=12)
    b0 = _train(extra, depth=0, rounds=12)
    assert b1.model_to_string() == b0.model_to_string()


def test_byte_identical_multiclass():
    rng = np.random.default_rng(3)
    ym = rng.integers(0, 3, 1500).astype(float)
    extra = {"objective": "multiclass", "num_class": 3,
             "metric": "multi_logloss"}
    b1 = _train(extra, depth=1, y=ym)
    b0 = _train(extra, depth=0, y=ym)
    assert b1.model_to_string() == b0.model_to_string()
    assert b1.num_trees() == 30


def test_byte_identical_with_valid_and_early_stopping():
    """The validation scores move by each tree's device half at every
    depth: the same bits, so early stopping stops at the same
    iteration."""
    runs = [_train({"metric": "auc", "learning_rate": 0.5}, depth=d,
                   rounds=40, valid=True)
            for d in (0, 1, 2)]
    b0 = runs[0]
    for b in runs[1:]:
        assert b.model_to_string() == b0.model_to_string()
        assert b.best_iteration == b0.best_iteration
        np.testing.assert_array_equal(b._engine.raw_valid_score(0),
                                      b0._engine.raw_valid_score(0))
    assert 0 < b0.best_iteration < 40


def test_byte_identical_depth_2():
    b2 = _train({"metric": "auc"}, depth=2, rounds=12)
    b0 = _train({"metric": "auc"}, depth=0, rounds=12)
    assert b2.model_to_string() == b0.model_to_string()


def test_sync_audit_zero_critical_path_fetches_at_depth_1():
    """The pin: at pipeline_depth=1 the tree-to-tree loop pays 0 blocking
    fetches on the critical path, every tree's record is waited for by
    the assembler (pipeline_drain), and host_syncs_per_tree still reads 1
    a tree.  At depth 0 the same loop pays one critical fetch a tree."""
    bst = _booster(1)
    bst.update()
    bst._engine.flush()
    syncs.reset()
    for _ in range(5):
        bst.update()
    snap = syncs.snapshot()
    assert snap["critical_path"] == 0, snap
    bst._engine.flush()
    assert syncs.snapshot()["by_label"].get("pipeline_drain") == 5
    assert bst.num_trees() == 6
    assert bst.host_syncs_per_tree() == [1] * 6
    assert bst.critical_syncs_per_tree() == [0] * 6

    bst0 = _booster(0)
    bst0.update()
    syncs.reset()
    for _ in range(5):
        bst0.update()
    snap0 = syncs.snapshot()
    assert snap0["critical_path"] == 5, snap0
    assert snap0["critical_by_label"] == {"tree_fetch": 5}
    assert bst0.host_syncs_per_tree() == [1] * 6
    assert bst0.critical_syncs_per_tree() == [1] * 6
    assert bst.model_to_string() == bst0.model_to_string()


def test_model_reads_flush_the_pipeline():
    """update() may return with trees being assembled; every model read
    drains first and sees every dispatched tree."""
    X, _ = _data()
    bst = _booster(2)
    for i in range(4):
        bst.update()
        assert bst.num_trees() == i + 1
        assert bst.current_iteration() == i + 1
    assert len(bst.feature_importance("split")) == 10
    assert bst.dump_model()["tree_info"] is not None
    p = bst.predict(X[:50])
    assert p.shape == (50,)
    assert bst._engine._assembler.pending == 0


def test_deferred_no_split_stop_matches_synchronous():
    """No split can pass min_gain_to_split: the synchronous loop stops
    after one stump; the pipelined loop finds the stop when the stump
    drains and rolls back what it dispatched past it.  The model is the
    same at every depth."""
    X, y = _data()
    ref = None
    for depth in (0, 1, 2):
        params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
                  "pipeline_depth": depth, "min_gain_to_split": 1e9,
                  "device_type": "cpu"}
        bst = lt.train(params, lt.Dataset(X, label=y), num_boost_round=10,
                       verbose_eval=False)
        assert bst.num_trees() == 1, depth
        assert bst.current_iteration() == 1, depth
        s = bst.model_to_string()
        ref = s if ref is None else ref
        assert s == ref, depth


def test_eval_round_is_one_packed_fetch():
    """Training with the training set and two validation sets evaluated
    every iteration pays ONE eval_fetch an iteration (every score plane
    packed into one transfer), off the critical path."""
    X, y = _data()
    ds = lt.Dataset(X, label=y)
    params = {"objective": "binary", "metric": "auc", "verbose": -1,
              "num_leaves": 15, "pipeline_depth": 1, "device_type": "cpu"}
    v1 = lt.Dataset(X[:300] + 0.01, label=y[:300], reference=ds)
    v2 = lt.Dataset(X[300:600] + 0.01, label=y[300:600], reference=ds)
    syncs.reset()
    evals = {}
    lt.train(params, ds, num_boost_round=5, verbose_eval=False,
             valid_sets=[ds, v1, v2], evals_result=evals)
    snap = syncs.snapshot()
    assert snap["by_label"].get("eval_fetch") == 5, snap
    assert snap["critical_by_label"].get("eval_fetch") is None
    assert sorted(evals) == ["training", "valid_1", "valid_2"]
    assert all(len(v["auc"]) == 5 for v in evals.values())


def test_packed_record_round_trip_is_exact():
    """A packed record (the one flat f32 vector a tree's drain copies)
    unpacks to its fields bit for bit: int32 travels as its bits (row
    counts past 2^24), flags as 0/1, f32 as itself.  The layout is derived
    from the fields at each pack, so no cache of specs is kept."""
    out = {"seg_start": torch.tensor([0, 2**24 + 1, 2**31 - 1],
                                     dtype=torch.int32),
           "leaf_value": torch.tensor([[0.1, -3.5e-8], [np.inf, -0.0]],
                                      dtype=torch.float32),
           "is_leaf": torch.tensor([True, False, True]),
           "num_leaves": 3}
    flat, layout = tgbdt._pack(out)
    assert flat.dtype == torch.float32 and flat.numel() == 3 + 4 + 3
    host = tgbdt._unpack(flat.numpy(), layout, out)
    assert host["num_leaves"] == 3
    for k in ("seg_start", "leaf_value", "is_leaf"):
        assert host[k].dtype == out[k].numpy().dtype, k
        assert np.array_equal(host[k].view(np.uint8),
                              out[k].numpy().view(np.uint8)), k


def test_sentinel_disables_pipeline_but_trains():
    """sentinel_nonfinite != off keeps the tree fetch synchronous (on the
    critical path), so the sentinel screens every iteration before the
    next dispatch."""
    bst = _booster(1, sentinel_nonfinite="abort")
    bst.update()
    syncs.reset()
    for _ in range(3):
        bst.update()
    snap = syncs.snapshot()
    assert snap["critical_by_label"].get("tree_fetch") == 3, snap
    assert bst.num_trees() == 4
    assert bst._engine._assembler is None


def test_dart_and_rf_stay_synchronous():
    """DART's normalization must know whether its iteration split and its
    next drops read every host tree; RF folds each host tree into its
    running average: both pay their tree_fetch on the critical path at
    every depth."""
    for extra in ({"boosting": "dart", "drop_rate": 0.3},
                  {"boosting": "rf", "bagging_freq": 1,
                   "bagging_fraction": 0.6, "feature_fraction": 0.8}):
        bst = _booster(2, **extra)
        syncs.reset()
        for _ in range(3):
            bst.update()
        assert syncs.snapshot()["critical_by_label"] == {"tree_fetch": 3}
        assert bst._engine._assembler is None
        assert bst.critical_syncs_per_tree() == [1] * 3


# -- the assembler ----------------------------------------------------------

def test_assembler_runs_in_submission_order():
    q = TreeAssembler(3)
    seen = []
    for i in range(20):
        q.submit(lambda i=i: (time.sleep(0.001 * (i % 3)), seen.append(i)))
    q.flush()
    assert seen == list(range(20))
    assert q.pending == 0 and q.pending_trees == 0


def test_assembler_backpressure_counts_the_running_unit():
    """At most `depth` units are pending or running: the third submit at
    depth 2 blocks until the first, running, unit finishes."""
    q = TreeAssembler(2)
    gate = threading.Event()
    q.submit(gate.wait, trees=3)
    q.submit(lambda: None, trees=1)
    assert q.pending == 2 and q.pending_trees == 4
    done = threading.Event()

    def third():
        q.submit(lambda: None)
        done.set()

    t = threading.Thread(target=third)
    t.start()
    assert not done.wait(0.2)
    gate.set()
    assert done.wait(5)
    t.join()
    q.flush()
    assert q.max_pending == 2


def test_assembler_defers_errors_to_submit_and_flush():
    q = TreeAssembler(1)
    q.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        q.flush()
    q.flush()     # raised once
    q.submit(lambda: 1 / 0)
    while q.pending:
        time.sleep(0.001)
    with pytest.raises(ZeroDivisionError):
        q.submit(lambda: None)
    q.flush()


def test_assembler_leaves_no_thread_after_flush():
    def assemblers():
        return {t for t in threading.enumerate()
                if t.name == "lgbm-torch-assembler"}

    # boosters of other tests in this process may hold parked workers
    before = assemblers()
    for _ in range(5):
        q = TreeAssembler(2)
        for _ in range(4):
            q.submit(lambda: None)
        q.flush()
        q.flush()
    assert assemblers() <= before
    bst = _booster(2)
    for _ in range(3):
        bst.update()
    assert bst.num_trees() == 3
    assert assemblers() <= before


# -- the direct model reads outside Booster ---------------------------------

def _gated_booster(monkeypatch, n=2):
    """A depth-2 Booster with `n` updates whose trees are still held in
    the assembler: their record waits block until a timer opens the gate
    0.3 s later.  A read that does not drain sees none of them."""
    gate = threading.Event()
    real = tgbdt.GBDT._wait_record

    def gated(slot, label):
        gate.wait()
        return real(slot, label)

    monkeypatch.setattr(tgbdt.GBDT, "_wait_record", staticmethod(gated))
    bst = _booster(2)
    for _ in range(n):
        bst.update()
    assert bst._engine._assembler.pending == n
    threading.Timer(0.3, gate.set).start()
    return bst


SITES = {
    "fault counter": lambda bst, mp, tmp: (
        mp.setattr(resilience, "_fault_spec",
                   lambda: {"die_at_iter": str(10 ** 9)}),
        resilience.maybe_die_or_preempt(bst),
        bst._engine.model.current_iteration)[-1],
    "capture_training_state": lambda bst, mp, tmp:
        resilience.capture_training_state(bst)["total_iter"],
    "snapshot model string": lambda bst, mp, tmp:
        resilience.snapshot_model_text(resilience.write_snapshot(
            bst, str(tmp / "m.txt"))).count("Tree="),
    "online cycle": lambda bst, mp, tmp:
        continuous.ContinuousTrainer._model_text(None, bst).count("Tree="),
}


@pytest.mark.parametrize("site", list(SITES))
def test_direct_model_reads_drain(site, monkeypatch, tmp_path):
    """The reads that bypass Booster's own entry points drain the
    pipeline first: the fault spec's iteration count, the snapshot's
    training state and its model string, and the online cycle's model
    text (its iteration count reads Booster.current_iteration)."""
    bst = _gated_booster(monkeypatch)
    assert SITES[site](bst, monkeypatch, tmp_path) == 2
    assert bst._engine._assembler.pending == 0


# -- the distributed learners and the JAX package ---------------------------

def test_distributed_learner_pipelined(tmp_path):
    """tree_learner=data over two gloo ranks: the exchanges stay on the
    dispatch thread and the assembler only waits and assembles, so depth
    2 writes depth 0's model on every rank; the boosting window stays off
    the mesh (the JAX package's rule) and changes nothing."""
    X, y = _data(n=1200)
    data = {"X": X, "y": y}
    base = {"objective": "binary", "num_leaves": 7, "verbose": -1,
            "tree_learner": "data", "min_gain_to_split": 0.01}
    jobs = [(dict(base, pipeline_depth=d, boost_window=j), data, 4)
            for d, j in ((0, 1), (2, 1), (1, 4))]
    ranks = W.run_ranks(tmp_path, "jobs", (jobs,), world=2)
    ref = ranks[0][0]["model"]
    for r in ranks:
        assert [job["mode"] for job in r] == ["data"] * 3
        assert [job["model"] for job in r] == [ref] * 3


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_port_matches_jax(depth):
    """The pipelined port against the JAX package run with the same
    pipeline_depth, on weighted rows, to the parity tests' structure and
    leaf-value tolerance."""
    X, y = _data(n=2000, seed=4)
    w = np.random.default_rng(104).uniform(0.5, 1.5, len(y))
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "pipeline_depth": depth}
    bj = lj.train(dict(params), lj.Dataset(X, label=y, weight=w), 6,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), 6, verbose_eval=False)
    assert bt.num_trees() == bj.num_trees() == 6
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def test_pipeline_telemetry_rows():
    """The queue-depth gauge and the drain histogram carry the pipeline's
    work; the queue never passes its bound."""
    h = telemetry.histogram("lgbm_pipeline_drain_seconds")
    c0 = h.state()["count"]
    bst = _booster(2)
    for _ in range(6):
        bst.update()
    bst._engine.flush()
    assert h.state()["count"] == c0 + 6
    assert 1 <= bst._engine._assembler.max_pending <= 2
    assert telemetry.gauge("lgbm_pipeline_queue_depth").value() == 0
