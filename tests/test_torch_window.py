"""The port's boosting window (boost_window=J; tests/test_window.py
mirrored on the CPU).

A window dispatches J iterations' trees with no host read between them
and one wait for their stacked records; update() then reports them one
at a time, and an observation point that lands mid-window truncates it
by exact snapshot replay.  The final models equal the per-tree loop's
byte for byte for plain gbdt, bagging, multiclass and a no-split stop,
at J in {1, 2, 4} and at every pipeline depth; the validation scores
are the same bits; the steady state captures nothing new and pays at
most 1/J of the per-tree loop's blocking fetches; the configurations
outside the window's envelope train through the per-tree loop; and the
windowed port stays within the parity tolerance of the JAX package run
with the same knobs.
"""
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.runtime import graph_obs, syncs, telemetry

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)


def _data(n=500, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] + 0.4 * X[:, 1]
         + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    return X, y


BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1, "seed": 7,
        "device_type": "cpu"}
BAGGED = {**BASE, "bagging_freq": 2, "bagging_fraction": 0.7,
          "feature_fraction": 0.8}
MULTI = {"objective": "multiclass", "num_class": 3, "num_leaves": 8,
         "verbose": -1, "seed": 7, "device_type": "cpu"}


def _train(params, X, y, rounds=8, **kw):
    return lt.train(dict(params), lt.Dataset(X, label=y),
                    num_boost_round=rounds, verbose_eval=False, **kw)


def _booster(params, X, y):
    return lt.Booster(dict(params), lt.Dataset(X, label=y))


@pytest.fixture(scope="module")
def problems():
    """(X, y) plus the per-tree loop's model strings (pipeline_depth=0,
    boost_window=1) the identity matrix compares against."""
    X, y = _data()
    rng = np.random.default_rng(1)
    y3 = rng.integers(0, 3, len(y)).astype(np.float64)
    sync = {"pipeline_depth": 0}
    refs = {
        "gbdt": _train({**BASE, **sync}, X, y).model_to_string(),
        "bagging": _train({**BAGGED, **sync}, X, y).model_to_string(),
        "multiclass": _train({**MULTI, **sync}, X, y3,
                             rounds=6).model_to_string(),
    }
    return X, y, y3, refs


def _trunc_count():
    return telemetry.counter("lgbm_window_truncations_total").total()


@pytest.mark.parametrize("J", [1, 2, 4])
def test_identity_gbdt(problems, J):
    X, y, _, refs = problems
    for depth in (0, 1, 2):
        m = _train({**BASE, "boost_window": J, "pipeline_depth": depth},
                   X, y)
        assert m.model_to_string() == refs["gbdt"], depth


@pytest.mark.parametrize("J", [2, 4])
@pytest.mark.parametrize("rounds", [5, 9])
def test_identity_per_tree_iteration_after_a_window(problems, J, rounds,
                                                    monkeypatch):
    """engine.train's horizon ends the run with a per-tree iteration
    after a window (rounds - i < J); at depth >= 1 that tree lands after
    the window's, in dispatch order, even when the window's drain lands
    only after its last iteration was reported (held back here)."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    X, y, _, _ = problems
    ref = _train({**BASE, "pipeline_depth": 0}, X, y, rounds=rounds)
    wait = GBDT._wait_record

    def late(slot, label):
        if label == "window_drain":
            time.sleep(0.05)
        return wait(slot, label)

    monkeypatch.setattr(GBDT, "_wait_record", staticmethod(late))
    for depth in (1, 2):
        m = _train({**BASE, "boost_window": J, "pipeline_depth": depth},
                   X, y, rounds=rounds)
        assert m.model_to_string() == ref.model_to_string(), depth


@pytest.mark.parametrize("J", [2, 4])
def test_identity_bagging(problems, J):
    """The window's bags and feature masks are drawn ahead from the host
    streams the per-tree loop draws from, at the same positions (freq 2
    against J = 4 puts a resample mid-window)."""
    X, y, _, refs = problems
    for depth in (0, 2):
        m = _train({**BAGGED, "boost_window": J, "pipeline_depth": depth},
                   X, y)
        assert m.model_to_string() == refs["bagging"], depth


@pytest.mark.parametrize("J", [2, 4])
def test_identity_multiclass(problems, J):
    """K trees an iteration off one pre-iteration score snapshot, as the
    per-tree loop's snapshot and per-class steps."""
    X, _, y3, refs = problems
    m = _train({**MULTI, "boost_window": J}, X, y3, rounds=6)
    assert m.model_to_string() == refs["multiclass"]


@pytest.mark.parametrize("J", [2, 4])
def test_identity_early_stop_truncation(J):
    """A no-split stop found inside a window leaves the per-tree loop's
    model: the stop lands through the window's drain and the iterations
    past it are never reported (here the 15th iteration's tree is the
    stump: mid-window at J = 4, a window's first at J = 2)."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((80, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 20,
         "min_gain_to_split": 12.0, "verbose": -1, "seed": 3,
         "device_type": "cpu"}
    ref = _train({**p, "pipeline_depth": 0}, X, y, rounds=20)
    for depth in (0, 1):
        win = _train({**p, "boost_window": J, "pipeline_depth": depth}, X,
                     y, rounds=20)
        assert win.model_to_string() == ref.model_to_string()
        assert win.num_trees() == ref.num_trees() == 15


def test_truncation_mid_window_scores_and_model(problems):
    """A training-score read mid-window truncates by exact snapshot
    replay: the model and the f32 training scores equal the per-tree
    loop's bits, training goes on correctly after it, and the window
    adapts to the cut."""
    X, y, _, _ = problems
    ref_b = _booster({**BAGGED, "pipeline_depth": 0}, X, y)
    for _ in range(6):
        ref_b.update()
    s_ref = ref_b.model_to_string()
    sc_ref = ref_b._engine.raw_train_score()

    win_b = _booster({**BAGGED, "boost_window": 4}, X, y)
    win_b.update()
    win_b.update()
    truncs0 = _trunc_count()
    mid = win_b._engine.raw_train_score()          # observation point
    assert _trunc_count() == truncs0 + 1
    ref_mid = _booster({**BAGGED, "pipeline_depth": 0}, X, y)
    ref_mid.update()
    ref_mid.update()
    assert np.array_equal(mid, ref_mid._engine.raw_train_score())
    assert win_b._engine._win_adapt == 2            # adapted to the cut
    for _ in range(4):
        win_b.update()
    assert win_b.model_to_string() == s_ref
    assert np.array_equal(win_b._engine.raw_train_score(), sc_ref)


def test_model_view_mid_window_is_cheap_and_exact(problems):
    """Model reads mid-window see exactly the reported iterations (the
    window's later trees never leak into the model) and do not truncate
    it."""
    X, y, _, refs = problems
    win_b = _booster({**BASE, "boost_window": 4}, X, y)
    win_b.update()
    win_b.update()
    truncs0 = _trunc_count()
    assert win_b.current_iteration() == 2
    assert win_b.num_trees() == 2
    mid_str = win_b.model_to_string()
    assert _trunc_count() == truncs0, "a model view must not truncate"
    assert win_b._engine._win is not None, "the window must stay open"
    ref_mid = _booster({**BASE, "pipeline_depth": 0}, X, y)
    ref_mid.update()
    ref_mid.update()
    assert mid_str == ref_mid.model_to_string()
    for _ in range(6):
        win_b.update()
    assert win_b.model_to_string() == refs["gbdt"]


def test_rollback_one_iter_mid_window(problems):
    """rollback_one_iter mid-window settles the window at the reported
    iteration first, then rolls back as the per-tree loop does."""
    X, y, _, _ = problems
    ref_b = _booster({**BAGGED, "pipeline_depth": 0}, X, y)
    for _ in range(3):
        ref_b.update()
    ref_b.rollback_one_iter()
    for _ in range(3):
        ref_b.update()

    win_b = _booster({**BAGGED, "boost_window": 4}, X, y)
    for _ in range(3):
        win_b.update()
    win_b.rollback_one_iter()
    for _ in range(3):
        win_b.update()
    assert win_b.model_to_string() == ref_b.model_to_string()


def test_reset_parameter_is_an_observation_point(problems):
    """A learning-rate change mid-window applies from the next reported
    iteration, as in the per-tree loop: the window that trained ahead at
    the old rate is truncated."""
    X, y, _, _ = problems
    ref_b = _booster({**BASE, "pipeline_depth": 0}, X, y)
    ref_b.update()
    ref_b.update()
    ref_b.reset_parameter({"learning_rate": 0.23})
    for _ in range(3):
        ref_b.update()

    win_b = _booster({**BASE, "boost_window": 4}, X, y)
    win_b.update()
    win_b.update()
    win_b.reset_parameter({"learning_rate": 0.23})
    for _ in range(3):
        win_b.update()
    assert win_b.model_to_string() == ref_b.model_to_string()


def test_engine_train_with_valid_sets_disables_lookahead(problems):
    """engine.train's horizon: with an eval round every iteration the
    window must not run ahead at all, so it never truncates, and the
    model and the validation scores are the per-tree loop's bits."""
    X, y, _, _ = problems

    def run(params):
        dv = lt.Dataset(X[400:], label=y[400:])
        return lt.train(dict(params), lt.Dataset(X[:400], label=y[:400]),
                        num_boost_round=5, valid_sets=[dv],
                        verbose_eval=False)

    truncs0 = _trunc_count()
    ref = run({**BASE, "pipeline_depth": 0})
    win = run({**BASE, "boost_window": 4})
    assert win.model_to_string() == ref.model_to_string()
    np.testing.assert_array_equal(win._engine.raw_valid_score(0),
                                  ref._engine.raw_valid_score(0))
    assert _trunc_count() == truncs0, \
        "the horizon must prevent mid-window truncations entirely"


def test_window_zero_recapture_and_fetch_reduction(problems):
    """Steady state with windows on: further iterations build nothing in
    the program ledger, the window's shape is a ledger cache hit, and
    the blocking fetches an iteration drop to at most 1/J of the per-tree
    loop's."""
    X, y, _, _ = problems

    def steady(params, iters=8):
        bst = _booster(params, X, y)
        for _ in range(4):                     # warm: the payload, the
            bst.update()                       # grower, the first window
        bst._engine.flush()
        c0 = graph_obs.snapshot()
        s0 = syncs.snapshot()
        hits0 = graph_obs.LEDGER.register("gbdt.window_cache").cache_hits
        graph_obs.mark_steady(True)
        try:
            for _ in range(iters):
                bst.update()
            bst._engine.flush()
        finally:
            graph_obs.mark_steady(False)
        hits = graph_obs.LEDGER.register("gbdt.window_cache").cache_hits
        return (graph_obs.delta(c0), syncs.delta(s0)["total"] / iters,
                hits - hits0)

    built_off, fetch_off, _ = steady(BASE)
    built_on, fetch_on, hits = steady({**BASE, "boost_window": 4})
    assert built_off == {} and built_on == {}
    assert fetch_on <= fetch_off / 4 + 1e-9, (fetch_on, fetch_off)
    assert hits == 2


def test_window_ineligible_configs_fall_back():
    """Configurations outside the window's envelope (GOSS, DART, leaf
    renewal, quantized gradients, the phase timers) train through the
    per-tree loop with boost_window set: the models without it."""
    X, y = _data(n=300)
    for extra in ({"boosting": "goss"},
                  {"boosting": "dart", "drop_seed": 5},
                  {"objective": "regression_l1"},
                  {"gradient_quantization": True},
                  {"tpu_profile_phases": True}):
        p = {"objective": "binary", "num_leaves": 8, "verbose": -1,
             "seed": 11, "device_type": "cpu", **extra}
        yy = np.abs(y) if extra.get("objective") else y
        ref = _train(p, X, yy, rounds=4)
        win = _train({**p, "boost_window": 4}, X, yy, rounds=4)
        assert win.model_to_string() == ref.model_to_string(), extra
        assert win._engine._win_shapes == set(), extra


def test_window_valid_scores_bit_for_bit_across_depth_and_j(problems):
    """Booster.update driven windows with a validation set: the
    validation scores move as each iteration is reported, so after every
    update they are the per-tree loop's bits, at every depth and J."""
    X, y, _, _ = problems

    def run(params):
        bst = _booster(params, X[:400], y[:400])
        bst.add_valid(lt.Dataset(X[400:], label=y[400:],
                                 reference=bst.train_set), "v")
        out = []
        for _ in range(6):
            bst.update()
            out.append(bst._engine.raw_valid_score(0).copy())
        return bst.model_to_string(), out

    ref_text, ref_scores = run({**BASE, "pipeline_depth": 0})
    for depth, J in ((1, 1), (2, 1), (0, 2), (1, 4), (2, 4)):
        text, scores = run({**BASE, "pipeline_depth": depth,
                            "boost_window": J})
        assert text == ref_text, (depth, J)
        for a, b in zip(scores, ref_scores):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("knobs", [dict(boost_window=4),
                                   dict(boost_window=2, pipeline_depth=2)])
def test_windowed_port_matches_jax(knobs):
    """The windowed port against the JAX package run with the same
    boost_window and pipeline_depth, on weighted rows, to the parity
    tests' structure and leaf-value tolerance."""
    rng = np.random.default_rng(9)
    X = rng.standard_normal((2000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(2000)
         > 0).astype(np.float64)
    w = rng.uniform(0.5, 1.5, 2000)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "seed": 5, **knobs}
    bj = lj.train(dict(params), lj.Dataset(X, label=y, weight=w), 6,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), 6, verbose_eval=False)
    assert bt.num_trees() == bj.num_trees() == 6
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
