"""Phase timers (utils/timer.py, tpu_profile_phases, Booster.phase_timings)
of the PyTorch port against the JAX package's (lightgbm_tpu/utils/timer.py,
gbdt.py's piecewise profiled path) on the same CPU inputs: the same phase
names in the same order, and the same model text with the timers on and
off in every grower mode."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.runtime import syncs
from lightgbm_tpu_torch.utils.timer import PhaseTimer

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

N, F, ROUNDS = 1500, 6, 4
BASE = dict(objective="binary", num_leaves=15, max_bin=63, verbose=-1,
            min_gain_to_split=0.01)
CONFIGS = {
    "one-leaf": {},
    "frontier 8": dict(tpu_frontier_batch=8),
    "int8": dict(gradient_quantization=True, gradient_quant_dtype="int8"),
    "bagging": dict(bagging_fraction=0.5, bagging_freq=1),
    "goss": dict(boosting="goss", top_rate=0.2, other_rate=0.1,
                 learning_rate=0.5),
    "l1 renewal": dict(objective="regression_l1"),
    "multiclass": dict(objective="multiclass", num_class=3),
    "dart": dict(boosting="dart", drop_rate=0.5),
    "rf": dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
               feature_fraction=0.8),
}


def _data(config):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((N, F))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(N)
    y = np.digitize(s, [-0.4, 0.4]).astype(np.float64) \
        if config == "multiclass" else (s > 0).astype(np.float64)
    return X, y, rng.uniform(0.5, 1.5, N)


def _train(mod, config, profile, **extra):
    X, y, w = _data(config)
    params = dict(BASE, **CONFIGS[config], **extra)
    if profile:
        params["tpu_profile_phases"] = True
    if mod is lt:
        params["device_type"] = "cpu"
    return mod.train(params, mod.Dataset(X, label=y, weight=w), ROUNDS,
                     verbose_eval=False)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_phase_names_match_jax(config):
    bt = _train(lt, config, True)
    bj = _train(lj, config, True)
    assert list(bt.phase_timings()) == list(bj.phase_timings())
    assert all(v >= 0.0 for v in bt.phase_timings().values())
    assert bt.phase_timings()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_model_byte_identical_with_timers(config):
    off = _train(lt, config, False)
    on = _train(lt, config, True)
    assert on.model_to_string() == off.model_to_string()
    assert off.phase_timings() == {}


def test_validation_set_and_phase_sum():
    """With a validation set the valid score update is timed too (and
    waited for); the phases sum to at most the training's wall time."""
    import time
    X, y, w = _data("one-leaf")
    params = dict(BASE, device_type="cpu", tpu_profile_phases=True)
    ds = lt.Dataset(X[:1000], label=y[:1000], weight=w[:1000])
    dv = lt.Dataset(X[1000:], label=y[1000:], reference=ds)
    t0 = time.perf_counter()
    bst = lt.train(params, ds, ROUNDS, valid_sets=[dv], verbose_eval=False)
    wall = time.perf_counter() - t0
    table = bst.phase_timings()
    assert "valid score update" in table
    assert sum(table.values()) <= wall
    plain = lt.train(dict(params, tpu_profile_phases=False), ds, ROUNDS,
                     valid_sets=[dv], verbose_eval=False)
    assert plain.model_to_string() == bst.model_to_string()


def test_profile_syncs_are_labelled():
    """Each timed phase ends in one wait through the sync seam, labelled
    profile_sync: the fill, the growth and the score add, beside the
    tree's one tree_fetch."""
    before = syncs.snapshot()
    bst = _train(lt, "one-leaf", True)
    d = syncs.delta(before)["by_label"]
    assert d["tree_fetch"] == ROUNDS
    assert d["profile_sync"] == 3 * ROUNDS
    assert bst.host_syncs_per_tree() == [4] * ROUNDS
    assert _train(lt, "one-leaf", False).host_syncs_per_tree() == \
        [1] * ROUNDS


def test_loaded_booster_has_no_timings():
    text = _train(lt, "one-leaf", True).model_to_string()
    assert lt.Booster(params={"device_type": "cpu"},
                      model_str=text).phase_timings() == {}


def test_phase_timer_unit():
    """utils/timer.py's PhaseTimer as the JAX package's: disabled, nothing
    is kept; enabled, seconds and calls accumulate per name in first-seen
    order, report returns the table."""
    off = PhaseTimer(False)
    with off.phase("a"):
        pass
    off.sync(torch.zeros(2))
    assert off.seconds == {} and off.report() is None
    on = PhaseTimer(True)
    before = syncs.snapshot()
    for _ in range(2):
        with on.phase("first"):
            on.sync({"x": torch.ones(3)})
        with on.phase("second"):
            pass
    assert list(on.seconds) == ["first", "second"]
    assert on.calls == {"first": 2, "second": 2}
    assert syncs.delta(before)["by_label"] == {"profile_sync": 2}
    assert on.report() == dict(on.seconds)
