"""tree_learner=data|voting|feature through the port's public API, beside
the JAX package's learners (the port's counterpart of
tests/test_tree_learner_wiring.py).

Two spawned gloo ranks (tests/torch_dist_worker.py) run every case in one
spawn; the JAX package trains the same data on its 2-device mesh here.
Covered: EFB-bundled data parallel (the replicated search), forced
splits and GOSS under feature parallel, lambdarank and multiclass under
data parallel, DART, RF and leaf renewal under data parallel, GOSS under
data parallel (global selection), and int8 gradient quantization on the
data and feature learners, which quantize every row alike and sum int32
histograms exactly, so their models are equal.  In process: the serial
fallback without a group and the num_machines check.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from conftest import assert_models_equivalent
from test_efb import _sparse_problem

import torch_dist_worker as W

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1,
        "min_data_in_leaf": 20, "min_gain_to_split": 0.01, "seed": 7}


def _binary(n=2000, f=6, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] - 0.6 * X[:, 3] + 0.4 * X[:, 1] * X[:, 4]
         + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    return {"X": X, "y": y,
            "weight": rng.uniform(0.5, 1.5, n).astype(np.float32)}


def _efb():
    X, y = _sparse_problem()
    w = np.random.default_rng(2).uniform(0.5, 1.5, len(y))
    return {"X": X.astype(np.float32), "y": y, "weight": w.astype(np.float32)}


def _rank():
    rng = np.random.default_rng(5)
    sizes = np.clip((rng.pareto(1.5, 120) + 1) * 8, 1, 60).astype(int)
    n = int(sizes.sum())
    X = rng.standard_normal((n, 6)).astype(np.float32)
    rel = np.clip(np.round(X[:, 0] * 1.2 + 0.4 * X[:, 1] + 1.5
                           + 0.3 * rng.standard_normal(n)), 0, 3)
    return {"X": X, "y": rel.astype(np.float32), "group": sizes,
            "weight": None}


def _multiclass():
    rng = np.random.default_rng(12)
    X = rng.standard_normal((2000, 8)).astype(np.float32)
    y = ((np.abs(X[:, 0]) + X[:, 1] > 0.8).astype(int)
         + (X[:, 2] > 0.5).astype(int))
    return {"X": X, "y": y.astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, 2000).astype(np.float32)}


def _regression():
    d = _binary(seed=9)
    rng = np.random.default_rng(9)
    d["y"] = (d["X"][:, 0] * 2 + d["X"][:, 1] ** 2
              + rng.standard_normal(len(d["y"])) * 0.3).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def forced_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("forced") / "forced.json"
    path.write_text(json.dumps({"feature": 3, "threshold": 0.1,
                                "left": {"feature": 4, "threshold": -0.2}}))
    return str(path)


def _cases(forced):
    """(name, params, data, rounds, JAX reference params or None)."""
    binary, efb = _binary(), _efb()
    efb_params = dict(BASE, max_bin=63)
    rank_p = {"objective": "lambdarank", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 10, "min_gain_to_split": 0.01}
    mc_p = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
            "verbose": -1, "min_data_in_leaf": 20, "min_gain_to_split": 0.01}
    goss = dict(BASE, boosting="goss", learning_rate=0.5, top_rate=0.3,
                other_rate=0.2)
    q8 = dict(BASE, gradient_quantization=True, gradient_quant_dtype="int8")
    rf = dict(BASE, boosting="rf", bagging_fraction=0.7, bagging_freq=1,
              feature_fraction=0.8)
    cases = [
        ("efb data", dict(efb_params, tree_learner="data"), efb, 6,
         dict(efb_params, tree_learner="data", num_machines=2)),
        # the JAX package grows forced splits under feature on its masked
        # mesh grower, which drops them; its serial learner applies them,
        # as the reference's feature-parallel learner does
        ("feature forced",
         dict(BASE, tree_learner="feature", forcedsplits_filename=forced),
         binary, 4, dict(BASE, forcedsplits_filename=forced)),
        ("feature goss", dict(goss, tree_learner="feature"), binary, 5,
         dict(goss, tree_learner="feature", num_machines=2)),
        ("lambdarank data", dict(rank_p, tree_learner="data"), _rank(), 4,
         dict(rank_p, tree_learner="data", num_machines=2)),
        ("multiclass data", dict(mc_p, tree_learner="data"), _multiclass(),
         4, dict(mc_p, tree_learner="data", num_machines=2)),
        ("dart data", dict(BASE, boosting="dart", drop_rate=0.3,
                           drop_seed=4, tree_learner="data"), binary, 5,
         dict(BASE, boosting="dart", drop_rate=0.3, drop_seed=4,
              tree_learner="data", num_machines=2)),
        ("rf data", dict(rf, tree_learner="data"), binary, 4,
         dict(rf, tree_learner="data", num_machines=2)),
        ("l1 renewal data", dict(BASE, objective="regression_l1",
                                 tree_learner="data"), _regression(), 4,
         dict(BASE, objective="regression_l1", tree_learner="data",
              num_machines=2)),
        ("goss data", dict(goss, tree_learner="data"), binary, 5, None),
        ("int8 data", dict(q8, tree_learner="data"), binary, 4, None),
        ("int8 feature", dict(q8, tree_learner="feature"), binary, 4, None),
        ("int8 voting full vote", dict(q8, tree_learner="voting", top_k=6),
         binary, 4, None),
    ]
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory, forced_file):
    cases = _cases(forced_file)
    jobs = [(p, d, n) for _, p, d, n, _ in cases]
    out = W.run_ranks(tmp_path_factory.mktemp("learner"), "jobs", (jobs,),
                      world=2, timeout=300)
    return {c[0]: (c, out[0][i], out[1][i]) for i, c in enumerate(cases)}


def _jax(params, d, rounds):
    ds = lj.Dataset(d["X"], label=d["y"], weight=d.get("weight"),
                    group=d.get("group"))
    return lj.train(dict(params), ds, rounds)


JAX_CASES = ["efb data", "feature forced", "feature goss", "lambdarank data",
             "multiclass data", "dart data", "rf data", "l1 renewal data"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_matches_jax(runs, name):
    (_, params, d, rounds, jparams), r0, r1 = runs[name]
    assert r0["mode"] == params["tree_learner"] and r0["world"] == 2
    assert r1["model"] == r0["model"]
    bj = _jax(jparams, d, rounds)
    if "tree_learner" in jparams:
        assert bj._engine.parallel_mode == jparams["tree_learner"]
    if name == "efb data":
        assert bj._engine.train_set.bundle_info is not None
    assert_models_equivalent(r0["model"], bj.model_to_string())


def test_forced_splits_lead_every_tree(runs):
    _, r0, _ = runs["feature forced"]
    heads = [ln for ln in r0["model"].splitlines()
             if ln.startswith("split_feature=")]
    assert heads and all(h.split("=")[1].split()[:2] == ["3", "4"]
                         for h in heads)


def test_goss_data_parallel_selects_globally(runs):
    """GOSS under data parallel draws over the global rows in original
    order (one exchange gathers the blocks): both ranks hold one model,
    as good as the serial learner's on the training rows."""
    (_, params, d, rounds, _), r0, r1 = runs["goss data"]
    assert r1["model"] == r0["model"]
    serial = lt.train(dict(params, tree_learner="serial",
                           device_type="cpu"),
                      lt.Dataset(d["X"], label=d["y"], weight=d["weight"]),
                      rounds)
    par = lt.Booster(params={"device_type": "cpu"}, model_str=r0["model"])

    def logloss(b):
        p = np.clip(b.predict(d["X"]), 1e-7, 1 - 1e-7)
        return -np.mean(d["y"] * np.log(p) + (1 - d["y"]) * np.log(1 - p))

    assert abs(logloss(par) - logloss(serial)) < 0.02


def test_int8_learners_agree(runs):
    """Every rank and learner rounds a row by its original row's draw
    at the global scales, and int32 histograms sum exactly: the data,
    feature and full-vote voting learners grow one model."""
    a = runs["int8 data"][1]["model"]
    assert runs["int8 feature"][1]["model"] == a
    assert runs["int8 voting full vote"][1]["model"] == a
    assert runs["int8 data"][2]["model"] == a


def test_single_process_trains_serially():
    """No process group: tree_learner=data trains the serial learner with
    the JAX package's warning, to the serial model."""
    d = _binary(n=600)
    ds = lambda: lt.Dataset(d["X"], label=d["y"], weight=d["weight"])  # noqa
    p = dict(BASE, device_type="cpu")
    a = lt.train(dict(p, tree_learner="data"), ds(), 3)
    b = lt.train(p, ds(), 3)
    assert a._engine.parallel_mode is None
    assert a.model_to_string().replace("tree_learner: data",
                                       "tree_learner: serial") \
        == b.model_to_string()


def test_num_machines_must_match_the_group():
    d = _binary(n=600)
    with pytest.raises(lt.LightGBMError, match="num_machines=2"):
        lt.train(dict(BASE, device_type="cpu", tree_learner="data",
                      num_machines=2),
                 lt.Dataset(d["X"], label=d["y"]), 1)
