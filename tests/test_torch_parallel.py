"""The port's distributed learners against the JAX package's mesh.

Two gloo ranks of the port (spawned, tests/torch_dist_worker.py) train
tree_learner=data, voting and feature on the CPU; the JAX package trains
the same data on a 2-device mesh in this process (conftest's 8 host
devices, num_machines=2 caps the mesh at 2, gbdt.py:962-963).  Held node
for node to the serial parity tests' tolerance (conftest's
assert_models_equivalent: structure exact, values within rtol 1e-4),
with weighted rows and min_gain_to_split=0.01 so no two candidates tie.
Each rank's model text equals rank 0's.  One spawn serves every case.
"""
import numpy as np
import pytest

import lightgbm_tpu as lj
from conftest import assert_models_equivalent
from lightgbm_tpu_torch.ops import segment as tseg
from lightgbm_tpu_torch.ops.segment import GUARD

import torch_dist_worker as W

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 20, "min_gain_to_split": 0.01, "seed": 3}
ROUNDS = 5

#: (case, extra params of both packages)
CASES = [
    ("data", dict(tree_learner="data")),
    ("voting full vote", dict(tree_learner="voting", top_k=6)),
    ("voting restricted", dict(tree_learner="voting", top_k=2)),
    ("feature", dict(tree_learner="feature")),
    ("data bagged", dict(tree_learner="data", bagging_fraction=0.7,
                         bagging_freq=1, feature_fraction=0.8)),
]


def _problem(n=2000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n)
         > 0).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return {"X": X, "y": y, "weight": w}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _problem()
    jobs = [(dict(PARAMS, **extra), data, ROUNDS) for _, extra in CASES]
    tmp = tmp_path_factory.mktemp("parallel")
    port = W.run_ranks(tmp, "jobs", (jobs,), world=2)
    return data, port


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c for c, _ in CASES])
def test_learner_matches_jax_mesh(runs, i):
    data, port = runs
    case, extra = CASES[i]
    r0, r1 = port[0][i], port[1][i]
    assert r0["mode"] == extra["tree_learner"] and r0["world"] == 2
    # every rank holds the same model
    assert r1["model"] == r0["model"]
    bj = lj.train(dict(PARAMS, num_machines=2, **extra),
                  lj.Dataset(data["X"], label=data["y"],
                             weight=data["weight"]), ROUNDS)
    eng = bj._engine
    assert eng.parallel_mode == extra["tree_learner"] and eng._fast_active
    assert_models_equivalent(r0["model"], bj.model_to_string())


def test_payload_blocks(runs):
    """data / voting: each rank's payload holds its block of n_pad / 2
    rows and its own guard; feature: every row."""
    _, port = runs
    for i, (case, extra) in enumerate(CASES):
        n_pad = port[0][i]["n_pad"]
        rows = port[0][i]["payload_rows"]
        if extra["tree_learner"] == "feature":
            assert rows == n_pad + GUARD, case
        else:
            assert rows == n_pad // 2 + GUARD, case


def test_exchanges_counted_per_tree(runs):
    """Every exchange is a labelled wait of the sync seam: the data
    learner's trees pay their tree_fetch, the fill's exponents, the
    root's histogram, totals, IEEE sums and winner, and two exchanges a
    split; feature pays no histogram exchange."""
    _, port = runs
    data_syncs = port[0][0]["host_syncs"]
    feat_syncs = port[0][3]["host_syncs"]
    assert all(s > 2 * 13 for s in data_syncs), data_syncs
    assert all(f < d for f, d in zip(feat_syncs, data_syncs))


def test_voting_full_vote_equals_data(runs):
    """With 2 top_k >= F the vote covers every feature: the voting
    learner grows the data learner's trees."""
    _, port = runs
    assert_models_equivalent(port[0][1]["model"], port[0][0]["model"])


#: the card's arithmetic on two ranks: (case, extra params, whether the
#: model must be the serial one byte for byte, seed of `_problem`).  With
#: a histogram pool the serial run takes the same pool.
POOL = dict(histogram_pool_size=0.05)
CARD_CASES = [
    ("data", dict(tree_learner="data"), True, 4),
    ("voting full vote", dict(tree_learner="voting", top_k=3), True, 4),
    ("voting restricted", dict(tree_learner="voting", top_k=1), False, 4),
    ("feature", dict(tree_learner="feature"), True, 4),
] + [
    ("%s pooled seed %d" % (name, seed), dict(extra, **POOL), True, seed)
    for seed in (4, 5)
    for name, extra in (("data", dict(tree_learner="data")),
                        ("voting full vote",
                         dict(tree_learner="voting", top_k=3)),
                        ("feature", dict(tree_learner="feature")))]


def _serial_key(extra, seed):
    return seed, extra.get("histogram_pool_size")


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    """Every case's ranks, then the serial runs they are held to, on one
    spawn; returns ({case index: (rank 0, rank 1)}, {serial key: rank 0's
    serial run})."""
    data = {seed: _problem(seed=seed) for seed in (4, 5)}
    jobs = [(dict(PARAMS, **extra), data[seed], ROUNDS)
            for _, extra, _, seed in CARD_CASES]
    keys = sorted({_serial_key(extra, seed)
                   for _, extra, _, seed in CARD_CASES},
                  key=lambda k: (k[0], k[1] or 0))
    jobs += [(dict(PARAMS, **({} if pool is None else
                              dict(histogram_pool_size=pool))),
              data[seed], ROUNDS) for seed, pool in keys]
    tmp = tmp_path_factory.mktemp("card")
    out = W.run_ranks(tmp, "card_jobs", (jobs,), world=2)
    n = len(CARD_CASES)
    return ({i: (out[0][i], out[1][i]) for i in range(n)},
            {k: out[0][n + j] for j, k in enumerate(keys)})


@pytest.mark.parametrize("i", range(len(CARD_CASES)),
                         ids=[c for c, _, _, _ in CARD_CASES])
def test_card_arithmetic_is_the_serial_tree(card_runs, i):
    """Under the card's fixed-point histograms (raw int64 cells on the
    wire): data, feature and a vote that selects every feature (2 top_k
    >= F) write the serial model byte for byte, with a histogram pool
    too (the serial run with the same pool: an evicted parent's larger
    child is the rebuilt parent less the smaller child, as the serial
    pooled grower subtracts); the restricted vote (2 top_k < F) grows
    trees of its own.  Every rank's model is rank 0's."""
    case, extra, exact, seed = CARD_CASES[i]
    (r0, r1), serials = card_runs[0][i], card_runs[1]
    serial = serials[_serial_key(extra, seed)]
    assert serial["mode"] is None
    assert r0["mode"] == extra["tree_learner"] and r0["world"] == 2
    assert r1["model"] == r0["model"]
    if exact:
        assert r0["model"] == serial["model"]
    else:
        assert r0["model"] != serial["model"]
        assert r0["model"].count("Tree=") == ROUNDS


def test_collectives(tmp_path):
    """parallel/comm.py over two ranks: sums, maxima, the padded
    reduce-scatter, gathers of tensors and objects."""
    out = W.run_ranks(tmp_path, "echo", world=2)
    a = np.arange(5)
    for r, o in enumerate(out):
        assert o["world"] == 2 and o["rank"] == r
        assert o["sum"] == list(2 * a + 10)
        assert o["max"] == list((a + 10).astype(float))
        full = list(2 * a + 10) + [0]          # padded to 6 rows
        assert o["scatter"] == full[3 * r:3 * r + 3]
        assert o["gather"] == [[0, 1], [10, 11]]
        assert o["objects"] == [{"r": 0}, {"r": 1}]


def test_raw_cells_sum_to_the_serial_histogram():
    """B1's and B7's raw output (plain version: segment.fixed_cells): the
    int64 cells of two row blocks add up to the whole segment's cells,
    and their conversion is segment_histogram_fixed bit for bit, so
    every rank's reduced histogram has the serial grower's bits."""
    rng = np.random.default_rng(4)
    import torch
    n, F, B = 3000, 5, 16
    pay = torch.zeros((n + GUARD, F + 3))
    pay[:n, :F] = torch.from_numpy(rng.integers(0, B, (n, F))
                                   .astype(np.float32))
    pay[:n, F] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    pay[:n, F + 1] = torch.from_numpy(rng.uniform(0.1, 1, n)
                                      .astype(np.float32))
    pay[:n, F + 2] = 1.0
    kw = dict(num_features=F, num_bins=B, grad_col=F, hess_col=F + 1,
              cnt_col=F + 2)
    scale = tseg.fixed_scale(pay, 0, n, F, F + 1)
    whole = tseg.fixed_cells(pay, 0, n, scale=scale, **kw)
    halves = (tseg.fixed_cells(pay, 0, 1400, scale=scale, **kw)
              + tseg.fixed_cells(pay, 1400, n - 1400, scale=scale, **kw))
    assert whole.dtype == torch.int64
    assert torch.equal(whole, halves)
    hist = tseg.segment_histogram_fixed(pay, 0, n, scale=scale, **kw)
    assert torch.equal(tseg.cells_to_hist(halves, scale).view(torch.int32),
                       hist.view(torch.int32))
    from lightgbm_tpu_torch.ops import cuda_segment
    for wrapper in (cuda_segment.segment_histogram,
                    cuda_segment.segment_histogram_colblock):
        got = wrapper(pay, 0, n, scale=scale, raw=True, **kw)
        assert torch.equal(got, whole)


# -- the standalone parallel train steps (parallel/*_parallel.py) --------

STEP_CFG = dict(num_leaves=16, max_depth=-1, lambda_l1=0.0, lambda_l2=0.0,
                max_delta_step=0.0, min_data_in_leaf=5,
                min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The port's three steps on two ranks, and the JAX package's on a
    2-device mesh, one step each from zero scores (the JAX package's
    tests/test_parallel.py problem: 1,024 rows, 6 features, 32 bins)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from lightgbm_tpu.boosting.gbdt import _feature_meta_device
    from lightgbm_tpu.boosting.grower import GrowerConfig as JCfg
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
    from lightgbm_tpu.parallel import data_parallel as jdp
    from lightgbm_tpu.parallel import feature_parallel as jfp
    from lightgbm_tpu.parallel import voting_parallel as jvp
    rng = np.random.default_rng(3)
    n = 1024
    X = rng.standard_normal((n, 6)).astype(np.float32)
    y = ((X[:, 0] > 0.2) ^ (X[:, 1] < -0.1)).astype(np.float32)
    port = W.run_ranks(tmp_path_factory.mktemp("steps"), "steps",
                       (X, y, STEP_CFG, 32), world=2)
    ds = JDataset.from_matrix(X, JConfig({"objective": "binary",
                                          "max_bin": 32}), row_chunk=n)
    meta = _feature_meta_device(ds)
    n_pad = ds.num_data_padded
    label, score = ds.padded(y), np.zeros(n_pad, np.float32)
    weight, mask = np.ones(n_pad, np.float32), ds.valid_row_mask()
    fmask = jnp.ones(ds.num_features, bool)
    ref = {}
    devs = np.array(jax.devices()[:2])
    mesh = Mesh(devs, (jdp.DATA_AXIS,))
    jcfg = JCfg(**STEP_CFG, row_chunk=n_pad // 2)
    for name, step in (
            ("data", jdp.make_data_parallel_train_step(
                meta, jcfg, ds.max_num_bin, mesh, learning_rate=0.1)),
            ("voting", jvp.make_voting_parallel_train_step(
                meta, jcfg, ds.max_num_bin, mesh, learning_rate=0.1,
                top_k=6))):
        s, tree = step(*jdp.shard_rows(mesh, ds.bins, score, label, weight,
                                       mask), fmask)
        ref[name] = (np.asarray(s), tree)
    fmesh = Mesh(devs, (jfp.FEATURE_AXIS,))
    bins_p, fmask_p, f_padded = jfp.pad_features(
        ds.bins, np.ones(ds.num_features, bool), 2)
    step = jfp.make_feature_parallel_train_step(
        jfp.pad_feature_meta(meta, f_padded), JCfg(**STEP_CFG,
                                                   row_chunk=n_pad),
        ds.max_num_bin, fmesh, learning_rate=0.1)
    b, fm, sc, lb, wt, mk = jfp.shard_features(fmesh, bins_p, fmask_p, score,
                                               label, weight, mask)
    s, tree = step(b, sc, lb, wt, mk, fm)
    ref["feature"] = (np.asarray(s), tree)
    return port, ref


@pytest.mark.parametrize("mode", ["data", "voting", "feature"])
def test_parallel_step_matches_jax(steps, mode):
    """make_{data,voting,feature}_parallel_train_step over a process group:
    the JAX step's tree (split features and bins exact, leaf values to
    rtol 1e-4) and its score update, every rank the same tree."""
    port, ref = steps
    (s0, t0), (s1, t1) = port[0][mode], port[1][mode]
    js, jt = ref[mode]
    nl = int(jt["num_leaves"])
    assert int(t0["num_leaves"]) == int(t1["num_leaves"]) == nl > 1
    for k in ("split_feature", "split_bin"):
        np.testing.assert_array_equal(t0[k][:nl - 1],
                                      np.asarray(jt[k])[:nl - 1])
        np.testing.assert_array_equal(t1[k], t0[k])
    np.testing.assert_allclose(t0["leaf_value"][:nl],
                               np.asarray(jt["leaf_value"])[:nl],
                               rtol=1e-4, atol=1e-6)
    got = np.concatenate([s0, s1]) if mode != "feature" else s0
    np.testing.assert_allclose(got, js, rtol=1e-4, atol=1e-6)


def test_steps_refuse_several_score_planes():
    """The standalone steps drive one score plane, as the JAX package's:
    a multiclass objective is refused (call a step per class plane)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.parallel._common import resolve_objective
    obj = create_objective("multiclass", lt.Config({"objective":
                                                    "multiclass",
                                                    "num_class": 3}))
    with pytest.raises(lt.LightGBMError, match="one score plane"):
        resolve_objective(obj)
    assert resolve_objective(None).num_model_per_iteration == 1
