"""Lambdarank in the port against the JAX package on the CPU (the same
seeded numpy inputs): the pairwise gradients against the JAX objective
and the reference loop of tests/test_rank.py at all-zero scores (every
query one tie) and at random scores, NDCG@k / MAP@k against
lightgbm_tpu/metric/rank.py, the eval_at expansion, lambdarank trained
node for node on synthetic query groups (tests/test_rank.py:_synth_rank
and a heavy-tailed variant), the group accessors, and a grouped
validation set's NDCG record."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metric import create_metrics as j_metrics
from lightgbm_tpu.objective.rank import LambdarankNDCG as JRank
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metric import create_metrics as t_metrics
from lightgbm_tpu_torch.objective import rank as trank

from test_rank import _synth_rank, reference_lambdas
from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

#: query sizes crossing the size classes (1, 2, powers of two and one
#: past them) and one query far longer than the rest
SIZES = [7, 1, 12, 5, 9, 33, 2, 64, 65, 16, 17, 130]
#: gradients against the JAX objective: rtol 1e-5, with an atol of 1e-6
#: of the largest |lambda| for lambdas that are sums of cancelling pair
#: terms (each package adds a query's terms in its own order)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
#: against the f64 reference loop the same rule: the f32 rounding of each
#: pair term (exp, divide) stays within 2e-7 of the largest |lambda| in
#: the cancelling sums at these inputs
REF_ATOL = 1e-6
#: leaf values, as tests/test_torch_regression_train.py
LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-6
PARAMS = dict(objective="lambdarank", num_leaves=15, max_bin=63,
              learning_rate=0.1, verbose=-1, metric="ndcg",
              eval_at=[1, 3, 5])


def _groups(seed=3, sizes=SIZES):
    rng = np.random.default_rng(seed)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = int(qb[-1])
    return rng, qb, n, rng.integers(0, 5, n).astype(np.float64)


def _ragged_rank(n_q, seed, f=6):
    """_synth_rank's relevance on heavy-tailed query sizes (a Pareto law,
    1 to 150 documents)."""
    rng = np.random.default_rng(seed)
    sizes = np.clip((rng.pareto(1.5, n_q) + 1) * 8, 1, 150).astype(int)
    n = int(sizes.sum())
    X = rng.standard_normal((n, f))
    rel = np.clip(np.round(X[:, 0] * 1.2 + 0.4 * X[:, 1] + 1.5
                           + 0.3 * rng.standard_normal(n)), 0, 3)
    return X, rel.astype(np.float64), sizes


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scores", ["zero", "random"])
def test_gradients_match_jax_and_reference(scores, weighted):
    rng, qb, n, label = _groups(3 + weighted)
    score = np.zeros(n) if scores == "zero" else rng.normal(size=n)
    weight = rng.uniform(0.5, 1.5, n) if weighted else None
    w = weight if weighted else np.ones(n)
    pad = 13   # the trainer passes padded rows, weight 0
    cfg = dict(objective="lambdarank")
    oj, ot = JRank(JConfig(cfg)), trank.LambdarankNDCG(TConfig(cfg))
    oj.init(label, weight, qb)
    ot.init(label, weight, qb)
    s32 = np.concatenate([score, np.zeros(pad)]).astype(np.float32)
    w32 = np.concatenate([w, np.zeros(pad)]).astype(np.float32)
    gj, hj = oj.get_gradients(jnp.asarray(s32[:n]), None,
                              jnp.asarray(w32[:n]))
    gt, ht = ot.get_gradients(torch.from_numpy(s32), None,
                              torch.from_numpy(w32))
    assert gt.shape == (n + pad,) and gt.dtype == torch.float32
    assert not gt[n:].any() and not ht[n:].any()
    gt, ht = gt[:n].numpy(), ht[:n].numpy()
    for got, want in ((gt, np.asarray(gj)), (ht, np.asarray(hj))):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(want).max())
    g_ref, h_ref = reference_lambdas(s32[:n].astype(np.float64), label, qb)
    for got, want in ((gt, g_ref * w), (ht, h_ref * w)):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=REF_ATOL * np.abs(want).max())
    if scores == "zero":
        # the tie case: a query's lambdas follow its stable order
        assert np.abs(gt).max() > 0


def test_size_classes_and_chunks(monkeypatch):
    """Each query sits in the block of its size class, in one slot; a
    chunk budget of a few pairs cuts the blocks into many chunks and
    changes no bit."""
    rng, qb, n, label = _groups(5)
    cfg = TConfig(dict(objective="lambdarank"))
    ot = trank.LambdarankNDCG(cfg)
    ot.init(label, None, qb)
    assert [b["S"] for b in ot.blocks] == [1, 2, 8, 16, 32, 64, 128, 256]
    assert sorted(ot.slot.tolist()) == sorted(set(ot.slot.tolist()))
    score = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    ones = torch.ones(n)
    g, h = ot.get_gradients(score, None, ones)
    monkeypatch.setattr(trank, "PAIR_CHUNK", 300)
    small = trank.LambdarankNDCG(cfg)
    small.init(label, None, qb)
    assert max(b["chunk"] for b in small.blocks) < len(SIZES)
    g2, h2 = small.get_gradients(score, None, ones)
    assert torch.equal(g, g2) and torch.equal(h, h2)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_rank_metrics_match_jax(name, weighted):
    rng, qb, n, label = _groups(7 + weighted)
    label[qb[3]:qb[4]] = 0           # a query with no relevant document
    weight = rng.uniform(0.5, 1.5, n) if weighted else None
    cfg = dict(eval_at=[1, 3, 10])
    mj = j_metrics([name], JConfig(cfg))
    mt = t_metrics([name], TConfig(cfg))
    assert [m.name for m in mt] == [m.name for m in mj] == \
        ["%s@%d" % (name, k) for k in (1, 3, 10)]
    # rounded scores: ties inside queries, broken by the stable sort
    score = np.round(rng.normal(size=n), 1)
    for a, b in zip(mt, mj):
        a.init(label, weight, qb)
        b.init(label, weight, qb)
        assert a.is_higher_better and not a.multiclass
        assert a.eval(score, None) == b.eval(score, None)


def test_metric_names_expand_like_jax():
    for names, cfg in ((["ndcg"], {}), (["ndcg@3", "map@2,4"], {}),
                       (["map"], dict(eval_at=[7])),
                       (["ndcg", "auc"], dict(eval_at=[2]))):
        got = [m.name for m in t_metrics(names, TConfig(cfg))]
        want = [m.name for m in j_metrics(names, JConfig(cfg))]
        assert got == want
    assert [m.name for m in t_metrics(["ndcg"], TConfig({}))] == \
        ["ndcg@%d" % k for k in range(1, 6)]


@pytest.mark.parametrize("data", ["synth", "ragged"])
def test_lambdarank_trains_node_for_node(data):
    """Node for node on _synth_rank's equal queries and on heavy-tailed
    ones, with per-document weights on the ragged set."""
    if data == "synth":
        X, y, g = _synth_rank(80, 25, seed=5)
        w = None
    else:
        X, y, g = _ragged_rank(90, seed=6)
        w = np.random.default_rng(8).uniform(0.5, 1.5, len(y))
    bj = lj.train(PARAMS, lj.Dataset(X, label=y, group=g, weight=w), 3,
                  verbose_eval=False)
    bt = lt.train(dict(PARAMS, device_type="cpu"),
                  lt.Dataset(X, label=y, group=g, weight=w), 3,
                  verbose_eval=False)
    assert bt.current_iteration() == bj.current_iteration() == 3
    assert bt._model.objective_str == bj._model.objective_str
    _assert_same_structure(bj, bt, X)
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        nl = tj.num_leaves
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)
    np.testing.assert_allclose(bt._engine.raw_train_score(),
                               bj._engine.raw_train_score(), rtol=1e-5,
                               atol=1e-5)
    rt, rj = bt.eval_train(), bj.eval_train()
    assert [r[1] for r in rt] == [r[1] for r in rj] == \
        ["ndcg@1", "ndcg@3", "ndcg@5"]
    np.testing.assert_allclose([r[2] for r in rt], [r[2] for r in rj],
                               rtol=1e-6)
    assert bt.host_syncs_per_tree() == [1] * 3


def test_lambdarank_needs_groups():
    X, y, _ = _synth_rank(10, 10, seed=1)
    with pytest.raises(lt.LightGBMError, match="query"):
        lt.train(dict(PARAMS, device_type="cpu"), lt.Dataset(X, label=y), 1,
                 verbose_eval=False)


def test_group_accessors_match_jax():
    X, y, g = _synth_rank(6, 5, seed=2)
    g = np.array([5, 3, 7, 5, 6, 4])
    dj, dt = lj.Dataset(X, label=y, group=g), lt.Dataset(X, label=y, group=g)
    for field in ("group", "query"):
        np.testing.assert_array_equal(dt.get_field(field),
                                      dj.get_field(field))
    np.testing.assert_array_equal(dt.get_group(), g)
    np.testing.assert_array_equal(dt.binned.metadata.query_boundaries,
                                  dj.binned.metadata.query_boundaries)
    np.testing.assert_array_equal(dt.get_field("label"), y.astype(np.float32))
    # set before construct, then after it
    late = lt.Dataset(X, label=y)
    late.set_group([10, 20])
    np.testing.assert_array_equal(late.get_group(), [10, 20])
    late.set_group(g)
    np.testing.assert_array_equal(late.get_group(), g)
    assert lt.Dataset(X, label=y).get_group() is None
    with pytest.raises(lt.LightGBMError):
        lt.Dataset(X, label=y, group=[5, 5]).construct()
    with pytest.raises(lt.LightGBMError):
        dt.get_field("nothing")


def test_grouped_valid_set_records_match_jax():
    """A validation set with its own groups (reference=train): its NDCG
    records after every iteration, through engine.train's evals_result,
    equal the JAX package's."""
    X, y, g = _synth_rank(60, 20, seed=11)
    Xv, yv, _ = _ragged_rank(30, seed=12)
    gv = _ragged_rank(30, seed=12)[2]
    params = dict(PARAMS, eval_at=[3, 10])
    rj, rt = {}, {}
    dj = lj.Dataset(X, label=y, group=g)
    lj.train(params, dj, 3, valid_sets=[lj.Dataset(Xv, label=yv, group=gv,
                                                   reference=dj)],
             callbacks=[lj.record_evaluation(rj)], verbose_eval=False)
    dt = lt.Dataset(X, label=y, group=g)
    dvt = lt.Dataset(Xv, label=yv, group=gv, reference=dt)
    lt.train(dict(params, device_type="cpu"), dt, 3, valid_sets=[dvt],
             evals_result=rt, verbose_eval=False)
    np.testing.assert_array_equal(dvt.get_group(), gv)
    assert sorted(rt["valid_0"]) == sorted(rj["valid_0"]) == \
        ["ndcg@10", "ndcg@3"]
    for key in rt["valid_0"]:
        np.testing.assert_allclose(rt["valid_0"][key], rj["valid_0"][key],
                                   rtol=1e-6)
    assert rt["valid_0"]["ndcg@10"][-1] > 0.5
