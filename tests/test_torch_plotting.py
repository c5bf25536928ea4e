"""The port's plotting functions on the CPU (tests/test_plotting.py's
five cases, on the Agg backend, skipping where that file skips), and
against the JAX package's on the same model string: plot_importance's
bar values and create_tree_digraph's source equal."""
import numpy as np
import pytest
import torch

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

import lightgbm_tpu as lj  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((400, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    clf = lt.LGBMClassifier(n_estimators=6, num_leaves=7, verbose=-1,
                            device_type="cpu")
    clf.fit(X, y, eval_set=[(X, y)])
    return clf


def test_plot_importance(trained):
    ax = lt.plot_importance(trained)
    assert len(ax.patches) > 0
    ax2 = lt.plot_importance(trained.booster_, importance_type="gain",
                             max_num_features=3, precision=2)
    assert len(ax2.patches) <= 3


def test_plot_metric(trained):
    ax = lt.plot_metric(trained)
    assert ax.get_ylabel() == "binary_logloss"
    rec = {}
    rng = np.random.default_rng(1)
    X = rng.standard_normal((200, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    ds = lt.Dataset(X, label=y)
    lt.train({"objective": "binary", "metric": "auc", "verbose": -1,
              "device_type": "cpu"}, ds, num_boost_round=4, valid_sets=[ds],
             valid_names=["train"], callbacks=[lt.record_evaluation(rec)])
    ax2 = lt.plot_metric(rec, metric="auc")
    assert ax2.get_ylabel() == "auc"
    assert len(ax2.get_lines()[0].get_ydata()) == 4


def test_plot_metric_rejects_bare_booster(trained):
    with pytest.raises(lt.LightGBMError):
        lt.plot_metric(trained.booster_)


def test_create_tree_digraph(trained):
    g = lt.create_tree_digraph(trained, tree_index=1,
                               show_info=["internal_count", "leaf_count"])
    src = g.source
    assert "split1" in src or "split0" in src
    assert "leaf" in src
    with pytest.raises(IndexError):
        lt.create_tree_digraph(trained, tree_index=99)


def test_plot_tree(trained):
    try:
        ax = lt.plot_tree(trained, tree_index=0)
    except Exception as e:  # graphviz binary may be absent
        if "failed to execute" in str(e) or \
                "ExecutableNotFound" in type(e).__name__:
            pytest.skip("graphviz dot binary unavailable")
        raise
    assert not ax.axison


@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_plots_match_jax_on_the_same_model(trained, importance_type):
    """The port's model text loaded by both packages: plot_importance
    draws the same bars (widths and labels) and create_tree_digraph
    writes the same graphviz source for every tree."""
    text = trained.booster_.model_to_string()
    bt, bj = lt.Booster(model_str=text), lj.Booster(model_str=text)
    at = lt.plot_importance(bt, importance_type=importance_type, precision=4)
    aj = lj.plot_importance(bj, importance_type=importance_type, precision=4)
    assert [p.get_width() for p in at.patches] == \
        [p.get_width() for p in aj.patches]
    assert [t.get_text() for t in at.get_yticklabels()] == \
        [t.get_text() for t in aj.get_yticklabels()]
    assert [t.get_text() for t in at.texts] == [t.get_text() for t in aj.texts]
    info = ["split_gain", "internal_value", "internal_count", "leaf_count"]
    for i in range(bt.num_trees()):
        assert lt.create_tree_digraph(bt, tree_index=i, show_info=info,
                                      precision=5).source == \
            lj.create_tree_digraph(bj, tree_index=i, show_info=info,
                                   precision=5).source
