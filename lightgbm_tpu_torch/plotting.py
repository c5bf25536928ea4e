"""Plotting library (counterpart of lightgbm_tpu/plotting.py; reference
python-package/lightgbm/plotting.py).

Same four entry points — plot_importance, plot_metric, plot_tree,
create_tree_digraph — rebuilt on this package's Booster/GBDTModel
introspection (dump_model tree_info JSON, feature_importance arrays).
They read the host model only, so they run wherever the model was
trained.  matplotlib and graphviz are optional: each function raises
ImportError with an actionable message only when called.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster
from .utils.log import LightGBMError


def _check_not_tuple_of_2_elements(obj, obj_name: str = "obj") -> None:
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _float2str(value: float, precision: Optional[int]) -> str:
    if precision is not None and not isinstance(value, str):
        return f"{value:.{precision}f}"
    return str(value)


def _decorate_axes(ax, xlim, ylim, title, xlabel, ylabel, grid: bool):
    """Shared axes finishing: explicit limits are validated, None limits
    keep whatever default the caller computed, labels apply when given."""
    for lim, setter, name in ((xlim, ax.set_xlim, "xlim"),
                              (ylim, ax.set_ylim, "ylim")):
        if lim is not None:
            _check_not_tuple_of_2_elements(lim, name)
            setter(lim)
    for text, setter in ((title, ax.set_title), (xlabel, ax.set_xlabel),
                         (ylabel, ax.set_ylabel)):
        if text is not None:
            setter(text)
    ax.grid(grid)
    return ax


def _to_booster(booster) -> Booster:
    """Accept Booster or a fitted sklearn estimator."""
    if isinstance(booster, Booster):
        return booster
    inner = getattr(booster, "booster_", None)
    if isinstance(inner, Booster):
        return inner
    raise TypeError("booster must be a Booster or a fitted LGBMModel instance")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple] = None, ylim: Optional[Tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize: Optional[Tuple] = None,
                    dpi: Optional[int] = None, grid: bool = True,
                    precision: Optional[int] = 3, **kwargs):
    """Horizontal bar chart of per-feature importances."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("You must install matplotlib to plot importance.") from e

    booster = _to_booster(booster)
    importance = np.asarray(
        booster.feature_importance(importance_type=importance_type))
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    # ascending by importance so the largest bar lands on top; stable sort
    # keeps tied features in model order like the reference plot
    order = np.argsort(importance, kind="stable")
    if ignore_zero:
        order = order[importance[order] > 0]
    if max_num_features is not None and max_num_features > 0:
        order = order[-max_num_features:]
    if not len(order):
        raise ValueError("No features with non-zero importance to plot.")
    values = importance[order]
    labels = [feature_name[i] for i in order]

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    fmt = ((lambda v: _float2str(v, precision))
           if importance_type == "gain" else (lambda v: str(int(v))))
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, fmt(x), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)

    if xlim is None:
        ax.set_xlim((0, float(values.max()) * 1.1))
    if ylim is None:
        ax.set_ylim((-1, len(values)))
    return _decorate_axes(ax, xlim, ylim, title, xlabel, ylabel, grid)


def plot_metric(booster: Union[Dict, Booster], metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None,
                ax=None, xlim: Optional[Tuple] = None,
                ylim: Optional[Tuple] = None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                figsize: Optional[Tuple] = None, dpi: Optional[int] = None,
                grid: bool = True):
    """Plot one metric's eval history recorded by record_evaluation()."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("You must install matplotlib to plot metric.") from e

    if isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif hasattr(booster, "evals_result_"):  # fitted LGBMModel
        eval_results = deepcopy(booster.evals_result_)
        if not eval_results:
            raise LightGBMError(
                "Fit the estimator with at least one eval_set to plot metric.")
    elif isinstance(booster, Booster):
        raise LightGBMError(
            "Booster does not record eval history itself; pass the dict "
            "filled by the record_evaluation() callback instead.")
    else:
        raise TypeError("booster must be dict, Booster or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    if dataset_names is None:
        dataset_names = iter(eval_results.keys())
    elif not dataset_names:
        raise ValueError("dataset_names cannot be empty.")
    else:
        dataset_names = iter(dataset_names)

    name = next(dataset_names)
    metrics_for_one = eval_results[name]
    num_metric = len(metrics_for_one)
    if metric is None:
        if num_metric > 1:
            raise ValueError("to plot, metric must be specified "
                             "when multiple metrics were evaluated")
        metric, results = metrics_for_one.popitem()
    else:
        if metric not in metrics_for_one:
            raise KeyError("No given metric in eval results.")
        results = metrics_for_one[metric]
    num_iteration = len(results)
    max_result, min_result = max(results), min(results)
    x_ = range(num_iteration)
    ax.plot(x_, results, label=name)

    for name in dataset_names:
        metrics_for_one = eval_results[name]
        results = metrics_for_one[metric]
        max_result = max(*results, max_result)
        min_result = min(*results, min_result)
        ax.plot(x_, results, label=name)

    ax.legend(loc="best")
    if xlim is None:
        ax.set_xlim((0, num_iteration))
    if ylim is None:
        spread = max_result - min_result
        ax.set_ylim((min_result - spread * 0.2, max_result + spread * 0.2))
    if ylabel == "auto":
        ylabel = metric
    return _decorate_axes(ax, xlim, ylim, title, xlabel, ylabel, grid)


def _to_graphviz(tree_info: Dict, show_info: List[str],
                 feature_names: Optional[List[str]],
                 precision: Optional[int] = 3, **kwargs):
    """Build a graphviz Digraph from one dump_model() tree_info entry."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("You must install graphviz to plot tree.") from e

    def add(root: Dict, parent: Optional[str] = None, decision: Optional[str] = None):
        if "split_index" in root:
            name = f"split{root['split_index']}"
            fidx = root["split_feature"]
            if feature_names is not None:
                label = f"<B>{feature_names[fidx]}</B>"
            else:
                label = f"feature <B>{fidx}</B>"
            op = root["decision_type"]
            label = f"<{label} {op} <B>{_float2str(root['threshold'], precision)}</B>"
            for info in ("split_gain", "internal_value", "internal_count"):
                if info in show_info:
                    output = info.split("_")[-1]
                    label += f"<br/>{_float2str(root[info], precision)} {output}"
            label += ">"
            graph.node(name, label=label)
            add(root["left_child"], name, "yes" if root["default_left"] else "no")
            add(root["right_child"], name, "no" if root["default_left"] else "yes")
        else:
            name = f"leaf{root['leaf_index']}"
            label = f"leaf {root['leaf_index']}: "
            label += f"<<B>{_float2str(root['leaf_value'], precision)}</B>"
            if "leaf_count" in show_info and "leaf_count" in root:
                label += f"<br/>{root['leaf_count']} count"
            label += ">"
            graph.node(name, label=label)
        if parent is not None:
            graph.edge(parent, name, decision)

    graph = Digraph(**kwargs)
    structure = tree_info["tree_structure"]
    if "split_index" not in structure:  # stump
        graph.node("leaf0", label=str(structure.get("leaf_value", 0.0)))
    else:
        add(structure)
    return graph


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: Optional[int] = 3, **kwargs):
    """Digraph of one tree from the model dump."""
    booster = _to_booster(booster)
    model = booster.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names")
    if tree_index < len(tree_infos):
        tree_info = tree_infos[tree_index]
    else:
        raise IndexError("tree_index is out of range.")
    if show_info is None:
        show_info = []
    return _to_graphviz(tree_info, show_info, feature_names, precision, **kwargs)


def plot_tree(booster, ax=None, tree_index: int = 0,
              figsize: Optional[Tuple] = None, dpi: Optional[int] = None,
              show_info: Optional[List[str]] = None,
              precision: Optional[int] = 3, **kwargs):
    """Render one tree into a matplotlib axes (via graphviz png)."""
    try:
        import matplotlib.image as image
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("You must install matplotlib to plot tree.") from e

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                **kwargs)
    from io import BytesIO
    s = BytesIO()
    s.write(graph.pipe(format="png"))
    s.seek(0)
    img = image.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
