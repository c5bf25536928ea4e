"""scikit-learn estimator API (counterpart of lightgbm_tpu/sklearn.py).

Role parity with the reference python-package/lightgbm/sklearn.py
(LGBMModel:128, LGBMRegressor:650, LGBMClassifier:676, LGBMRanker:800,
objective/eval closures via _ObjectiveFunctionWrapper/_EvalFunctionWrapper
:17-127), over the port's `basic` and `engine`.  Works with or without
scikit-learn installed: when available the estimators inherit
BaseEstimator so grid-search/pipeline/clone work.  Like every entry point
of the port, fit trains on the card unless the estimator is given
device_type="cpu" (a keyword passed through to the engine's parameters,
as any other LightGBM parameter is).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

try:  # pragma: no cover - environment-dependent
    from sklearn.base import BaseEstimator as _SKBase
except Exception:  # sklearn absent
    _SKBase = object


class _Base(_SKBase):
    """get/set_params that also surface **kwargs pass-through params, so
    clone/GridSearchCV see them (reference sklearn.py get_params override)."""

    def _named_params(self) -> List[str]:
        import inspect
        return [k for k in inspect.signature(self.__init__).parameters
                if k != "kwargs"]

    def get_params(self, deep: bool = True) -> Dict:
        out = {k: getattr(self, k) for k in self._named_params()}
        out.update(getattr(self, "_other_params", {}))
        return out

    def set_params(self, **params) -> "_Base":
        named = set(self._named_params())
        for k, v in params.items():
            setattr(self, k, v)
            if k not in named:
                self._other_params[k] = v
        return self


class _ObjectiveFunctionWrapper:
    """Wrap a sklearn-style objective fn(y_true, y_pred[, group]) -> (grad,
    hess) into the engine's fobj(preds, dataset) (sklearn.py:17-84)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_group())
        else:
            raise TypeError("Self-defined objective should have 2 or 3 arguments")
        return np.asarray(grad), np.asarray(hess)


class _EvalFunctionWrapper:
    """Wrap fn(y_true, y_pred[, weight[, group]]) -> (name, value,
    is_higher_better) into feval(preds, dataset) (sklearn.py:86-127)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(), dataset.get_group())
        raise TypeError("Self-defined eval function should have 2, 3 or 4 arguments")


def _compute_class_sample_weight(y, class_weight, sample_weight):
    """'balanced' or {label: weight} per-sample weights multiplied into any
    explicit sample_weight (reference _LGBMComputeSampleWeight usage)."""
    if class_weight is None:
        return sample_weight
    classes, counts = np.unique(y, return_counts=True)
    if class_weight == "balanced":
        w_map = {c: len(y) / (len(classes) * cnt)
                 for c, cnt in zip(classes, counts)}
    elif isinstance(class_weight, dict):
        w_map = class_weight
    else:
        raise LightGBMError("class_weight must be 'balanced' or a dict")
    w = np.asarray([w_map.get(v, 1.0) for v in y], dtype=np.float64)
    if sample_weight is not None:
        w = w * np.asarray(sample_weight, dtype=np.float64)
    return w


class LGBMModel(_Base):
    """Base estimator (sklearn.py LGBMModel:128-649)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Any] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 silent: bool = True, importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params: Dict = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._best_score: Dict = {}
        self._n_features = 0
        self._objective = objective
        self._n_classes = 1

    # -- param plumbing ------------------------------------------------------
    def _default_objective(self) -> str:
        return "regression"

    def _engine_params(self) -> Dict:
        params = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbose": -1 if self.silent else 1,
        }
        if self.random_state is not None:
            params["seed"] = int(self.random_state)
        obj = self._objective
        params["objective"] = obj if isinstance(obj, str) and obj else \
            ("none" if callable(obj) else self._default_objective())
        params.update(self._other_params)
        return params

    # -- training ------------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None, early_stopping_rounds=None,
            verbose: bool = False, feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMModel":
        # re-read every fit so set_params(objective=...) takes effect
        self._objective = self.objective
        # the CONCRETE objective (sklearn objective_ fitted attribute):
        # the callable itself, or the resolved string incl. the default
        self._fit_objective = (
            self._objective if callable(self._objective)
            else (self._objective if isinstance(self._objective, str)
                  and self._objective else self._default_objective()))
        fobj = _ObjectiveFunctionWrapper(self._objective) if callable(self._objective) else None
        feval = _EvalFunctionWrapper(eval_metric) if callable(eval_metric) else None
        params = self._engine_params()
        if isinstance(eval_metric, str):
            params["metric"] = eval_metric
        elif isinstance(eval_metric, (list, tuple)):
            params["metric"] = ",".join(eval_metric)

        X_orig = X
        X = np.asarray(X, dtype=np.float64) if not hasattr(X, "values") else X
        self._n_features = np.asarray(X).shape[1]
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if (vx is X or vx is X_orig) and vy is y:
                    valid_sets.append(train_set)
                    continue
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                valid_sets.append(train_set.create_valid(
                    vx, label=self._prepare_y(vy), weight=vw, group=vg))

        self._evals_result = {}
        cbs = list(callbacks) if callbacks else []
        from .callback import record_evaluation
        cbs.append(record_evaluation(self._evals_result))
        self._Booster = train(params, train_set,
                              num_boost_round=self.n_estimators,
                              valid_sets=valid_sets or None,
                              valid_names=eval_names,
                              fobj=fobj, feval=feval,
                              early_stopping_rounds=early_stopping_rounds,
                              callbacks=cbs,
                              verbose_eval=verbose)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def _prepare_y(self, y) -> np.ndarray:
        return np.asarray(y, dtype=np.float64).reshape(-1)

    # -- prediction ----------------------------------------------------------
    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before predict")
        if num_iteration is None or num_iteration < 0:
            num_iteration = self._best_iteration if self._best_iteration > 0 else -1
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    # -- sklearn attributes --------------------------------------------------
    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found, call fit first")
        return self._Booster

    @property
    def objective_(self):
        """The concrete objective used while fitting (sklearn.py
        objective_ fitted attribute)."""
        if self._Booster is None:
            raise LightGBMError("No objective found, call fit first")
        return self._fit_objective

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        return self._best_score

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(importance_type=self.importance_type)


class LGBMRegressor(LGBMModel):
    def _default_objective(self) -> str:
        return "regression"

    def score(self, X, y, sample_weight=None):
        """R^2 (the sklearn RegressorMixin contract, which GridSearchCV
        relies on when no scoring is given)."""
        y = np.asarray(y, dtype=np.float64)
        pred = np.asarray(self.predict(X), dtype=np.float64)
        w = None if sample_weight is None else np.asarray(sample_weight)
        avg = np.average(y, weights=w)
        ss_res = np.average((y - pred) ** 2, weights=w)
        ss_tot = np.average((y - avg) ** 2, weights=w)
        if ss_tot > 0:
            return 1.0 - ss_res / ss_tot
        # constant target: sklearn's r2_score convention
        return 1.0 if ss_res == 0 else 0.0


class LGBMClassifier(LGBMModel):
    def _default_objective(self) -> str:
        return "multiclass" if self._n_classes > 2 else "binary"

    def score(self, X, y, sample_weight=None):
        """Accuracy (the sklearn ClassifierMixin contract)."""
        pred = np.asarray(self.predict(X))
        hits = (pred == np.asarray(y)).astype(np.float64)
        return float(np.average(hits, weights=sample_weight))

    def fit(self, X, y, sample_weight=None, **kwargs):
        y = np.asarray(y).reshape(-1)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        self._class_map = {c: i for i, c in enumerate(self._classes)}
        y_enc = np.asarray([self._class_map[v] for v in y], dtype=np.float64)
        # num_class must track THIS fit, not a previous one
        if self._n_classes > 2:
            self._other_params["num_class"] = self._n_classes
        else:
            self._other_params.pop("num_class", None)
        sample_weight = _compute_class_sample_weight(y, self.class_weight,
                                                    sample_weight)
        super().fit(X, y_enc, sample_weight=sample_weight, **kwargs)
        return self

    def _prepare_y(self, y) -> np.ndarray:
        y = np.asarray(y).reshape(-1)
        unseen = set(np.unique(y)) - set(self._class_map)
        if unseen:
            raise LightGBMError(
                "Eval set contains labels unseen during fit: %s" % sorted(unseen))
        return np.asarray([self._class_map[v] for v in y], dtype=np.float64)

    @property
    def classes_(self) -> np.ndarray:
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(X, raw_score=raw_score,
                                    num_iteration=num_iteration,
                                    pred_leaf=pred_leaf,
                                    pred_contrib=pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        return self._classes[np.argmax(result, axis=1)]

    def predict_proba(self, X, raw_score: bool = False, num_iteration: int = -1,
                      pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        result = super().predict(X, raw_score=raw_score,
                                 num_iteration=num_iteration,
                                 pred_leaf=pred_leaf,
                                 pred_contrib=pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes > 2:
            return result  # already [n, K] probabilities
        return np.vstack([1.0 - result, result]).T


class LGBMRanker(LGBMModel):
    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise LightGBMError("Should set group for ranking task")
        kwargs.setdefault("eval_group", None)
        if kwargs.get("eval_set") is not None and kwargs.get("eval_group") is None:
            raise LightGBMError("Eval_group cannot be None when eval_set is not None")
        super().fit(X, y, group=group, **kwargs)
        return self
