"""The train() and cv() entry points (counterpart of lightgbm_tpu/engine.py).

Role parity with the reference python-package/lightgbm/engine.py (train
at :18-316, cv at :317+): callback environment, early stopping via
exception, evaluation-result bookkeeping and best_iteration, over the
training set and any validation sets, with continued training
(init_model), a custom objective (fobj) and metric (feval) and a
learning-rate schedule; k-fold cross-validation over a CVBooster; and
predict(), the one-shot serving entry.
"""
from __future__ import annotations

import collections
import os
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset, _slice_rows
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation, reset_parameter)
from .models.gbdt_model import GBDTModel
from .utils.log import LightGBMError, Log


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          learning_rates=None,
          keep_training_booster: bool = True,
          callbacks: Optional[List] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval=True) -> Booster:
    """Train a model on `train_set`.  Runs on the card unless params set
    device_type='cpu'; with no CUDA device and no such request it raises.
    Every validation set is scored after every iteration; `evals_result`,
    when given, receives {name: {metric: [value per iteration]}}.
    `init_model` (a file name, a Booster or a GBDTModel) continues its
    trees; `fobj(preds, train_set) -> (grad, hess)` replaces the objective
    (objective="none"); `feval(preds, dataset) -> (name, value,
    is_higher_better)` adds a metric on every evaluated set;
    `learning_rates` (a list or a function of the iteration) resets the
    learning rate before each iteration.  The returned Booster can always
    train on, so `keep_training_booster` changes nothing."""
    params = dict(params)
    if feature_name != "auto":
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
    num_boost_round, early_stopping_rounds = _rounds_from_params(
        params, num_boost_round, early_stopping_rounds)
    if fobj is not None:
        params["objective"] = "none"
    booster = Booster(params=params, train_set=train_set,
                      init_model=_resolve_init_model(init_model))
    is_valid_contain_train = False
    train_data_name = "training"
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    for i, valid in enumerate(valid_sets or []):
        # the reference's names: the training set stays "training" unless
        # named, another set is "valid_<i>"
        if valid is train_set:
            is_valid_contain_train = True
            train_data_name = valid_names[i] if valid_names else "training"
            continue
        booster.add_valid(valid, valid_names[i] if valid_names
                          else "valid_%d" % i)

    callbacks = list(callbacks) if callbacks else []
    if learning_rates is not None:
        callbacks.append(reset_parameter(learning_rate=learning_rates))
    # recorded before early stopping looks, so the stopping round counts
    if evals_result is not None:
        callbacks.append(record_evaluation(evals_result))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(early_stopping(early_stopping_rounds,
                                        verbose=bool(verbose_eval)))
    if verbose_eval is True:
        callbacks.append(log_evaluation(1))
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        callbacks.append(log_evaluation(verbose_eval))
    callbacks_before = [cb for cb in callbacks
                        if getattr(cb, "before_iteration", False)]
    callbacks_after = [cb for cb in callbacks
                       if not getattr(cb, "before_iteration", False)]

    evaluation_result_list: List = []
    for i in range(num_boost_round):
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=None)
        for cb in callbacks_before:
            cb(env)
        is_finished = booster.update(fobj=fobj)
        evaluation_result_list = []
        if is_valid_contain_train:
            evaluation_result_list = [(train_data_name, m, v, h) for
                                      (_, m, v, h) in booster.eval_train(feval)]
        evaluation_result_list.extend(booster.eval_valid(feval))
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=evaluation_result_list)
        try:
            for cb in callbacks_after:
                cb(env)
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            evaluation_result_list = e.best_score
            break
        if is_finished:
            Log.info("Finished training at iteration %d", i + 1)
            break

    booster.best_score = collections.defaultdict(dict)
    for name, metric, value, _ in evaluation_result_list:
        booster.best_score[name][metric] = value
    if booster._engine is not None:
        booster._engine.timer.report()
    return booster


def _rounds_from_params(params: Dict, num_boost_round: int,
                        early_stopping_rounds: Optional[int]):
    """Honor num_iterations / early_stopping_round given as params or
    aliases of them (the reference engine pops the aliases and they
    override the arguments; the canonical key wins over an alias)."""
    from ._params import ALIASES
    out = {"num_iterations": num_boost_round,
           "early_stopping_round": early_stopping_rounds}
    for canon in out:
        hits = {key: params.pop(key) for key in list(params)
                if ALIASES.get(key, key) == canon}
        if hits:
            out[canon] = int(hits.get(canon, next(iter(hits.values()))))
    return out["num_iterations"], out["early_stopping_round"]


class CVBooster:
    """The per-fold Boosters of cv() (reference engine.py CVBooster): a
    method call reaches every fold's booster and returns their results in
    fold order."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        if name.startswith("_"):  # no protocol probes (deepcopy, pickle)
            raise AttributeError(name)

        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


def _group_folds(group_sizes: np.ndarray, nfold: int):
    """Folds of whole ranking queries, balanced by rows (the role of
    sklearn's GroupKFold in the reference engine.py): queries, largest
    first, onto the lightest fold.  Yields (train rows, test rows, train
    query sizes, test query sizes)."""
    if len(group_sizes) < nfold:
        raise ValueError(
            "Cannot build %d group-aware folds from only %d queries; "
            "reduce nfold" % (nfold, len(group_sizes)))
    starts = np.concatenate([[0], np.cumsum(group_sizes)]).astype(np.int64)
    fold_rows = np.zeros(nfold, np.int64)
    fold_of_query = np.zeros(len(group_sizes), np.int32)
    for q in np.argsort(group_sizes)[::-1]:
        k = int(np.argmin(fold_rows))
        fold_of_query[q] = k
        fold_rows[k] += group_sizes[q]
    for k in range(nfold):
        test_q = np.where(fold_of_query == k)[0]
        train_q = np.where(fold_of_query != k)[0]
        test_idx = np.concatenate(
            [np.arange(starts[q], starts[q + 1]) for q in test_q])
        train_idx = np.concatenate(
            [np.arange(starts[q], starts[q + 1]) for q in train_q])
        yield (train_idx, test_idx,
               group_sizes[train_q], group_sizes[test_q])


def _resolve_init_model(init_model) -> Optional[GBDTModel]:
    """A file name, a Booster or a GBDTModel -> GBDTModel (train() and
    cv() accept the three, as the reference engine does)."""
    if init_model is None:
        return None
    if isinstance(init_model, str):
        return GBDTModel.load_model(init_model)
    if isinstance(init_model, Booster):
        return init_model._model
    return init_model


def _make_n_folds(train_set: Dataset, folds, nfold: int, params: Dict,
                  seed: int, fpreproc, stratified: bool, shuffle: bool,
                  eval_train_metric: bool, init_model=None) -> CVBooster:
    """The per-fold Boosters (reference engine.py _make_n_folds): custom
    folds, whole-query folds for a ranking set, stratified folds for a
    classification label, else shuffled ones; every draw from
    np.random.default_rng(seed), as the JAX package draws them."""
    train_set.construct()
    n = train_set.num_data()
    y = train_set.get_label()
    rng = np.random.default_rng(seed)
    group = train_set.get_group()

    fold_group = None
    if folds is not None:
        if not hasattr(folds, "__iter__"):
            raise AttributeError(
                "folds should be an iterable of (train_idx, test_idx)")
        folds = [(np.asarray(tr), np.asarray(te)) for tr, te in folds]
    elif group is not None:
        rich = list(_group_folds(np.asarray(group), nfold))
        folds = [(tr, te) for tr, te, _, _ in rich]
        fold_group = [(gtr, gte) for _, _, gtr, gte in rich]
    elif stratified and y is not None and \
            len(np.unique(y)) <= max(2, int(params.get("num_class", 2))):
        idx = np.arange(n)
        pieces = [[] for _ in range(nfold)]
        for cls in np.unique(y):
            cls_idx = idx[y == cls]
            if shuffle:
                rng.shuffle(cls_idx)
            for k, part in enumerate(np.array_split(cls_idx, nfold)):
                pieces[k].append(part)
        folds = [(np.setdiff1d(idx, np.concatenate(p)), np.concatenate(p))
                 for p in pieces]
    else:
        idx = np.arange(n)
        if shuffle:
            rng.shuffle(idx)
        folds = [(np.setdiff1d(np.arange(n), p), p)
                 for p in np.array_split(idx, nfold)]

    cvbooster = CVBooster()
    w = train_set.get_weight()
    for k, (train_idx, test_idx) in enumerate(folds):
        train_idx = np.sort(np.asarray(train_idx))
        test_idx = np.sort(np.asarray(test_idx))
        tr = train_set.subset(train_idx)
        if train_set.has_raw_matrix():
            te = tr.create_valid(_slice_rows(train_set.data, test_idx),
                                 label=None if y is None
                                 else np.asarray(y)[test_idx])
        else:
            # no raw matrix (a path or a stream): the held-out fold is a
            # binned subset too, with the same mappers and bundles
            te = train_set.subset(test_idx)
            te.reference = tr
        if fold_group is not None:
            tr.set_group(fold_group[k][0])
            te.set_group(fold_group[k][1])
        if w is not None:  # subset() already sliced the train fold's
            te.set_weight(np.asarray(w)[test_idx])
        fold_params = dict(params)
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, fold_params)
        # every fold replays the loaded trees onto its own scores (Booster
        # deep-copies the model, so the folds share no tree)
        bst = Booster(params=fold_params, train_set=tr,
                      init_model=init_model)
        if eval_train_metric:
            bst.add_valid(tr, "train")
        bst.add_valid(te, "valid")
        cvbooster.append(bst)
    return cvbooster


def _agg_cv_result(raw_results):
    """[(dataset, metric, mean, is_higher_better, std)] across folds
    (reference engine.py _agg_cv_result), keyed by (dataset, metric) so
    that eval_train_metric keeps the train and valid series apart."""
    cvmap = collections.OrderedDict()
    metric_hib = {}
    for one_result in raw_results:
        for ds_name, metric, value, hib in one_result:
            metric_hib[(ds_name, metric)] = hib
            cvmap.setdefault((ds_name, metric), []).append(value)
    return [(ds, m, float(np.mean(v)), metric_hib[(ds, m)], float(np.std(v)))
            for (ds, m), v in cvmap.items()]


def cv(params: Dict, train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, early_stopping_rounds=None, fpreproc=None,
       verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """K-fold cross-validation (reference engine.py cv).  Every fold
    trains on the device train() would use.  Returns {"<metric>-mean":
    [...], "<metric>-stdv": [...]} per iteration (the stdv series only
    with show_stdv; "train <metric>-..." with eval_train_metric), and
    with return_cvbooster the CVBooster under "cvbooster".  Early
    stopping reads the first valid metric's mean."""
    params = dict(params)
    num_boost_round, early_stopping_rounds = _rounds_from_params(
        params, num_boost_round, early_stopping_rounds)
    if metrics is not None:
        params["metric"] = metrics
    if fobj is not None:
        params["objective"] = "none"

    cvfolds = _make_n_folds(train_set, folds, nfold, params, seed, fpreproc,
                            stratified, shuffle, eval_train_metric,
                            init_model=_resolve_init_model(init_model))
    results = collections.defaultdict(list)
    best_iter, best_metric_val = -1, None

    callbacks = list(callbacks) if callbacks else []
    if verbose_eval is True:
        callbacks.append(log_evaluation(1, show_stdv))
    elif isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool) \
            and verbose_eval > 0:
        callbacks.append(log_evaluation(verbose_eval, show_stdv))
    callbacks_before = [c for c in callbacks
                        if getattr(c, "before_iteration", False)]
    callbacks_after = [c for c in callbacks
                       if not getattr(c, "before_iteration", False)]

    for i in range(num_boost_round):
        env = CallbackEnv(model=cvfolds, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=None)
        for cb in callbacks_before:
            cb(env)
        cvfolds.update(fobj=fobj)
        # with eval_train_metric each fold carries its training fold as a
        # validation set named "train", so eval_valid covers both
        agg = _agg_cv_result(cvfolds.eval_valid(feval))
        for ds_name, metric, mean, hib, std in agg:
            key = metric if ds_name == "valid" else "%s %s" % (ds_name,
                                                               metric)
            results[key + "-mean"].append(mean)
            if show_stdv:
                results[key + "-stdv"].append(std)
        valid_agg = [a for a in agg if a[0] == "valid"]
        if valid_agg:
            _, _, mean, hib, _ = valid_agg[0]
            if best_metric_val is None or (mean > best_metric_val if hib
                                           else mean < best_metric_val):
                best_metric_val, best_iter = mean, i
        env = CallbackEnv(model=cvfolds, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=[
                              ("cv_agg", "%s %s" % (ds, m), mean, hib, std)
                              for ds, m, mean, hib, std in agg])
        try:
            for cb in callbacks_after:
                cb(env)
        except EarlyStopException as e:
            best_iter = e.best_iteration
            for key in results:
                results[key] = results[key][: best_iter + 1]
            break
        if early_stopping_rounds and valid_agg and \
                best_iter <= i - early_stopping_rounds:
            for key in results:
                results[key] = results[key][: best_iter + 1]
            break

    cvfolds.best_iteration = best_iter + 1
    out: Dict[str, Any] = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvfolds
    return out


def predict(model, data, device: bool = True, **kwargs):
    """One-shot serving entry (the JAX package's engine.predict): run
    `data` through the tree-parallel device predictor without managing a
    Booster.  `model` is a Booster, a model file path or a model string;
    device=False takes the exact f64 host traversal instead.  A loaded
    model predicts on the card unless `params={'device_type': 'cpu'}`
    is passed; other kwargs flow to Booster.predict (num_iteration,
    start_iteration, raw_score, pred_early_stop, ...)."""
    params = kwargs.pop("params", None)
    if isinstance(model, Booster):
        bst = model
    elif isinstance(model, str) and "\n" in model:
        bst = Booster(params=params, model_str=model)
    elif isinstance(model, (str, bytes, os.PathLike)):
        bst = Booster(params=params, model_file=os.fsdecode(model))
    else:
        raise LightGBMError("predict() needs a Booster, a model file "
                            "path, or a model string")
    return bst.predict(data, device=device, **kwargs)
