"""The train() entry point (counterpart of lightgbm_tpu/engine.py).

Role parity with the reference python-package/lightgbm/engine.py train:
callback environment, early stopping via exception, evaluation-result
bookkeeping and best_iteration, over the training set and any validation
sets.  cv() and continued training are not ported yet.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

from .basic import Booster, Dataset
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation)
from .utils.log import Log


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          callbacks: Optional[List] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval=True) -> Booster:
    """Train a model on `train_set`.  Runs on the card unless params set
    device_type='cpu'; with no CUDA device and no such request it raises.
    Every validation set is scored after every iteration; `evals_result`,
    when given, receives {name: {metric: [value per iteration]}}."""
    params = dict(params)
    num_boost_round, early_stopping_rounds = _rounds_from_params(
        params, num_boost_round, early_stopping_rounds)
    booster = Booster(params=params, train_set=train_set)
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
        is_finished = booster.update()
        evaluation_result_list = []
        if is_valid_contain_train:
            evaluation_result_list = [(train_data_name, m, v, h) for
                                      (_, m, v, h) in booster.eval_train()]
        evaluation_result_list.extend(booster.eval_valid())
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
