"""The train() entry point (counterpart of lightgbm_tpu/engine.py).

Role parity with the reference python-package/lightgbm/engine.py train:
callback environment, early stopping via exception, evaluation-result
bookkeeping.  This slice evaluates the training set only (pass it in
valid_sets); other validation sets, cv() and continued training are not
ported yet.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException, log_evaluation
from .utils.log import Log


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          callbacks: Optional[List] = None,
          verbose_eval=True) -> Booster:
    """Train a model on `train_set`.  Runs on the card unless params set
    device_type='cpu'; with no CUDA device and no such request it raises."""
    params = dict(params)
    num_boost_round = _rounds_from_params(params, num_boost_round)
    booster = Booster(params=params, train_set=train_set)
    is_valid_contain_train = False
    train_data_name = "training"
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    for i, valid in enumerate(valid_sets or []):
        if valid is not train_set:
            raise NotImplementedError(
                "validation sets other than the training set are not ported "
                "to the PyTorch package yet")
        is_valid_contain_train = True
        train_data_name = valid_names[i] if valid_names else "training"

    callbacks = list(callbacks) if callbacks else []
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


def _rounds_from_params(params: Dict, num_boost_round: int) -> int:
    """Honor num_iterations given as a param or an alias of it (the
    reference engine pops the aliases and they override the argument)."""
    from ._params import ALIASES
    hits = {key: params.pop(key) for key in list(params)
            if ALIASES.get(key, key) == "num_iterations"}
    if not hits:
        return num_boost_round
    value = hits.get("num_iterations", next(iter(hits.values())))
    return int(value)
