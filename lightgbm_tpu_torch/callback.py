"""Training callbacks.

Role parity with the reference python-package/lightgbm/callback.py:
print/log evaluation, record evaluation, parameter schedules
(reset_parameter), early stopping via EarlyStopException.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from .utils.log import Log


class CallbackEnv(NamedTuple):
    model: Any
    params: Dict
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: Optional[List]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score: List):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return "%s's %s: %g" % (value[0], value[1], value[2])
    if len(value) == 5:
        if show_stdv:
            return "%s's %s: %g + %g" % (value[0], value[1], value[2], value[4])
        return "%s's %s: %g" % (value[0], value[1], value[2])
    raise ValueError("Wrong metric value")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            Log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    return _callback


# reference-era alias
print_evaluation = log_evaluation


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for entry in env.evaluation_result_list or []:
            name, metric, value = entry[0], entry[1], entry[2]
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])
            eval_result[name][metric].append(value)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Before each iteration, set each named parameter from its schedule:
    a list of one value per round, or a function of the iteration.  cv()
    passes a CVBooster; every fold's booster gets the values."""
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError("Length of list %r has to be equal to "
                                     "'num_boost_round'" % key)
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a parameter schedule")
        if new_params:
            for bst in getattr(env.model, "boosters", [env.model]):
                bst.reset_parameter(new_params)
            env.params.update(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[List] = []
    cmp_op: List[Callable] = []
    enabled = [True]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            Log.warning("Early stopping is not available in dart mode or without valid sets")
            return
        if verbose:
            Log.info("Training until validation scores don't improve for %d rounds.",
                     stopping_rounds)
        for _ in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
        # entries are (name, metric, value, higher_better) from train(), or
        # ('cv_agg', 'ds metric', mean, higher_better, std) from cv()
        for entry in env.evaluation_result_list:
            higher_better = entry[3]
            if higher_better:
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i, entry in enumerate(env.evaluation_result_list):
            name, metric, score = entry[0], entry[1], entry[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if name == "training" or \
                    (name == "cv_agg" and metric.startswith("train ")):
                continue  # train metric does not trigger stopping
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    Log.info("Early stopping, best iteration is: [%d]\t%s",
                             best_iter[i] + 1,
                             "\t".join(_format_eval_result(x) for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    Log.info("Did not meet early stopping. Best iteration is: [%d]\t%s",
                             best_iter[i] + 1,
                             "\t".join(_format_eval_result(x) for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break
    _callback.order = 30
    return _callback
