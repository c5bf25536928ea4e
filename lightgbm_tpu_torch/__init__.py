"""LightGBM on PyTorch and CUDA: the port of lightgbm_tpu to an NVIDIA card.

A second package beside `lightgbm_tpu` (the JAX reference).  It imports
torch and numpy, never jax and nothing of `lightgbm_tpu`.  Entry points
(train, cv, predict with device=True, and the scikit-learn estimators'
fit) run on the card unless the caller
asks for the CPU with device_type='cpu'; with no CUDA device and no such
request they raise.
"""
from .basic import Booster, Dataset
from .callback import (early_stopping, log_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, cv, predict, train
from .parallel.launch import init_distributed
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_tree)
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "Dataset", "Config", "CVBooster", "LightGBMError",
           "cv", "predict", "train", "init_distributed", "early_stopping", "log_evaluation",
           "record_evaluation", "reset_parameter",
           "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
           "plot_importance", "plot_metric", "plot_tree",
           "create_tree_digraph"]
