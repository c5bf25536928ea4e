"""LightGBM on PyTorch and CUDA: the port of lightgbm_tpu to an NVIDIA card.

A second package beside `lightgbm_tpu` (the JAX reference).  It imports
torch and numpy, never jax and nothing of `lightgbm_tpu`.  Entry points
train on the card unless the caller asks for the CPU with
device_type='cpu'; with no CUDA device and no such request they raise.
"""
from .basic import Booster, Dataset
from .callback import early_stopping, log_evaluation, record_evaluation
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "Dataset", "Config", "LightGBMError", "train",
           "early_stopping", "log_evaluation", "record_evaluation"]
