"""User-facing Dataset and Booster (counterpart of lightgbm_tpu/basic.py).

Role parity with the reference Python binding python-package/lightgbm/basic.py.
This slice keeps the surface the training paths use: a Dataset over a
dense matrix (a validation set binned with its reference's mappers), and
a Booster that trains (update), evaluates on the training set and on
validation sets, predicts through the host f64 model, and reads and
writes the model text that both packages share.  Training runs on the
device that config.resolve_device picks: the card unless
device_type='cpu'.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .boosting.gbdt import GBDT
from .config import Config, resolve_device
from .io.dataset import BinnedDataset
from .metric import create_metrics
from .models.gbdt_model import GBDTModel
from .objective import create_objective, create_objective_from_model_string
from .utils.log import LightGBMError, Log


def _to_2d_float(data) -> np.ndarray:
    if data.__class__.__module__.startswith("scipy.sparse"):
        data = data.toarray()
    elif hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values      # pandas DataFrame / Series
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr


class Dataset:
    """Raw data + lazily-constructed binned form (basic.py Dataset semantics)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict] = None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._binned: Optional[BinnedDataset] = None

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._binned is not None:
            return self
        if config is None:
            config = Config(self.params)
        fn = None if self.feature_name == "auto" else list(self.feature_name)
        cats = ()
        if self.categorical_feature != "auto" and self.categorical_feature:
            cats = [int(c) for c in self.categorical_feature]
        # a validation set reuses its reference's mappers and bundling
        # (Dataset::CreateValid)
        ref = None
        if self.reference is not None:
            ref = self.reference.construct(config).binned
        self._binned = BinnedDataset.from_matrix(
            _to_2d_float(self.data), config, feature_names=fn,
            categorical_feature=cats,
            bin_mappers=ref.bin_mappers if ref is not None else None,
            reference_bundle=ref.bundle_info if ref is not None else None)
        md = self._binned.metadata
        if self.label is not None:
            md.set_label(np.asarray(self.label))
        md.set_weight(self.weight)
        return self

    @property
    def binned(self) -> BinnedDataset:
        if self._binned is None:
            self.construct()
        return self._binned



class Booster:
    """Training/prediction handle (basic.py Booster; c_api.cpp Booster)."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._engine: Optional[GBDT] = None
        self._valid_data: List = []
        self.config = Config(self.params)
        if train_set is not None:
            self.config.warn_unimplemented()
            device = resolve_device(self.config)
            train_set.construct(self.config)
            obj = self.config.objective
            self._objective = create_objective(obj, self.config) \
                if isinstance(obj, str) else None
            binned = train_set.binned
            if binned.metadata.label is None:
                Log.fatal("Label should not be None for training")
            metrics = create_metrics(self.config.metric, self.config)
            for m in metrics:
                m.init(binned.metadata.label, binned.metadata.weight,
                       binned.metadata.query_boundaries)
            self._engine = GBDT(self.config, binned, self._objective, metrics,
                                device)
            self._model = self._engine.model
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            if model_str is None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._model = GBDTModel.load_model_from_string(model_str)
            self._objective = create_objective_from_model_string(
                self._model.objective_str, self.config)
        else:
            raise LightGBMError("Booster needs train_set or model file")

    @property
    def device(self):
        """The training device (None for a loaded model)."""
        return self._engine.device if self._engine is not None else None

    # -- training ------------------------------------------------------------
    def update(self, train_set=None, fobj=None) -> bool:
        if self._engine is None:
            raise LightGBMError("Cannot update a loaded Booster")
        if fobj is not None:
            raise NotImplementedError(
                "custom objectives are not ported to the PyTorch package yet")
        return self._engine.train_one_iter()

    def current_iteration(self) -> int:
        return self._model.current_iteration

    def host_syncs_per_tree(self) -> List[int]:
        """Blocking device-to-host reads each trained tree paid."""
        return list(self._engine.host_syncs) if self._engine else []

    def split_rounds_per_tree(self) -> Optional[float]:
        """Mean sequential grower rounds per trained tree: splits per tree
        on the one-leaf loop, fewer once tpu_frontier_batch > 1 commits
        several splits per round (None before the first tree)."""
        return self._engine.split_rounds_per_tree() if self._engine else None

    @property
    def quant_report(self) -> Optional[Dict]:
        """The quantized mode's grid and bytes (dtype, qmax, grad/hess
        bytes per row and their reduction against f32), or None when
        training in f32."""
        return self._engine.quant_report if self._engine else None

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score `data` after every tree from now on, with the existing
        trees replayed onto it.  It is binned with the training set's
        mappers: a set made without reference=train_set is (re)binned so."""
        if self._engine is None:
            raise LightGBMError("Cannot add validation data to a loaded "
                                "Booster")
        if data is not self.train_set and data.reference is not self.train_set:
            Log.warning("Validation set was not created with "
                        "reference=train_set; binning it with the training "
                        "mappers")
            data.reference = self.train_set
            data._binned = None
        data.construct(self.config)
        metrics = create_metrics(self.config.metric, self.config)
        self._engine.add_valid(name, data.binned, metrics)
        self._valid_data.append((name, data))
        return self

    # -- evaluation ----------------------------------------------------------
    def eval_train(self, feval=None) -> List:
        if feval is not None:
            raise NotImplementedError(
                "custom metrics are not ported to the PyTorch package yet")
        return self._engine.eval_train()

    def eval_valid(self, feval=None) -> List:
        """(name, metric, value, is_higher_better) for every metric of
        every validation set, in the order they were added."""
        if feval is not None:
            raise NotImplementedError(
                "custom metrics are not ported to the PyTorch package yet")
        return self._engine.eval_valid()

    # -- prediction ----------------------------------------------------------
    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                start_iteration: int = 0) -> np.ndarray:
        """Exact f64 host traversal of the model (models/gbdt_model.py);
        the device predictor is not ported yet."""
        X = _to_2d_float(data)
        raw = self._model.predict_raw(X, start_iteration=start_iteration,
                                      num_iteration=num_iteration)
        if raw.shape[1] == 1:
            raw = raw[:, 0]
        if raw_score or self._objective is None:
            return raw
        return self._objective.convert_output(raw)

    # -- model IO ------------------------------------------------------------
    def save_model(self, filename: str, num_iteration: int = -1,
                   start_iteration: int = 0) -> "Booster":
        self._model.save_model(filename, start_iteration, num_iteration,
                               parameters=self.config.to_string())
        return self

    def model_to_string(self, num_iteration: int = -1,
                        start_iteration: int = 0) -> str:
        return self._model.save_model_to_string(start_iteration,
                                                num_iteration)
