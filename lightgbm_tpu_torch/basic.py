"""User-facing Dataset and Booster (counterpart of lightgbm_tpu/basic.py).

Role parity with the reference Python binding python-package/lightgbm/basic.py.
This slice keeps the surface the training paths use: a Dataset over a
dense matrix (categorical features by column index; query groups for
ranking; a validation set binned with its reference's mappers, with its
own labels, weights and groups), and a Booster that trains (update),
evaluates on the training set and on validation sets, predicts through
the exact f64 host model or, with device=True, the tree-parallel device
predictor (models/device_predictor.py), and reads and writes the model
text that both packages share.  Training and device prediction run on the
device that config.resolve_device picks: the card unless
device_type='cpu'.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .boosting.gbdt import GBDT
from .config import Config, resolve_device
from .io.dataset import BinnedDataset
from .metric import create_metrics
from .models import device_predictor as dpr
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
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict] = None):
        """categorical_feature: "auto" (none) or a list of column indices;
        names and pandas categories are not ported.  group: the number of
        consecutive rows of each query (ranking).  init_score: a per-row
        raw score that training (or validation) starts from, every class
        plane's when the model has several."""
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
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
        md.set_init_score(self.init_score)
        md.set_query(self.group)
        return self

    def get_label(self) -> np.ndarray:
        return self.binned.metadata.label

    def get_weight(self):
        return self.binned.metadata.weight

    def get_group(self):
        """Rows per query, or None without query groups."""
        qb = self.binned.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def set_group(self, group) -> None:
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)

    def set_init_score(self, init_score) -> None:
        self.init_score = init_score
        if self._binned is not None:
            self._binned.metadata.set_init_score(init_score)

    def get_init_score(self):
        return self.binned.metadata.init_score

    def get_field(self, field_name: str):
        """Generic field accessor (reference Dataset.get_field)."""
        getters = {"label": self.get_label, "weight": self.get_weight,
                   "init_score": self.get_init_score,
                   "group": self.get_group, "query": self.get_group}
        if field_name not in getters:
            raise LightGBMError("Unknown field name: %s" % field_name)
        return getters[field_name]()

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
        self._dev_predictor = None
        self._dev_pred_key = None
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

    def predict_device(self) -> torch.device:
        """Where predict(device=True) runs: the training device, or for a
        loaded model the device its params ask for (the card unless
        device_type='cpu'; raises without a CUDA device)."""
        if self._engine is not None:
            return self._engine.device
        return resolve_device(self.config)

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
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False, pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                device: bool = False, start_iteration: int = 0,
                out_dtype=None, leaf_quant: Optional[str] = None
                ) -> np.ndarray:
        """The exact f64 host traversal of the model (models/gbdt_model.py)
        by default; device=True runs the tree-parallel device predictor
        (models/device_predictor.py: f32 thresholds, categorical bitsets,
        power-of-two row buckets captured as CUDA graphs, micro-batched
        transfers) on `predict_device()`.

        Device path only: `out_dtype=np.float32` returns float32, exactly
        the float64 answer `.astype(float32)` (output transforms run in
        f64 on the exact upcast); `leaf_quant="int8"` takes the int8 leaf
        table, the default once the staged
        `device_predictor.LEAF_QUANT_VALIDATED` is set (leaf_quant="none"
        opts out)."""
        X = _to_2d_float(data)
        if pred_leaf:
            return self._model.predict_leaf_index(X, num_iteration)
        if pred_contrib:
            return self._model.predict_contrib(X, num_iteration)
        # the host and device paths truncate sums alike
        early = self._model.early_stop_mode(pred_early_stop)
        if device:
            lq = leaf_quant
            if lq is None and dpr.LEAF_QUANT_VALIDATED:
                lq = "int8"
            if lq in ("none", "float32"):
                lq = None
            end = self._model.num_prediction_iterations(start_iteration,
                                                        num_iteration)
            key = (start_iteration, end, len(self._model.trees), lq)
            if self._dev_pred_key != key:
                self._dev_predictor = dpr.DevicePredictor(
                    self._model, start_iteration, num_iteration,
                    leaf_quant=lq, device=self.predict_device())
                self._dev_pred_key = key
            raw = self._dev_predictor.predict_raw(
                X, early_stop=early, early_stop_freq=pred_early_stop_freq,
                early_stop_margin=pred_early_stop_margin,
                out_dtype=np.float32 if np.dtype(out_dtype or np.float64)
                == np.float32 else np.float64)
        else:
            raw = self._model.predict_raw(
                X, start_iteration=start_iteration,
                num_iteration=num_iteration, early_stop=early,
                early_stop_freq=pred_early_stop_freq,
                early_stop_margin=pred_early_stop_margin)
        return self._finish_predict(raw, raw_score, num_iteration,
                                    start_iteration)

    def _finish_predict(self, raw: np.ndarray, raw_score: bool,
                        num_iteration: int = -1,
                        start_iteration: int = 0) -> np.ndarray:
        # f32 raw scores (the out_dtype path): the output transform runs
        # in f64 on the exact upcast, then casts down, so the f32 surface
        # is the f64 surface .astype(float32) bit for bit
        f32 = raw.dtype == np.float32
        if f32:
            raw = raw.astype(np.float64)
        if raw.shape[1] == 1:
            raw = raw[:, 0]
        if raw_score:
            out = raw
        elif self._model.average_output:
            # averaged pre-converted outputs; no ConvertOutput on top
            # (gbdt_prediction.cpp Predict, average_output_ branch)
            out = raw / self._model.num_prediction_iterations(
                start_iteration, num_iteration)
        elif self._objective is None:
            out = raw
        else:
            out = self._objective.convert_output(raw)
        return out.astype(np.float32) if f32 else out

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
