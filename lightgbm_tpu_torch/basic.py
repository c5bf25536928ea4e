"""User-facing Dataset and Booster (counterpart of lightgbm_tpu/basic.py).

Role parity with the reference Python binding python-package/lightgbm/basic.py.
A Dataset over a dense or scipy sparse matrix or a pandas DataFrame
(categorical features by index, name or category dtype; query groups
for ranking; validation sets and subsets binned with their reference's
mappers; the field accessors and setters), over a path (a binary dataset
cache written by `save_binary`, by either package, or a CSV / TSV /
LibSVM text file), or over a stream (a StreamingDatasetBuilder, fed by
`push_rows` / `push_rows_csr`, or an iterator of chunks), and a Booster
that trains
(update, with a custom objective too), continues a loaded model, rolls
back an iteration, resets parameters, refits its leaves, evaluates (with
custom metrics) on the training set, on validation sets and on any
Dataset, predicts through the exact f64 host model or, with
device=True, the tree-parallel device predictor
(models/device_predictor.py), and reads, writes, pickles, copies and
dumps the model text that both packages share.  Training and device
prediction run on the device that config.resolve_device picks: the card
unless device_type='cpu'.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .boosting.gbdt import GBDT
from .boosting.variants import create_boosting
from .config import Config, resolve_device
from .io.dataset import BinnedDataset
from .io.stream import StreamingDatasetBuilder
from .metric import create_metrics
from .models import device_predictor as dpr
from .models.gbdt_model import GBDTModel
from .objective import create_objective, create_objective_from_model_string
from .runtime import resilience, syncs, telemetry
from .utils.log import LightGBMError, Log


def _is_dataframe(data) -> bool:
    return hasattr(data, "dtypes") and hasattr(data, "columns")


def _data_from_pandas(data, feature_name, categorical_feature,
                      pandas_categorical):
    """DataFrame -> (X f64, names, categorical indices, pandas_categorical)
    (the JAX package's basic.py:30-81; reference basic.py
    _data_from_pandas): category-dtype columns become their category
    codes (-1 / unseen -> NaN); the per-column category lists are taken
    from the training frame and applied by position to validation and
    prediction frames, so the codes stay consistent.  pandas is never
    imported: only a DataFrame reaches here."""
    cat_cols = [c for c in data.columns if str(data[c].dtype) == "category"]
    if pandas_categorical is None:          # the training frame sets them
        pandas_categorical = [list(data[c].cat.categories) for c in cat_cols]
    elif len(cat_cols) != len(pandas_categorical):
        raise LightGBMError(
            "train and valid dataset categorical_feature do not match")
    if cat_cols:
        data = data.copy()
        for c, cats in zip(cat_cols, pandas_categorical):
            col = data[c]
            if list(col.cat.categories) != list(cats):
                col = col.cat.set_categories(cats)
            codes = np.asarray(col.cat.codes, dtype=np.float64)
            data[c] = np.where(codes < 0, np.nan, codes)
    if feature_name in ("auto", None):
        names = [str(c) for c in data.columns]
    else:
        names = list(feature_name)
    cols = [str(c) for c in data.columns]

    def _pos(name):
        # category columns are found by their position in the frame, so a
        # renaming feature_name list still works; a categorical_feature
        # name must be one of the names
        if name in names:
            return names.index(name)
        if name in cols:
            return cols.index(name)
        raise LightGBMError("categorical column %r not found among the "
                            "feature names %s" % (name, names))

    if categorical_feature in ("auto", None):
        cat_idx = [_pos(str(c)) for c in cat_cols]
    else:
        cat_idx = [_pos(cf) if isinstance(cf, str) else int(cf)
                   for cf in categorical_feature]
        for c in cat_cols:
            if _pos(str(c)) not in cat_idx:
                cat_idx.append(_pos(str(c)))
    X = data.to_numpy(dtype=np.float64)
    return X, names, sorted(set(cat_idx)), pandas_categorical


def _load_pandas_categorical(model_text: str):
    """The trailing pandas_categorical line of a model text, or None
    (reference basic.py _load_pandas_categorical)."""
    idx = model_text.rfind("\npandas_categorical:")
    if idx < 0:
        return None
    line = model_text[idx + len("\npandas_categorical:"):].split("\n")[0]
    try:
        return json.loads(line)
    except ValueError:
        return None


def _is_scipy_sparse(data) -> bool:
    return data.__class__.__module__.startswith("scipy.sparse")


def _slice_rows(data, idx: np.ndarray) -> np.ndarray:
    """Rows `idx` of any supported input matrix, as f64.  A scipy sparse
    matrix is sliced while sparse and only the slice densified (checked
    before the `.values` duck test: dok_matrix subclasses dict)."""
    if _is_scipy_sparse(data):
        return np.asarray(data.tocsr()[idx].toarray(), dtype=np.float64)
    return _to_2d_float(data)[idx]


def _is_stream(data) -> bool:
    """A StreamingDatasetBuilder or an iterator of chunks."""
    return isinstance(data, StreamingDatasetBuilder) or (
        hasattr(data, "__next__") and not isinstance(data, np.ndarray))


def _to_2d_float(data, pandas_categorical=None) -> np.ndarray:
    if _is_dataframe(data):
        data, _, _, _ = _data_from_pandas(data, "auto", "auto",
                                          pandas_categorical)
    elif _is_scipy_sparse(data):
        data = data.toarray()
    elif hasattr(data, "values"):  # pandas Series
        data = data.values
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
        """data: a dense matrix, a scipy sparse matrix (densified when
        binned), a pandas DataFrame (category columns become categorical
        features), a path (a binary dataset cache, or a CSV / TSV /
        LibSVM file whose label column is the first; `.weight`,
        `.query` and `.init` sidecar files beside it are read), a
        StreamingDatasetBuilder (rows pushed with push_rows /
        push_rows_csr) or an iterator of chunks (X, (X, y) or (X, y, w)).
        categorical_feature: "auto", column indices, or names.  group:
        the number of consecutive rows of each query (ranking).
        init_score: a per-row raw score that training (or validation)
        starts from, every class plane's when the model has several."""
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
        self.pandas_categorical = None  # per-column category lists

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._binned is not None:
            return self
        if config is None:
            config = Config(self.params)
        if self.data is None:
            raise LightGBMError("Dataset has no data to construct")
        # a validation set reuses its reference's mappers and bundling
        # (Dataset::CreateValid)
        ref = None
        if self.reference is not None:
            ref = self.reference.construct(config).binned
        if _is_stream(self.data):
            return self._construct_stream(config, ref)
        if isinstance(self.data, (str, os.PathLike)):
            return self._construct_path(config, ref)
        if _is_dataframe(self.data):
            ref_pc = self.reference.pandas_categorical \
                if self.reference is not None else None
            X, fn, cats, self.pandas_categorical = _data_from_pandas(
                self.data, self.feature_name, self.categorical_feature,
                ref_pc)
        else:
            X = _to_2d_float(self.data)
            fn, cats = self._names_and_categories()
        self._bin(X, config, ref, fn, cats)
        self._set_metadata()
        return self

    def _names_and_categories(self):
        """feature_name and categorical_feature (indices) as from_matrix
        takes them; a DataFrame's come from its columns instead."""
        fn = None if self.feature_name == "auto" else list(self.feature_name)
        cats = [] if self.categorical_feature == "auto" \
            else [int(c) for c in self.categorical_feature or ()]
        return fn, cats

    def _bin(self, X, config: Config, ref, fn, cats) -> None:
        """Bin a raw matrix, with the reference's mappers and bundles for
        a validation set (Dataset::CreateValid)."""
        self._binned = BinnedDataset.from_matrix(
            X, config, feature_names=fn, categorical_feature=cats,
            bin_mappers=ref.bin_mappers if ref is not None else None,
            reference_bundle=ref.bundle_info if ref is not None else None)

    def _set_metadata(self) -> None:
        """The fields given to this Dataset, onto the binned set's
        metadata (a field left None keeps what the binned set holds: a
        cache's or a stream's own)."""
        md = self._binned.metadata
        if self.label is not None:
            md.set_label(np.asarray(self.label))
        if self.weight is not None:
            md.set_weight(self.weight)
        if self.init_score is not None:
            md.set_init_score(self.init_score)
        if self.group is not None:
            md.set_query(self.group)

    def _construct_path(self, config: Config, ref) -> "Dataset":
        """A binary dataset cache (save_binary, either package's), or a
        text file parsed by io/parser.py and binned (with the reference's
        mappers and bundles for a validation set), its sidecars read
        where this Dataset has no such field (the JAX package's
        basic.py:173-206; metadata.cpp LoadWeights / LoadQueryBoundaries /
        LoadInitialScore)."""
        from .io.parser import load_sidecar, parse_file
        path = os.fspath(self.data)
        if BinnedDataset.is_binary_file(path):
            if ref is not None:
                Log.fatal("A binary dataset cache carries its own bin "
                          "mappers and cannot be re-aligned to a reference "
                          "dataset; rebuild the cache from the validation "
                          "data instead")
            self._binned = BinnedDataset.load_binary(path)
        else:
            X, label = parse_file(path)
            self._bin(X, config, ref, *self._names_and_categories())
            if self.label is None:
                self.label = label
            for field, ext in (("weight", ".weight"), ("group", ".query"),
                               ("init_score", ".init")):
                if getattr(self, field) is None:
                    side = load_sidecar(path + ext)
                    if side is not None:
                        setattr(self, field, side.astype(np.int64)
                                if field == "group" else side)
        self._set_metadata()
        return self

    def _construct_stream(self, config: Config, ref) -> "Dataset":
        """Construct from a StreamingDatasetBuilder or an iterator of
        chunks (X, (X, y) or (X, y, w); io/stream.py): finalize bins the
        pushed rows as from_matrix would (with the reference's mappers
        and bundles for a validation set), and the stream's labels and
        weights fill the fields this Dataset was not given (the JAX
        package's basic.py:228-258)."""
        builder = self.data
        if not isinstance(builder, StreamingDatasetBuilder):
            it = builder
            builder = StreamingDatasetBuilder(params=self.params)
            for chunk in it:
                builder.push(chunk)
            self.data = builder
        fn, cats = self._names_and_categories()
        self._binned = builder.finalize(
            config, bin_mappers=ref.bin_mappers if ref is not None else None,
            reference_bundle=ref.bundle_info if ref is not None else None,
            feature_names=fn, categorical_feature=cats)
        if self.label is None:
            self.label = builder.labels()
        if self.weight is None:
            self.weight = builder.weights()
        self._set_metadata()
        return self

    def push_rows(self, data, start_row: int = -1) -> "Dataset":
        """Push dense rows into this Dataset's stream (LGBM_DatasetPushRows):
        its data must be a StreamingDatasetBuilder, and it must not be
        constructed yet.  start_row >= 0 places the rows (a builder made
        with a reference and num_total_rows)."""
        self._stream_builder().push_dense(np.asarray(data),
                                          start_row=start_row)
        return self

    def push_rows_csr(self, indptr, indices, values, num_col: int,
                      start_row: int = -1) -> "Dataset":
        """Push CSR rows into this Dataset's stream
        (LGBM_DatasetPushRowsByCSR)."""
        self._stream_builder().push_csr(indptr, indices, values, num_col,
                                        start_row=start_row)
        return self

    def _stream_builder(self) -> StreamingDatasetBuilder:
        if self._binned is not None:
            raise LightGBMError(
                "Cannot push rows after the dataset is constructed")
        if not isinstance(self.data, StreamingDatasetBuilder):
            raise LightGBMError(
                "push_rows needs a streaming Dataset: create it from a "
                "StreamingDatasetBuilder")
        return self.data

    def has_raw_matrix(self) -> bool:
        """Whether the rows are held as a matrix (dense, sparse or a
        DataFrame), not only binned (a path, a stream or a binned
        subset)."""
        return not (self.data is None or _is_stream(self.data)
                    or isinstance(self.data, (str, os.PathLike)))

    @classmethod
    def _from_binned(cls, binned: BinnedDataset,
                     params: Optional[Dict] = None) -> "Dataset":
        """A Dataset over an already-binned set (a binned subset)."""
        ds = cls(None, params=params)
        ds._binned = binned
        return ds

    def save_binary(self, filename) -> "Dataset":
        """Write the constructed dataset to a binary cache file that
        Dataset(filename) loads directly, in either package (reference
        save_binary)."""
        self.binned.save_binary(os.fspath(filename))
        return self

    @property
    def binned(self) -> BinnedDataset:
        if self._binned is None:
            self.construct()
        return self._binned

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this set's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows `used_indices` (labels and weights with them), binned
        with this set's mappers; a sparse matrix is sliced while sparse.
        A Dataset with no raw matrix (path-backed, streamed, or itself a
        binned subset) gathers its binned rows instead (reference
        GetSubset; BinnedDataset.subset), in ascending order."""
        idx = np.asarray(used_indices)
        if not self.has_raw_matrix():
            return Dataset._from_binned(
                self.construct().binned.subset(np.sort(np.unique(idx))),
                params=params or self.params)
        X = _slice_rows(self.data, idx)
        y = None if self.label is None else np.asarray(self.label)[idx]
        w = None if self.weight is None else np.asarray(self.weight)[idx]
        return Dataset(X, label=y, weight=w, reference=self,
                       params=params or self.params)

    # -- accessors (binding surface) -----------------------------------------
    def num_data(self) -> int:
        return self.binned.num_data

    def num_feature(self) -> int:
        return self.binned.num_features

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """This dataset, its reference, its reference's reference, ...,
        up to ref_limit or a loop (basic.py get_ref_chain)."""
        head, chain = self, set()
        while len(chain) < ref_limit and isinstance(head, Dataset):
            chain.add(head)
            if head.reference is None or head.reference in chain:
                break
            head = head.reference
        return chain

    def get_label(self) -> np.ndarray:
        return self.binned.metadata.label

    def get_weight(self):
        return self.binned.metadata.weight

    def get_group(self):
        """Rows per query, or None without query groups."""
        qb = self.binned.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self):
        return self.binned.metadata.init_score

    def set_label(self, label) -> None:
        self.label = label
        if self._binned is not None:
            self._binned.metadata.set_label(np.asarray(label))

    def set_weight(self, weight) -> None:
        self.weight = weight
        if self._binned is not None:
            self._binned.metadata.set_weight(weight)

    def set_group(self, group) -> None:
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_query(group)

    def set_init_score(self, init_score) -> None:
        self.init_score = init_score
        if self._binned is not None:
            self._binned.metadata.set_init_score(init_score)

    _FIELDS = {"label": ("get_label", "set_label"),
               "weight": ("get_weight", "set_weight"),
               "init_score": ("get_init_score", "set_init_score"),
               "group": ("get_group", "set_group"),
               "query": ("get_group", "set_group")}

    def get_field(self, field_name: str):
        """Generic field accessor (reference Dataset.get_field)."""
        if field_name not in self._FIELDS:
            raise LightGBMError("Unknown field name: %s" % field_name)
        return getattr(self, self._FIELDS[field_name][0])()

    def set_field(self, field_name: str, data) -> "Dataset":
        if field_name not in self._FIELDS:
            raise LightGBMError("Unknown field name: %s" % field_name)
        getattr(self, self._FIELDS[field_name][1])(data)
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if self._binned is not None and \
                categorical_feature != self.categorical_feature:
            raise LightGBMError(
                "Cannot change categorical_feature after the dataset is "
                "constructed; create a new Dataset")
        self.categorical_feature = categorical_feature
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        self.feature_name = feature_name
        if self._binned is not None and feature_name != "auto":
            if len(feature_name) != self._binned.num_features:
                raise LightGBMError(
                    "Length of feature names does not equal the number "
                    "of features")
            self._binned.feature_names = list(feature_name)
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if self._binned is not None and self.reference is not reference:
            raise LightGBMError(
                "Cannot set reference after the dataset is constructed; "
                "create a new Dataset")
        self.reference = reference
        return self


class Booster:
    """Training/prediction handle (basic.py Booster; c_api.cpp Booster)."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 init_model: Optional[GBDTModel] = None):
        """init_model (a GBDTModel) continues training from its trees; it
        is deep-copied, so the caller's model is never changed."""
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._engine: Optional[GBDT] = None
        self.train_set: Optional[Dataset] = None
        self._valid_data: List = []
        self._dev_predictor = None
        self._dev_pred_key = None
        #: bumped by every change of the model that keeps its tree count
        #: (rollback, shuffle, reload), so the device predictor is rebuilt
        self._model_version = 0
        self.pandas_categorical = None
        self.config = Config(self.params)
        if train_set is not None:
            self.config.warn_unimplemented()
            # a cluster config on the Booster brings the process group up
            # (the reference binding's machines -> NetworkInit, basic.py
            # :1470; the JAX package's basic.py:478)
            from .parallel.launch import maybe_init_distributed
            maybe_init_distributed(self.config)
            device = resolve_device(self.config)
            train_set.construct(self.config)
            obj = self.config.objective
            self._objective = create_objective(obj, self.config) \
                if isinstance(obj, str) else None
            binned = train_set.binned
            if self._objective is not None and binned.metadata.label is None:
                Log.fatal("Label should not be None for training")
            metrics = create_metrics(self.config.metric, self.config)
            for m in metrics:
                m.init(binned.metadata.label, binned.metadata.weight,
                       binned.metadata.query_boundaries)
            self._engine = create_boosting(
                str(self.config.boosting), self.config, binned,
                self._objective, metrics, device,
                init_model=copy.deepcopy(init_model)
                if init_model is not None else None)
            self._model = self._engine.model
            self.train_set = train_set
            self.pandas_categorical = train_set.pandas_categorical
        elif model_file is not None or model_str is not None:
            if model_str is None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._load_from_string(model_str)
        else:
            raise LightGBMError("Booster needs train_set or model file")

    # -- the model, behind the dispatch pipeline's barrier
    def _drain(self) -> None:
        """Drain the engine's dispatch pipeline so that model reads see
        every dispatched tree (the JAX package's Booster._drain; a no-op
        for a loaded model and for an empty pipeline): update() may
        return with up to pipeline_depth trees still being assembled."""
        engine = self.__dict__.get("_engine")
        if engine is not None:
            engine.flush()

    @property
    def _model(self) -> GBDTModel:
        """The model.  Every read drains the dispatch pipeline first, so
        each entry point that observes the model (current_iteration,
        num_trees, save_model, model_to_string, dump_model,
        feature_importance, predict, refit, get_leaf_output,
        shuffle_models, pickling, ...), and any caller that reads it
        directly, sees every dispatched tree.  A pure model read never
        truncates an open boosting window."""
        self._drain()
        return self._gbdt_model

    @_model.setter
    def _model(self, model: GBDTModel) -> None:
        self._gbdt_model = model

    # -- pickling: the model string (reference basic.py Booster
    # __getstate__ / __setstate__); the engine and the device state are
    # not carried
    def __getstate__(self) -> Dict:
        state = self.__dict__.copy()
        for key in ("_engine", "train_set", "_valid_data", "_objective",
                    "_dev_predictor", "_dev_pred_key", "_gbdt_model"):
            state.pop(key, None)
        state["_model_str"] = self._model.save_model_to_string()
        return state

    def __setstate__(self, state: Dict) -> None:
        model_str = state.pop("_model_str")
        self.__dict__.update(state)
        self._engine = None
        self.train_set = None
        self._valid_data = []
        self._dev_predictor = None
        self._dev_pred_key = None
        pc = self.pandas_categorical
        self._load_from_string(model_str)
        if pc is not None:  # the pickled lists win (the string has none)
            self.pandas_categorical = pc

    def __copy__(self) -> "Booster":
        return self.__deepcopy__(None)

    def __deepcopy__(self, _) -> "Booster":
        return Booster(params=self.params, model_str=self.model_to_string())

    def _load_from_string(self, model_str: str) -> None:
        """The one load sequence of __init__, __setstate__ and
        model_from_string."""
        self._model = GBDTModel.load_model_from_string(model_str)
        self.pandas_categorical = _load_pandas_categorical(model_str)
        self._objective = create_objective_from_model_string(
            self._model.objective_str, self.config)
        self._model_version += 1

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
        """One boosting iteration.  fobj(preds, train_set) -> (grad, hess)
        is called on the class-major [K * num_data] raw training scores
        (one blocking fetch) and returns gradients in the same layout.
        The iteration boundary of the training runtime's seams (the JAX
        package's Booster.update): the LGBM_TPU_FAULT iteration faults
        land here, the iteration runs under the non-finite sentinel's
        guard (abort re-raises naming the iteration; rollback drops the
        iteration, restores the scores and returns True, finished) and
        inside `telemetry.train_iteration` (timing, counters, sync gauges,
        the LGBM_TPU_PROFILE hook)."""
        if self._engine is None:
            raise LightGBMError("Cannot update a loaded Booster")
        resilience.maybe_die_or_preempt(self)
        self._model_version += 1
        guard = resilience.SentinelGuard(self._engine)
        try:
            with telemetry.train_iteration(self._engine.device):
                if fobj is not None:
                    grad, hess = fobj(
                        self._engine.custom_objective_scores().reshape(-1),
                        self.train_set)
                    return self._engine.train_one_iter(grad, hess)
                return self._engine.train_one_iter()
        except resilience.NonFiniteDetected as e:
            return guard.handle(e, Log)

    def phase_timings(self) -> Dict[str, float]:
        """Accumulated {phase: seconds} when tpu_profile_phases=true (the
        reference's TIMETAG counters, the JAX package's phase names);
        empty otherwise and for a loaded Booster."""
        if self._engine is None:
            return {}
        return dict(self._engine.timer.seconds)

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their scores."""
        self._model_version += 1
        self._engine.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict) -> "Booster":
        """Change parameters between iterations (Booster::ResetConfig):
        the learning rate, bagging and feature fraction take effect on
        the next iteration.  A loaded Booster updates its config."""
        if self._engine is not None:
            self._engine.reset_config(params)
        else:
            self.config.set(params)
        self.params.update(params)
        return self

    def current_iteration(self) -> int:
        return self._model.current_iteration

    def num_trees(self) -> int:
        return self._model.num_total_trees

    def num_model_per_iteration(self) -> int:
        return self._model.num_tree_per_iteration

    def num_feature(self) -> int:
        """Features the model was trained on."""
        return self._model.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self._model.feature_names)

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        return float(self._model.trees[tree_id].leaf_value[leaf_id])

    def attr(self, key: str):
        return getattr(self, "_attr", {}).get(key)

    def set_attr(self, **kwargs) -> "Booster":
        store = self.__dict__.setdefault("_attr", {})
        for k, v in kwargs.items():
            if v is None:
                store.pop(k, None)
            elif isinstance(v, str):
                store[k] = v
            else:
                raise LightGBMError("Only string values are accepted")
        return self

    def model_from_string(self, model_str: str,
                          verbose: bool = True) -> "Booster":
        """Re-initialize from a model string (drops any training engine)."""
        self._engine = None
        self.train_set = None
        self._load_from_string(model_str)
        if verbose:
            Log.info("Finished loading model, total used %d iterations",
                     self._model.current_iteration)
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute the iterations in [start, end) with np.random
        (reference Booster.shuffle_models)."""
        k = self._model.num_tree_per_iteration
        total = self._model.current_iteration
        end = total if end_iteration <= 0 else min(end_iteration, total)
        if not 0 <= start_iteration <= end:
            raise LightGBMError(
                "shuffle_models range [%d, %d) is invalid for a %d-iteration "
                "model" % (start_iteration, end, total))
        idx = np.arange(start_iteration, end)
        np.random.shuffle(idx)
        trees = self._model.trees
        blocks = [trees[i * k:(i + 1) * k] for i in range(total)]
        reordered = blocks[:start_iteration] + [blocks[i] for i in idx] \
            + blocks[end:]
        self._model.trees = [t for b in reordered for t in b]
        self._model_version += 1
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        self.train_set = None
        return self

    def free_network(self) -> "Booster":
        """Tear the process group down (LGBM_NetworkFree; a no-op without
        one)."""
        from .parallel.launch import shutdown_distributed
        shutdown_distributed()
        return self

    def set_network(self, machines=None, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Bring the process group up from a machine list (the reference
        binding's LGBM_NetworkInit; `capi.network_init`): machines is
        "ip:port,..." or a list of such entries, listen_time_out in
        minutes bounds the bring-up.  One machine is a no-op.  Training
        with tree_learner=data|voting|feature then runs over the
        group."""
        if num_machines <= 1 or not machines:
            return self
        if not isinstance(machines, str):
            machines = ",".join(machines)
        from .parallel.launch import init_distributed
        init_distributed(machines=machines,
                         local_listen_port=local_listen_port,
                         timeout_s=max(int(listen_time_out), 1) * 60)
        return self

    def host_syncs_per_tree(self) -> List[int]:
        """Blocking device-to-host reads each trained tree paid, wherever
        they happened: its own fetch (on the critical path at
        pipeline_depth=0, the assembler's pipeline_drain at depth >= 1;
        a boosting window's one window_drain counts with the window's
        first tree) and any sync its dispatch made."""
        self._drain()
        return list(self._engine.host_syncs) if self._engine else []

    def critical_syncs_per_tree(self) -> List[int]:
        """Of host_syncs_per_tree, the reads each tree paid on the
        tree-to-tree critical path: 1 a tree at pipeline_depth=0 (its
        tree_fetch), 0 at depth >= 1 on the fused path."""
        self._drain()
        return list(self._engine.critical_syncs) if self._engine else []

    def split_rounds_per_tree(self) -> Optional[float]:
        """Mean sequential grower rounds per trained tree: splits per tree
        on the one-leaf loop, fewer once tpu_frontier_batch > 1 commits
        several splits per round (None before the first tree)."""
        self._drain()
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
        mappers: a set made without reference=train_set is (re)binned so;
        the training set itself (cv's eval_train_metric) is taken as it
        is."""
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
    @staticmethod
    def _feval_preds(raw: np.ndarray) -> np.ndarray:
        """What a custom metric sees: plane 0, or the flattened [K, N]."""
        return raw[0] if raw.shape[0] == 1 else raw.reshape(-1)

    def eval_train(self, feval=None) -> List:
        """(name, metric, value, is_higher_better) of every training
        metric, then feval(preds, train_set)'s."""
        out = self._engine.eval_train()
        if feval is not None:
            name, val, hib = feval(
                self._engine.raw_train_score().reshape(-1), self.train_set)
            out.append(("training", name, val, hib))
        return out

    def eval_valid(self, feval=None) -> List:
        """(name, metric, value, is_higher_better) for every metric of
        every validation set, in the order they were added, then
        feval(preds, dataset)'s on each set."""
        return self._engine.eval_valid() + self._valid_feval(feval)

    def _valid_feval(self, feval) -> List:
        out = []
        if feval is not None:
            for i, (name, ds) in enumerate(self._valid_data):
                mname, val, hib = feval(
                    self._feval_preds(self._engine.raw_valid_score(i)), ds)
                out.append((name, mname, val, hib))
        return out

    def eval_round(self, feval=None, include_train: bool = False):
        """One evaluation round, (train results, valid results), off a
        SINGLE packed fetch of the round's scores (`GBDT.eval_all`; the
        JAX package's Booster.eval_round), so metric_freq=1 pays one
        round trip, not one a dataset.  A pipeline barrier: the round
        drains the pipeline and settles an open boosting window.  A
        custom metric reads the scores again, a fetch a set."""
        train_res, valid_res = self._engine.eval_all(include_train)
        if include_train and feval is not None:
            name, val, hib = feval(
                self._engine.raw_train_score().reshape(-1), self.train_set)
            train_res.append(("training", name, val, hib))
        return train_res, valid_res + self._valid_feval(feval)

    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """The config's metrics (and feval) of the current model on an
        arbitrary Dataset, through the exact host model (reference
        Booster.eval)."""
        data.construct(self.config)
        X = _to_2d_float(data.data, self.pandas_categorical)
        raw = self._model.predict_raw(X).T                   # [K, N]
        out = []
        qb = data.binned.metadata.query_boundaries
        for m in create_metrics(self.config.metric, self.config):
            m.init(data.get_label(), data.get_weight(), qb)
            score = raw if getattr(m, "multiclass", False) \
                else self._feval_preds(raw)
            out.append((name, m.name, float(m.eval(score, self._objective)),
                        m.is_higher_better))
        if feval is not None:
            mname, val, hib = feval(self._feval_preds(raw), data)
            out.append((name, mname, val, hib))
        return out

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
        X = _to_2d_float(data, self.pandas_categorical)
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
            key = (start_iteration, end, len(self._model.trees),
                   self._model_version, lq)
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

    def refit(self, data, label, weight=None, group=None,
              decay_rate: Optional[float] = None) -> "Booster":
        """Refit the leaves of every tree to new data (gbdt.cpp RefitTree
        :338-361, serial_tree_learner.cpp FitByExistingTree:223-248):
        every split is kept; each row's leaf comes from the host model,
        each iteration's gradients from the objective on the predict
        device (one blocking `refit_fetch` an iteration), and each leaf
        becomes decay * old + (1 - decay) * new * shrinkage, so later
        trees see the refit scores of earlier ones.  Returns a new loaded
        Booster."""
        if self._objective is None:
            raise LightGBMError("Cannot refit with a custom objective")
        X = _to_2d_float(data, self.pandas_categorical)
        label = np.asarray(label, dtype=np.float64).reshape(-1)
        n = X.shape[0]
        model = copy.deepcopy(self._model)
        cfg = self.config
        decay = float(cfg.refit_decay_rate) if decay_rate is None \
            else float(decay_rate)
        l1, l2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
        mds = float(cfg.max_delta_step)
        K = model.num_tree_per_iteration
        objective = create_objective(cfg.objective, cfg) \
            if isinstance(cfg.objective, str) else self._objective
        qb = None
        if group is not None:
            qb = np.concatenate([[0], np.cumsum(np.asarray(group, np.int64))])
        objective.init(label, weight, qb)
        leaf_pred = model.predict_leaf_index(X).astype(np.int64)   # [n, T]
        dev = self.predict_device()
        w_dev = torch.as_tensor(np.ones(n, np.float32) if weight is None
                                else np.asarray(weight, np.float32),
                                device=dev)
        label_dev = torch.as_tensor(label.astype(np.float32), device=dev)
        scores = np.zeros((K, n), dtype=np.float64)
        for it in range(model.current_iteration):
            g, h = objective.get_gradients_multi(
                torch.as_tensor(scores.astype(np.float32), device=dev),
                label_dev, w_dev)
            gh = syncs.device_get(torch.stack([g, h]), label="refit_fetch")
            g, h = gh.astype(np.float64)
            for k in range(K):
                tree = model.trees[it * K + k]
                nl = tree.num_leaves
                leaves = leaf_pred[:, it * K + k]
                sum_g = np.bincount(leaves, weights=g[k], minlength=nl)[:nl]
                sum_h = np.bincount(leaves, weights=h[k],
                                    minlength=nl)[:nl] + 1e-15
                out = -np.sign(sum_g) * np.maximum(np.abs(sum_g) - l1, 0.0) \
                    / (sum_h + l2)
                if mds > 0.0:
                    out = np.clip(out, -mds, mds)
                tree.leaf_value[:nl] = decay * tree.leaf_value[:nl] + \
                    (1.0 - decay) * out * tree.shrinkage
                scores[k] += tree.leaf_value[leaves]
        return Booster(params=dict(self.params),
                       model_str=model.save_model_to_string())

    # -- model IO ------------------------------------------------------------
    def _pandas_categorical_line(self) -> str:
        """The trailing category-lists line of the Python binding
        (reference _save_pandas_categorical); empty without category
        columns.  numpy scalars are written as numbers, so an int or
        float categorical column matches again at load time."""
        if not self.pandas_categorical:
            return ""
        return "\npandas_categorical:%s\n" % json.dumps(
            self.pandas_categorical,
            default=lambda o: o.item() if hasattr(o, "item") else str(o))

    def save_model(self, filename: str, num_iteration: int = -1,
                   start_iteration: int = 0) -> "Booster":
        self._model.save_model(filename, start_iteration, num_iteration,
                               parameters=self.config.to_string())
        line = self._pandas_categorical_line()
        if line:
            with open(filename, "a") as fh:
                fh.write(line)
        return self

    def model_to_string(self, num_iteration: int = -1,
                        start_iteration: int = 0) -> str:
        return self._model.save_model_to_string(start_iteration,
                                                num_iteration) + \
            self._pandas_categorical_line()

    def dump_model(self, num_iteration: int = -1) -> Dict:
        return self._model.dump_model(num_iteration)

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self._model.feature_importance(iteration, importance_type)
