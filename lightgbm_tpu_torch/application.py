"""CLI application: task=train / predict / convert_model / refit / doctor
(counterpart of lightgbm_tpu/application.py).

Role parity with the reference src/application/application.cpp and main.cpp:
parameters from `k=v` argv entries plus a `config=<file>` of `key = value`
lines (argv wins, application.cpp:48-81); training loads data (+ optional
<data>.weight / <data>.query sidecars, or a binary dataset cache), runs the
engine, saves the model and periodic snapshots (gbdt.cpp:330-334) and
resumes from them; prediction writes one converted score per row
(src/application/predictor.hpp); convert_model emits the model as C++
if-else code (gbdt_model_text.cpp ModelToIfElse); doctor writes the debug
bundle.

Every task but doctor runs on the card unless the parameters say
device_type=cpu, and fails without a CUDA device otherwise (doctor is the
tool that diagnoses a missing device).  What this package does not have
yet is refused, never replaced by something quieter: a machine list or
num_machines > 1 (distributed training, ROADMAP queue A item 5),
task=serve and task=train_online (item 6), and the device predictor with
leaf indices or contributions (it computes neither; task=predict runs it
on the card unless predict_device=false).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .callback import record_evaluation
from .config import Config, resolve_device
from .engine import _rounds_from_params
from .engine import train as engine_train
from .io.parser import load_sidecar, parse_file
from .models.gbdt_model import GBDTModel
from .runtime import resilience, telemetry
from .utils.log import LightGBMError, Log

#: per-stage deadline for the CLI's ingest/save stages (seconds; 0
#: disables).  Training itself is legitimately unbounded, so only the
#: bounded stages are watchdogged by default: a hung parse or a stuck
#: filesystem dies loudly with a faulthandler dump instead of stalling
#: the whole task (LGBM_TPU_STAGE_TIMEOUT overrides).
_INGEST_STAGE_TIMEOUT = int(os.environ.get("LGBM_TPU_STAGE_TIMEOUT", "3600"))

_TRUE = ("true", "1")


def parse_parameters(argv: List[str]) -> Dict[str, str]:
    """argv `k=v` pairs > config file lines (application.cpp LoadParameters)."""
    cli: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            continue
        k, v = arg.split("=", 1)
        cli[k.strip()] = v.strip()
    params: Dict[str, str] = {}
    config_path = cli.get("config", cli.get("config_file"))
    if config_path:
        with open(config_path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                params[k.strip()] = v.strip()
    params.update(cli)
    params.pop("config", None)
    params.pop("config_file", None)
    return params


class Application:
    def __init__(self, argv: List[str]):
        self.raw_params = parse_parameters(argv)
        self.task = self.raw_params.pop("task", "train")
        # tracing knobs: trace_dir= arms the atexit flight-recorder dump
        # (same as $LGBM_TPU_TRACE_DIR, which subprocesses inherit),
        # trace=false disables the recorder entirely
        from .runtime import tracing
        trace_dir = self.raw_params.pop("trace_dir", None)
        if trace_dir:
            os.environ[tracing.TRACE_DIR_ENV] = trace_dir
        if str(self.raw_params.pop("trace", "")).lower() in ("false", "0"):
            tracing.set_enabled(False)
        tracing.set_context(self.task)
        tracing.maybe_autostart()
        # the kernel build cache: compile_cache_dir= (same as
        # $LGBM_TPU_COMPILE_CACHE) points ops/build.py at a fingerprinted
        # subdirectory before any task builds a kernel
        from .runtime import warmup
        cache_dir = self.raw_params.pop("compile_cache_dir", None)
        if cache_dir:
            warmup.enable_compile_cache(cache_dir)
        else:
            warmup.maybe_enable_from_env()

    def run(self) -> None:
        try:
            if self.task in ("serve", "train_online"):
                raise NotImplementedError(
                    "task=%s is not ported to the PyTorch package yet "
                    "(ROADMAP queue A item 6)" % self.task)
            if self.task != "doctor":
                # every task but the diagnosis runs where the parameters
                # say: the card unless device_type=cpu, never a quiet CPU
                dev = str(self.raw_params.get("device", "")).lower()
                if dev in _TRUE + ("false", "0"):
                    # the JAX package's device=true means predict_device
                    raise LightGBMError(
                        "device=%s: device is the alias of device_type "
                        "(cuda|gpu|cpu) in this package; the device "
                        "predictor is predict_device=true|false" % dev)
                resolve_device(Config(self.raw_params))
            if self.task in ("train", "refit"):
                # reference parity: Network::Init runs inside InitTrain
                # only (application.cpp:168-171)
                self._maybe_init_network()
            if self.task == "train":
                self.train()
            elif self.task in ("predict", "prediction", "test"):
                self.predict()
            elif self.task == "convert_model":
                self.convert_model()
            elif self.task == "refit":
                self.refit()
            elif self.task == "doctor":
                self.doctor()
            else:
                Log.fatal("Unknown task type %s", self.task)
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException:
            # crash path: ship the evidence before dying.  The bundle is
            # the one task=doctor builds, without the probe (the crash may
            # BE a wedged device); LGBM_TPU_DOCTOR_ON_CRASH=0 opts out,
            # LGBM_TPU_DOCTOR_DIR redirects it.
            self._crash_bundle()
            raise
        finally:
            if getattr(self, "_network_up", False):
                # Network::Dispose: a group this run brought up goes with it
                from .parallel import launch
                launch.shutdown_distributed()
                self._network_up = False

    def _crash_bundle(self) -> None:
        if os.environ.get("LGBM_TPU_DOCTOR_ON_CRASH", "1") == "0" \
                or self.task == "doctor":
            return
        try:
            import tempfile
            import traceback

            from .runtime.doctor import collect_debug_bundle
            out_dir = os.environ.get("LGBM_TPU_DOCTOR_DIR",
                                     tempfile.gettempdir())
            rec = collect_debug_bundle(
                out_dir=out_dir, tag="crash_%s" % self.task,
                config=self.raw_params, probe=False,
                note=traceback.format_exc(limit=20))
            sys.stderr.write("doctor: crash bundle written to %s "
                             "(%d members)\n"
                             % (rec["path"],
                                len(rec["manifest"]["members"])))
        except BaseException:       # noqa: BLE001 — never mask the crash
            pass

    def _maybe_init_network(self) -> None:
        """The reference brings the network up for a training task with a
        cluster config (application.cpp Network::Init) when it describes
        more than one machine: the process group comes up through
        parallel/launch.py's maybe_init_distributed (the JAX package's
        rule), and `run` tears down what it brought up."""
        from .parallel import launch
        cfg = {Config.resolve_alias(k): v for k, v in self.raw_params.items()}
        up = launch._already_initialized()
        if launch.maybe_init_distributed(cfg) is not None and not up:
            self._network_up = True

    # -- data loading --------------------------------------------------------
    def _load(self, path: str, num_features: Optional[int] = None):
        params = self.raw_params
        label_column = 0
        lc = params.get("label_column", params.get("label", ""))
        if lc.startswith("name:"):
            Log.fatal("label_column by name requires a header; use an index")
        elif lc:
            label_column = int(lc)
        has_header = None
        if params.get("has_header", params.get("header", "")).lower() in _TRUE:
            has_header = True
        X, y = parse_file(path, label_column=label_column, has_header=has_header,
                          num_features=num_features)
        weight = load_sidecar(path + ".weight")
        query = load_sidecar(path + ".query")
        return X, y, weight, query

    # -- tasks ---------------------------------------------------------------
    def train(self) -> None:
        params = dict(self.raw_params)
        data_path = params.pop("data", params.pop("train_data", None))
        if not data_path:
            Log.fatal("No training data, set data=<file>")
        valid_paths = [p for p in
                       params.pop("valid", params.pop("valid_data", "")).split(",") if p]
        output_model = params.pop("output_model", "LightGBM_model.txt")
        input_model = params.pop("input_model", None)
        num_rounds, early_stopping = _rounds_from_params(params, 100, 0)
        num_rounds, early_stopping = int(num_rounds), int(early_stopping or 0)
        snapshot_freq = int(params.pop("snapshot_freq", -1))
        # keep-last-K snapshot cleanup; <= 0 keeps everything
        snapshot_retention = int(params.pop("snapshot_retention", -1))
        resume = str(params.pop("resume", "")).lower() in _TRUE

        # resume=true: scan for the newest VALID snapshot (checksummed
        # footer; corrupt or truncated ones are skipped with a warning)
        # and continue from it to a model byte-identical to an
        # uninterrupted run (runtime/resilience.py restores the scores,
        # the payload's row order and the RNG streams past the trees)
        resume_state = None
        if resume:
            snap_path, resume_state = resilience.find_resume_snapshot(
                output_model, log=Log)
            if snap_path is None:
                Log.warning("resume=true but no valid snapshot found for "
                            "%s; training from scratch", output_model)
            else:
                Log.info("Resuming from snapshot %s (iteration %d)",
                         snap_path, resume_state["total_iter"])
                input_model = snap_path
                if resume_state["total_iter"] >= num_rounds:
                    Log.info("Snapshot already has %d >= %d iterations; "
                             "saving it as the final model",
                             resume_state["total_iter"], num_rounds)
                    GBDTModel.load_model(snap_path).save_model(output_model)
                    return

        # $LGBM_TPU_METRICS_FILE: periodic atomic JSON-lines snapshots of
        # the metrics registry for batch runs that have no scrape endpoint
        telemetry.maybe_start_file_export("cli_train")

        wd = resilience.Watchdog(_INGEST_STAGE_TIMEOUT, hard=False,
                                 label="cli stage")
        from .io.dataset import BinnedDataset
        resolved = {Config.resolve_alias(k): v for k, v in params.items()}
        with wd.stage_scope("ingest train data (%s)" % data_path):
            t_ingest = time.perf_counter()
            if BinnedDataset.is_binary_file(data_path):
                # version-stamped cache: a stale format_version refuses
                # here with a clear delete-and-rebuild error
                train_set = Dataset(data_path, params=params)
                train_set.construct(Config(params))
                dt = time.perf_counter() - t_ingest
                wd.annotate("ingest", {
                    "mode": "binary_cache",
                    "rows": int(train_set.num_data()),
                    "rows_per_sec": round(train_set.num_data() / dt, 1)
                    if dt > 0 else None})
            else:
                X, y, weight, query = self._load(data_path)
                dt = time.perf_counter() - t_ingest
                wd.annotate("ingest", {
                    "mode": "file_parse", "rows": int(X.shape[0]),
                    "rows_per_sec": round(X.shape[0] / dt, 1)
                    if dt > 0 else None})
                group = None
                if query is not None:
                    group = query.astype(np.int64)
                train_set = Dataset(X, label=y, weight=weight, group=group,
                                    params=params)
                if str(resolved.get("save_binary", "")).lower() in _TRUE:
                    train_set.construct(Config(params))
                    train_set.save_binary(data_path + ".bin")
        valid_sets = []
        valid_names = []
        num_features = train_set.binned.num_total_features
        for vp in valid_paths:
            with wd.stage_scope("ingest valid data (%s)" % vp):
                vX, vy, vweight, vquery = self._load(vp,
                                                     num_features=num_features)
                vgroup = vquery.astype(np.int64) if vquery is not None else None
                valid_sets.append(train_set.create_valid(
                    vX, label=vy, weight=vweight, group=vgroup))
                valid_names.append(os.path.basename(vp))
        wd.done()

        callbacks = []
        if resume_state is not None:
            callbacks.append(resilience.make_resume_callback(resume_state,
                                                             log=Log))
        if snapshot_freq > 0:
            def snapshot(env):
                # the absolute iteration clock (model.current_iteration),
                # so a resumed run writes the SAME snapshot schedule and
                # names as an uninterrupted one
                total = int(env.model.current_iteration())
                if total % snapshot_freq == 0:
                    resilience.write_snapshot(env.model, output_model,
                                              total_iter=total,
                                              retention=snapshot_retention,
                                              log=Log)
            callbacks.append(snapshot)
        evals: Dict = {}
        callbacks.append(record_evaluation(evals))

        # preemption guard: SIGTERM/SIGINT write a final checksummed
        # snapshot at the next iteration boundary, then exit cleanly
        guard = resilience.PreemptionGuard(output_model,
                                           retention=snapshot_retention,
                                           log=Log)
        callbacks.append(guard.callback)
        remaining = num_rounds - (resume_state["total_iter"]
                                  if resume_state is not None else 0)
        try:
            with guard:
                booster = engine_train(
                    params, train_set, num_boost_round=remaining,
                    valid_sets=valid_sets or None,
                    valid_names=valid_names or None,
                    init_model=input_model, callbacks=callbacks,
                    early_stopping_rounds=early_stopping
                    if early_stopping > 0 else None,
                    verbose_eval=int(params.get("metric_freq", 1)))
        except resilience.TrainingPreempted as e:
            Log.warning("Training preempted by signal %d at iteration %d; "
                        "snapshot %s written — rerun with resume=true to "
                        "continue", e.signum, e.iteration, e.snapshot)
            telemetry.write_snapshot_now("cli_train_preempted")
            return
        with wd.stage_scope("save model (%s)" % output_model):
            booster.save_model(output_model)
        wd.done()
        telemetry.write_snapshot_now("cli_train")
        Log.info("Finished training, model saved to %s", output_model)

    def predict(self) -> None:
        params = dict(self.raw_params)
        data_path = params.pop("data", None)
        input_model = params.pop("input_model", None)
        output_result = params.pop("output_result", "LightGBM_predict_result.txt")
        # on the card the tree-parallel device predictor (f32 thresholds,
        # micro-batched transfers) computes the scores; predict_device=false
        # takes the exact f64 host traversal, whose output files are the
        # byte-parity reference for the C ABI's LGBM_BoosterPredictForFile,
        # and so does device_type=cpu unless predict_device=true asks for
        # the device predictor on the CPU.  `device` is the alias of
        # device_type here and stays in the Booster's params.
        on_card = resolve_device(Config(params)).type != "cpu"
        flag = str(params.pop("predict_device", "")).lower()
        use_device = flag in _TRUE if flag else on_card
        if not data_path or not input_model:
            Log.fatal("Prediction needs data=<file> and input_model=<file>")
        raw_score = params.get("predict_raw_score", "").lower() in _TRUE
        pred_leaf = params.get("predict_leaf_index", "").lower() in _TRUE
        pred_contrib = params.get("predict_contrib", "").lower() in _TRUE
        if use_device and (pred_leaf or pred_contrib):
            # the JAX package switches to the host predictor here; a
            # quiet change of device is what this package refuses
            raise LightGBMError(
                "the device predictor computes normal and raw scores only; "
                "pass predict_device=false for predict_leaf_index or "
                "predict_contrib (the host predictor computes them)")
        booster = Booster(params=params, model_file=input_model)
        num_feat = booster._model.max_feature_idx + 1
        X, _, _, _ = self._load(data_path, num_features=num_feat)
        num_iter = int(params.get("num_iteration_predict", -1))
        early = params.get("pred_early_stop", "").lower() in _TRUE
        out = booster.predict(
            X, raw_score=raw_score, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, num_iteration=num_iter,
            pred_early_stop=early, device=use_device,
            pred_early_stop_freq=int(params.get("pred_early_stop_freq", 10)),
            pred_early_stop_margin=float(
                params.get("pred_early_stop_margin", 10.0)))
        out = np.asarray(out)
        with open(output_result, "w") as fh:
            if out.ndim == 1:
                for v in out:
                    fh.write("%.18g\n" % v)
            else:
                for row in out:
                    fh.write("\t".join("%.18g" % v for v in row) + "\n")
        Log.info("Finished prediction, results saved to %s", output_result)

    def convert_model(self) -> None:
        params = dict(self.raw_params)
        input_model = params.pop("input_model", None)
        out_path = params.pop("convert_model_file",
                              params.pop("output_model", "gbdt_prediction.cpp"))
        if not input_model:
            Log.fatal("convert_model needs input_model=<file>")
        model = GBDTModel.load_model(input_model)
        with open(out_path, "w") as fh:
            fh.write(model_to_ifelse(model))
        Log.info("Finished converting model, saved to %s", out_path)

    def doctor(self) -> None:
        """One-command debug bundle (runtime/doctor.py): the platform
        probe, the environment and config fingerprint, stage trails, the
        metrics snapshot, the program ledger and the newest BENCH / CHAOS
        / MULTICHIP artifacts in one atomic checksummed tar.  Params:
        `output_dir=` (default .), `probe=false` skips the platform probe,
        `probe_deadline=S`, `artifact_dir=` overrides where artifacts are
        collected from."""
        from .runtime.doctor import collect_debug_bundle
        params = dict(self.raw_params)
        out_dir = params.pop("output_dir", params.pop("out_dir", "."))
        probe = str(params.pop("probe", "true")).lower() not in ("false",
                                                                 "0")
        deadline = float(params.pop("probe_deadline", 10.0))
        artifact_dir = params.pop("artifact_dir", None)
        rec = collect_debug_bundle(out_dir=out_dir, tag=None,
                                   config=params, probe=probe,
                                   probe_deadline=deadline,
                                   artifact_dir=artifact_dir)
        # the path on stdout is the machine contract
        print("doctor bundle %s" % rec["path"], flush=True)
        for m in rec["manifest"]["members"]:
            Log.info("doctor:   %-28s %7d bytes  sha256=%s...",
                     m["name"], m["bytes"], m["sha256"][:12])
        if rec["manifest"].get("errors"):
            Log.warning("doctor: some members could not be gathered: %s",
                        rec["manifest"]["errors"])

    def refit(self) -> None:
        params = dict(self.raw_params)
        data_path = params.pop("data", None)
        input_model = params.pop("input_model", None)
        output_model = params.pop("output_model", "LightGBM_model.txt")
        if not data_path or not input_model:
            Log.fatal("Refit needs data=<file> and input_model=<file>")
        booster = Booster(params=params, model_file=input_model)
        num_feat = booster._model.max_feature_idx + 1
        X, y, weight, query = self._load(data_path, num_features=num_feat)
        group = query.astype(np.int64) if query is not None else None
        new_booster = booster.refit(X, y, weight=weight, group=group)
        new_booster.save_model(output_model)
        Log.info("Finished refit, model saved to %s", output_model)


def model_to_ifelse(model: GBDTModel) -> str:
    """C++ codegen of the model (gbdt_model_text.cpp ModelToIfElse:240+):
    one PredictTreeN function per tree plus a summing Predict entry."""
    lines = ["#include <cmath>", "#include <cstdio>", "", "namespace {", ""]

    def node_code(tree, node: int, depth: int) -> List[str]:
        pad = "  " * (depth + 1)
        if node < 0:
            return ["%sreturn %.17g;" % (pad, tree.leaf_value[~node])]
        dt = int(tree.decision_type[node])
        f = int(tree.split_feature[node])
        out = []
        if dt & 1:  # categorical
            ci = int(tree.threshold_in_bin[node])
            lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
            cats = [(i - lo) * 32 + j for i in range(lo, hi) for j in range(32)
                    if (tree.cat_threshold[i] >> j) & 1]
            cond = " || ".join("static_cast<int>(arr[%d]) == %d" % (f, c)
                               for c in cats) or "false"
            out.append("%sif (%s) {" % (pad, cond))
        else:
            missing_type = (dt >> 2) & 3
            default_left = bool(dt & 2)
            thr = "%.17g" % tree.threshold[node]
            if missing_type == 2:  # NaN
                if default_left:
                    cond = "(std::isnan(arr[%d]) || arr[%d] <= %s)" % (f, f, thr)
                else:
                    cond = "(!std::isnan(arr[%d]) && arr[%d] <= %s)" % (f, f, thr)
            elif missing_type == 1:  # Zero
                if default_left:
                    cond = "(std::fabs(arr[%d]) <= 1e-35 || arr[%d] <= %s)" % (f, f, thr)
                else:
                    cond = "(std::fabs(arr[%d]) > 1e-35 && arr[%d] <= %s)" % (f, f, thr)
            else:
                cond = "(arr[%d] <= %s)" % (f, thr)
            out.append("%sif %s {" % (pad, cond))
        out.extend(node_code(tree, int(tree.left_child[node]), depth + 1))
        out.append("%s} else {" % pad)
        out.extend(node_code(tree, int(tree.right_child[node]), depth + 1))
        out.append("%s}" % pad)
        return out

    for i, tree in enumerate(model.trees):
        lines.append("double PredictTree%d(const double* arr) {" % i)
        if tree.num_leaves <= 1:
            lines.append("  return %.17g;" % tree.leaf_value[0])
        else:
            lines.extend(node_code(tree, 0, 0))
        lines.append("}")
        lines.append("")
    lines.append("}  // namespace")
    lines.append("")
    lines.append("double Predict(const double* arr) {")
    lines.append("  double sum = 0.0;")
    for i in range(len(model.trees)):
        lines.append("  sum += PredictTree%d(arr);" % i)
    if model.average_output and model.trees:
        lines.append("  sum /= %d.0;" % model.current_iteration)
    lines.append("  return sum;")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m lightgbm_tpu_torch task=<train|predict|"
              "convert_model|refit|doctor> [config=<file>] [key=value ...]"
              "  (device_type=cpu to run on the CPU)")
        return
    Application(argv).run()
