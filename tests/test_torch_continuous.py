"""The port's continuous trainer (lightgbm_tpu_torch/runtime/continuous.py)
through ``python -m lightgbm_tpu_torch task=train_online`` children on
small data, on the CPU: a publish every cycle and the final model, a
preempted run and its relaunch rejoining byte-identical, refit mode, the
``slow_stage`` retry, the eval gate refusing a ``label_flip`` cycle, the
quarantine failing a ``poison_rows`` cycle, and the final generation
against the JAX package's service on the same file, node for node, with
weighted rows (the window's binary cache carries the weights).

The children are started together by one module fixture and each test
reads its own run's files."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import assert_models_equivalent
from lightgbm_tpu_torch.models.gbdt_model import GBDTModel
from lightgbm_tpu_torch.runtime import publish, resilience, tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX package's chaos-soak training parameters (exp/chaos.py)
TRAIN_PARAMS = ["objective=binary", "num_leaves=15", "bagging_freq=2",
                "bagging_fraction=0.7", "feature_fraction=0.8", "seed=7",
                "verbose=-1"]
CPU = ["device_type=cpu"]


def _make_data(path, n=400, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] + 0.4 * X[:, 1]
         + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.8g")
    return X, y


class _Child:
    """One service process, its output in files (a spinning child never
    blocks on a full pipe)."""

    def __init__(self, workdir, cycles, rounds=2, interval=0.0, fault=None,
                 extra=(), package="lightgbm_tpu_torch"):
        env = dict(os.environ)
        env.pop("LGBM_TPU_FAULT", None)
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu", LGBM_TPU_DOCTOR_ON_CRASH="0")
        if fault:
            env["LGBM_TPU_FAULT"] = fault
        self.workdir = str(workdir)
        n = len([f for f in os.listdir(self.workdir) if f.endswith(".out")])
        self.out = open(os.path.join(self.workdir, "run%d.out" % n), "w+")
        self.err = open(os.path.join(self.workdir, "run%d.err" % n), "w+")
        args = ["task=train_online", "data=train.tsv", "output_model=m.txt",
                "online_cycles=%d" % cycles, "online_rounds=%d" % rounds,
                "online_interval=%g" % interval] + list(extra)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", package] + args, cwd=self.workdir,
            env=env, stdout=self.out, stderr=self.err)

    def wait(self, timeout=240):
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.out.seek(0)
        self.err.seek(0)
        self.stdout, self.stderr = self.out.read(), self.err.read()
        self.out.close()
        self.err.close()
        self.returncode = self.proc.returncode
        return self


def _trail(workdir):
    return resilience.read_stage_report(
        os.path.join(str(workdir), "m.txt.stage_trail.json")) or {}


def _gen_texts(pub_dir):
    out = {}
    for gen, path in publish.generation_paths(pub_dir):
        with open(path) as fh:
            out[gen] = publish._split_validate(fh.read())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dirs = {k: tmp_path_factory.mktemp("online_" + k) for k in (
        "base", "churn", "refit", "slow", "flip", "poison", "port", "jax")}
    for k, d in dirs.items():
        if k not in ("flip", "poison", "port", "jax"):
            _make_data(str(d / "train.tsv"))
    rng = np.random.default_rng(0)
    Xf = rng.standard_normal((600, 6))
    yf = (Xf[:, 0] + 0.4 * Xf[:, 1]
          + 0.3 * rng.standard_normal(600) > 0).astype(float)
    np.savetxt(str(dirs["flip"] / "train.tsv"), np.column_stack([yf, Xf]),
               delimiter="\t", fmt="%.8g")
    _make_data(str(dirs["poison"] / "train.tsv"), n=200, f=5)
    # parity: both services read the same file and the same weighted
    # window cache (written after the file, so both find it fresh)
    Xp, yp = _make_data(str(dirs["port"] / "train.tsv"), n=800, seed=3)
    import lightgbm_tpu as jlgb
    w = np.random.default_rng(4).uniform(0.5, 1.5, len(yp))
    jlgb.Dataset(Xp.astype(np.float64), label=yp, weight=w,
                 params={"verbose": -1}).construct().save_binary(
        str(dirs["port"] / "m.txt.window.bin"))
    for name in ("train.tsv", "m.txt.window.bin"):
        with open(str(dirs["port"] / name), "rb") as src, \
                open(str(dirs["jax"] / name), "wb") as dst:
            dst.write(src.read())
    os.utime(str(dirs["jax"] / "m.txt.window.bin"))
    os.utime(str(dirs["port"] / "m.txt.window.bin"))
    parity = ["objective=binary", "num_leaves=7", "min_data_in_leaf=5",
              "verbose=-1", "online_save_binary=true", "metric=auc"]
    keep = ["publish_retention=0"]
    children = {
        "base": _Child(dirs["base"], 3, extra=TRAIN_PARAMS + CPU + keep),
        "churn": _Child(dirs["churn"], 3, fault="sigterm_at_iter:3",
                        extra=TRAIN_PARAMS + CPU + keep),
        "refit": _Child(dirs["refit"], 3, extra=TRAIN_PARAMS + CPU + keep
                        + ["online_mode=refit"]),
        "slow": _Child(dirs["slow"], 2, fault="slow_stage:snapshot:4",
                       extra=TRAIN_PARAMS + CPU
                       + ["online_stage_timeout=2"]),
        "flip": _Child(dirs["flip"], 3, fault="label_flip:2", extra=CPU + [
            "objective=binary", "num_leaves=7", "metric=binary_logloss",
            "verbose=-1", "seed=3", "publish_gate_tolerance=0.05",
            "publish_gate_holdout=0.25"]),
        "poison": _Child(dirs["poison"], 2, interval=0.1,
                         fault="poison_rows:0.5", extra=CPU + [
                             "objective=binary", "num_leaves=7",
                             "verbose=-1", "min_data_in_leaf=5",
                             "online_quarantine_limit=0.2", "online_rounds=1"]),
        "port": _Child(dirs["port"], 2, extra=CPU + parity),
        "jax": _Child(dirs["jax"], 2, extra=parity, package="lightgbm_tpu"),
    }
    # the poisoned service fails every cycle at its quarantine check;
    # once the trail shows it, a SIGTERM drains it
    end = time.monotonic() + 120
    while time.monotonic() < end and children["poison"].proc.poll() is None:
        if any("quarantine_failed" in s
               for s in _trail(dirs["poison"]).get("stages", [])):
            break
        time.sleep(0.05)
    if children["poison"].proc.poll() is None:
        children["poison"].proc.send_signal(signal.SIGTERM)
    done = {k: c.wait() for k, c in children.items()}
    done["resume"] = _Child(dirs["churn"], 3,
                            extra=TRAIN_PARAMS + CPU + keep)
    done["refit4"] = _Child(dirs["refit"], 4, extra=TRAIN_PARAMS + CPU
                            + keep + ["online_mode=refit"])
    done["resume"].wait()
    done["refit4"].wait()
    return dirs, done


def test_publishes_every_cycle_and_saves_final_model(runs):
    dirs, done = runs
    r = done["base"]
    assert r.returncode == 0, r.stderr[-2000:]
    base = dirs["base"]
    assert [g for g, _ in publish.generation_paths(
        str(base / "m.txt.pub"))] == [3, 2, 1]
    rec = publish.ModelSubscriber(str(base / "m.txt.pub")).resolve()
    assert rec.meta["cycle"] == 3 and rec.meta["total_iter"] == 6
    assert GBDTModel.load_model_from_string(
        rec.model_text).current_iteration == 6
    assert (base / "m.txt").read_text().startswith(rec.model_text)
    trail = _trail(base)
    names = [s["name"] for s in trail["stages"]]
    for c in (1, 2, 3):
        for st in ("ingest", "train", "snapshot", "publish"):
            assert "cycle %d: %s" % (c, st) in names, names
    train = [s for s in trail["stages"] if s["name"] == "cycle 2: train"][0]
    # the two trees' fetches, the assembler's at the default
    # pipeline_depth=1 (the cycle's iteration reads drain it)
    assert train["syncs"] == {"pipeline_drain": 2}
    assert train["program_builds"] == {}      # nothing rebuilt
    pub = [s for s in trail["stages"] if s["name"] == "cycle 2: publish"][0]
    assert pub["publish_latency_s"] >= 0
    ingest = [s for s in trail["stages"] if s["name"] == "cycle 1: ingest"]
    assert ingest[0]["ingest"]["mode"] == "full_parse"
    assert ingest[0]["ingest"]["rows_parsed"] == 400
    # the train_online shape manifest rides every publish
    sec, reason = publish.ModelSubscriber(
        str(base / "m.txt.pub")).read_warmup("train_online")
    assert reason == "ok" and sec["params_sig"]["num_leaves"] == 15
    # each cycle's trace context rides its meta
    ctxs = [tracing.parse_traceparent(m["trace"])
            for _, m in _gen_texts(str(base / "m.txt.pub")).values()]
    assert all(ctxs) and len({c[0] for c in ctxs}) == 3


def test_preempt_and_resume_rejoin_byte_identical(runs):
    dirs, done = runs
    pre, res = done["churn"], done["resume"]
    assert pre.returncode == 0, pre.stderr[-2000:]
    assert "preempt" in (pre.stdout + pre.stderr).lower()
    assert res.returncode == 0, res.stderr[-2000:]
    assert "warm start" in (res.stdout + res.stderr)
    svc = json.load(open(dirs["churn"] / "m.txt.service.json"))
    assert svc["interval"] == 0.0 and "t0" in svc
    base = _gen_texts(str(dirs["base"] / "m.txt.pub"))
    churn = _gen_texts(str(dirs["churn"] / "m.txt.pub"))
    assert sorted(churn) == [1, 2, 3]
    for gen in (1, 2, 3):
        assert churn[gen][0] == base[gen][0], "generation %d differs" % gen
    assert (dirs["churn"] / "m.txt").read_bytes() == \
        (dirs["base"] / "m.txt").read_bytes()


def test_refit_mode_cycles(runs):
    dirs, done = runs
    assert done["refit"].returncode == 0, done["refit"].stderr[-2000:]
    texts = _gen_texts(str(dirs["refit"] / "m.txt.pub"))
    assert sorted(texts) == [1, 2, 3, 4]
    m1 = GBDTModel.load_model_from_string(texts[1][0])
    m3 = GBDTModel.load_model_from_string(texts[3][0])
    assert m1.current_iteration == m3.current_iteration == 2
    assert [t.num_leaves for t in m1.trees] == \
        [t.num_leaves for t in m3.trees]
    assert texts[1][0] != texts[3][0]          # the leaves were refit
    # the relaunch resumed from the published lineage and extended it
    r4 = done["refit4"]
    assert r4.returncode == 0, r4.stderr[-2000:]
    assert "cycle 4: train" in r4.stdout and "cycle 1:" not in r4.stdout
    assert "bootstrap" not in r4.stdout
    m4 = GBDTModel.load_model_from_string(texts[4][0])
    assert [t.num_leaves for t in m4.trees] == \
        [t.num_leaves for t in m1.trees]


def test_slow_stage_times_out_and_cycle_retries(runs):
    dirs, done = runs
    r = done["slow"]
    assert r.returncode == 0, r.stderr[-2000:]
    assert "WATCHDOG" in r.stderr and "FAULT slow_stage" in r.stderr
    stages = _trail(dirs["slow"])["stages"]
    timed_out = [s for s in stages if s["status"] == "timeout"
                 and "snapshot" in s["name"]]
    assert len(timed_out) == 1
    assert timed_out[0].get("injected_stall_s") == 4.0
    assert any(s.get("retry") for s in stages)
    assert [g for g, _ in publish.generation_paths(
        str(dirs["slow"] / "m.txt.pub"))][0] == 2


def test_label_flip_rejected_by_the_gate(runs):
    dirs, done = runs
    r = done["flip"]
    assert r.returncode == 0, r.stderr[-2000:]
    pub_dir = str(dirs["flip"] / "m.txt.pub")
    gens = [g for g, _ in publish.generation_paths(pub_dir)]
    assert 2 not in gens and {1, 3} <= set(gens)
    assert publish.rejection_paths(pub_dir)[0][0] == 2
    meta = publish.ModelSubscriber(pub_dir, attempts=1).resolve_once().meta
    assert meta["gate"]["verdict"] == "pass"
    assert meta["gate"]["metric"] == "binary_logloss"
    rej = _trail(dirs["flip"])
    assert any("gate_rejected" in s for s in rej["stages"])


def test_poison_rows_fail_the_cycle_past_the_quarantine(runs):
    dirs, done = runs
    r = done["poison"]
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FAULT poison_rows" in r.stderr
    stages = _trail(dirs["poison"])["stages"]
    ingest = [s for s in stages if "quarantine" in s]
    assert ingest and ingest[0]["quarantine"]["by_reason"] == {
        "nonfinite_label": 100}
    assert any("quarantine_failed" in s for s in stages)
    # nothing was published for a failed cycle
    assert publish.generation_paths(str(dirs["poison"] / "m.txt.pub")) \
        == []


def test_final_generation_matches_the_jax_service(runs):
    dirs, done = runs
    for k in ("port", "jax"):
        assert done[k].returncode == 0, done[k].stderr[-2000:]
    port = _gen_texts(str(dirs["port"] / "m.txt.pub"))
    jax = _gen_texts(str(dirs["jax"] / "m.txt.pub"))
    assert sorted(port) == sorted(jax) == [1, 2]
    assert port[2][1]["total_iter"] == jax[2][1]["total_iter"] == 4
    assert_models_equivalent(port[2][0], jax[2][0])
    # the weighted cache was the window, in both
    for k in ("port", "jax"):
        assert (dirs[k] / "m.txt.window.bin").exists()
