"""The program ledger of the PyTorch port (lightgbm_tpu_torch/runtime/
graph_obs.py, the counterpart of runtime/xla_obs.py): the cases of
tests/test_xla_obs.py that the port has (signature deltas, cache events,
a forced rebuild naming its site and delta, the steady-state pin over
training and prediction, the cache hit events) over its own sites: the
grower's program per payload, its cache per fast state, the device
predictor's programs per row bucket and the kernels' nvcc builds.  CUDA
graph captures happen only on the card (chip_smoke.py's observe phase
pins them); a capture here is exercised through record_build, the call
graphs.Site makes."""
import stat

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.device_predictor import DevicePredictor
from lightgbm_tpu_torch.ops import build
from lightgbm_tpu_torch.runtime import graph_obs, telemetry, tracing

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, verbose=-1,
              device_type="cpu")


def _synth(n=1200, f=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    return X, (X[:, 0] + 0.3 * rng.standard_normal(n) > 0).astype(float)


def test_sig_delta_names_the_change():
    assert graph_obs.sig_delta(None, ("f32[8]",)) == "first_trace"
    assert graph_obs.sig_delta(("f32[8]", "k=2"), ("f32[16]", "k=2")) == \
        "arg0:f32[8]->f32[16]"
    d2 = graph_obs.sig_delta(("f32[8]",), ("f32[8]", "k=3"))
    assert "arg1" in d2 and "<absent>" in d2
    assert graph_obs.sig_delta(("f32[8]",), ("f32[8]",)) == \
        "identical_signature"
    sig = graph_obs.signature(torch.zeros(4, 38), torch.zeros(3, dtype=torch.bool),
                              merged=False)
    assert sig == ("f32[4,38]", "b1[3]", "merged=False")


def test_cache_event_and_snapshot_delta():
    graph_obs.cache_event("t.pycache", "miss")
    graph_obs.cache_event("t.pycache", "hit", 3)
    rec = graph_obs.LEDGER.register("t.pycache")
    assert rec.cache_misses >= 1 and rec.cache_hits >= 3
    snap = graph_obs.snapshot()
    assert graph_obs.delta(snap) == {}
    j = graph_obs.LEDGER.to_json()
    assert j["sites"]["t.pycache"]["cache_hits"] >= 3
    assert telemetry.counter("lgbm_program_cache_events_total").value(
        site="t.pycache", event="hit") >= 3


def test_record_build_and_replay_count_and_trace():
    """A capture (what graphs.Site reports): one compile of its site with
    its wall time, signature and a slice on the trace's capture row; a
    replay: a hit."""
    c = telemetry.counter("lgbm_xla_compiles_total")
    c0 = c.value(site="t.capture")
    graph_obs.record_build("t.capture", 0.25, ("f32[10,38]",))
    graph_obs.record_replay("t.capture")
    graph_obs.record_replay("t.capture")
    assert c.value(site="t.capture") == c0 + 1
    rec = graph_obs.LEDGER.register("t.capture")
    assert rec.calls >= 2 and rec.last_sig == ("f32[10,38]",)
    assert rec.history[-1]["wall_s"] == 0.25
    evs = [e for e in tracing.export_chrome()["traceEvents"]
           if e.get("name") == "build t.capture"]
    assert evs and evs[-1]["dur"] == pytest.approx(250_000, rel=0.01)


def test_forced_rebuild_names_site_and_delta():
    """After mark_steady, a grower program built for a payload of another
    shape is a retrace naming grower2.program and the row delta."""
    X, y = _synth(1200)
    lt.train(PARAMS, lt.Dataset(X, label=y), 2, verbose_eval=False)
    n0 = len(graph_obs.LEDGER.retraces)
    graph_obs.mark_steady(True)
    try:
        X2, y2 = _synth(3000, seed=4)
        lt.train(PARAMS, lt.Dataset(X2, label=y2), 1, verbose_eval=False)
    finally:
        graph_obs.mark_steady(False)
    new = [e for e in graph_obs.LEDGER.retraces[n0:]
           if e["site"] == "grower2.program"]
    assert new, graph_obs.LEDGER.retraces[n0:]
    assert "arg0:f32[" in new[-1]["delta"] and "->f32[" in new[-1]["delta"]
    assert telemetry.counter("lgbm_xla_retraces_total").value(
        site="grower2.program", delta=new[-1]["delta"]) >= 1


@pytest.mark.parametrize("extra", [{}, dict(tpu_frontier_batch=4),
                                   dict(bagging_fraction=0.6, bagging_freq=1),
                                   dict(objective="multiclass", num_class=3)])
def test_train_steady_state_builds_nothing(extra):
    """After the first iteration, N more iterations build nothing and miss
    no cache (the grower is made once per fast state); every iteration
    hits the grower cache."""
    X, y = _synth()
    if extra.get("num_class"):
        y = np.digitize(X[:, 1], [-0.4, 0.4]).astype(float)
    bst = lt.Booster(dict(PARAMS, **extra), lt.Dataset(X, label=y))
    bst.update()
    builds = graph_obs.snapshot()
    misses = graph_obs.LEDGER.misses_snapshot()
    hits = graph_obs.LEDGER.register("gbdt.grower_cache").cache_hits
    for _ in range(4):
        bst.update()
    assert graph_obs.delta(builds) == {}
    assert graph_obs.LEDGER.misses_snapshot() == misses
    assert graph_obs.LEDGER.register("gbdt.grower_cache").cache_hits == \
        hits + 4


def test_rollback_reentry_builds_nothing():
    """A rollback leaves the payload; the next iteration rebuilds it in its
    storage, so the grower and its program are reused."""
    X, y = _synth()
    bst = lt.Booster(PARAMS, lt.Dataset(X, label=y))
    for _ in range(3):
        bst.update()
    snap = graph_obs.snapshot()
    misses = graph_obs.LEDGER.misses_snapshot()
    bst.rollback_one_iter()
    bst.update()
    assert graph_obs.delta(snap) == {}
    assert graph_obs.LEDGER.misses_snapshot() == misses


def test_predictor_buckets_miss_once_then_hit():
    """The device predictor's program per row bucket: a new bucket is a
    miss of predictor.bucket_cache, a warm one a hit; after mark_steady
    no warm bucket builds."""
    X, y = _synth(600, seed=11)
    bst = lt.train(PARAMS, lt.Dataset(X, label=y), 3, verbose_eval=False)
    dp = DevicePredictor(bst._model, device="cpu")
    rec = graph_obs.LEDGER.register("predictor.bucket_cache")
    m0, h0 = rec.cache_misses, rec.cache_hits
    dp.predict_raw(X[:40])
    dp.predict_raw(X[:200])
    assert rec.cache_misses == m0 + 2
    snap = graph_obs.snapshot()
    for rows in (40, 50, 64, 200, 180):
        dp.predict_raw(X[:rows])
    assert rec.cache_misses == m0 + 2 and rec.cache_hits == h0 + 5
    assert graph_obs.delta(snap) == {}


def _fake_nvcc(tmp_path):
    """A stand-in nvcc that writes its -o target (the CPU sandbox has no
    CUDA toolkit)."""
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; "
                    "then shift; echo built > \"$1\"; fi\n  shift\ndone\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_kernel_builds_are_ledgered(tmp_path, monkeypatch):
    """ops/build.py: an nvcc run is a build of site build.<source>, a
    library already on disk a hit there."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    snap = graph_obs.snapshot()
    rec = graph_obs.LEDGER.register("build.segment_hist")
    h0 = rec.cache_hits
    build.build_all(["segment_hist"])
    assert graph_obs.delta(snap) == {"build.segment_hist": 1}
    assert rec.last_sig[0].startswith("libsegment_hist_")
    build.build_all(["segment_hist"])
    assert graph_obs.delta(snap) == {"build.segment_hist": 1}
    assert rec.cache_hits == h0 + 1
