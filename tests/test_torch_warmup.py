"""The kernel build cache of the PyTorch port (lightgbm_tpu_torch/runtime/
warmup.py, the compile-cache half of runtime/warmup.py): the fingerprint
(stable; keyed on the nvcc flags, the torch and CUDA versions, the card's
capability once CUDA is initialized, the host), the sweep past a budget,
and the build directory moved under the fingerprint with every kernel
build classified as a hit or a miss.  The CPU sandbox has no nvcc: a
stand-in writes the libraries."""
import os
import stat

import pytest
import torch

from lightgbm_tpu_torch.ops import build
from lightgbm_tpu_torch.runtime import telemetry, warmup

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    warmup._reset_for_tests()
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    yield
    warmup._reset_for_tests()


def _fake_nvcc(tmp_path):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; "
                    "then shift; echo built > \"$1\"; fi\n  shift\ndone\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_cache_fingerprint_stable_and_flag_sensitive(monkeypatch):
    fp1 = warmup.cache_fingerprint()
    assert fp1 == warmup.cache_fingerprint()
    assert fp1.startswith("torch") and "-cuda" in fp1
    # CUDA is not initialized here: the fingerprint must not initialize it
    assert "-uninit-" in fp1 and not torch.cuda.is_initialized()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert warmup.cache_fingerprint() != fp1, (
        "changing the nvcc flags did not change the cache fingerprint: a "
        "library built with other flags could be loaded")


def test_cache_sweep_evicts_oldest_past_budget(tmp_path):
    cdir = warmup.enable_compile_cache(str(tmp_path), budget_mb=1)
    assert cdir and cdir.startswith(str(tmp_path))
    assert os.path.basename(cdir) == warmup.cache_fingerprint()
    assert str(build.BUILD_DIR) == cdir
    for i, name in enumerate(("a", "b", "c")):
        p = os.path.join(cdir, name)
        with open(p, "wb") as fh:
            fh.write(b"\0" * (600 * 1024))
        os.utime(p, (1000 + i, 1000 + i))
    c = telemetry.counter("lgbm_compile_cache_events_total")
    e0 = c.value(event="evict")
    assert warmup.sweep_cache(budget_mb=1) == 2
    assert sorted(os.listdir(cdir)) == ["c"]
    assert c.value(event="evict") == e0 + 2
    st = warmup.cache_status()
    assert st["evictions"] >= 2 and st["files"] == 1 and st["enabled"]


def test_builds_classified_hit_or_miss(tmp_path, monkeypatch):
    # written once: rewriting the script while an earlier build's shell
    # reads it can leave that build without its output
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    cdir = warmup.enable_compile_cache(str(tmp_path / "cache"))
    assert warmup.enable_compile_cache(str(tmp_path / "cache")) == cdir
    c = telemetry.counter("lgbm_compile_cache_events_total")
    m0, h0 = c.value(event="miss"), c.value(event="hit")
    build.build_all(["segment_hist", "segment_partition"])
    assert sorted(os.listdir(cdir)) == sorted(
        build._target(n).name for n in ("segment_hist", "segment_partition"))
    build.build_all(["segment_hist"])
    assert c.value(event="miss") == m0 + 2 and c.value(event="hit") == h0 + 1
    st = warmup.cache_status()
    assert (st["misses"], st["hits"], st["files"]) == (2, 1, 2)


def test_maybe_enable_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(warmup.CACHE_ENV, raising=False)
    before = build.BUILD_DIR
    assert warmup.maybe_enable_from_env() is None
    assert build.BUILD_DIR == before and not warmup.cache_status()["enabled"]
    monkeypatch.setenv(warmup.CACHE_ENV, str(tmp_path))
    monkeypatch.setenv(warmup.CACHE_BUDGET_ENV, "7")
    cdir = warmup.maybe_enable_from_env()
    assert cdir == os.path.join(str(tmp_path), warmup.cache_fingerprint())
    assert warmup.cache_status()["budget_mb"] == 7


# ---------------------------------------------------------------------------
# the shape manifest and the serving prewarm (the counterparts of
# tests/test_warmup.py's manifest and prewarm tests)
# ---------------------------------------------------------------------------

import json                                              # noqa: E402
import threading                                         # noqa: E402
import urllib.error                                      # noqa: E402
import urllib.request                                    # noqa: E402

import numpy as np                                       # noqa: E402

from lightgbm_tpu.runtime import warmup as jwarmup       # noqa: E402
from lightgbm_tpu_torch.runtime import graph_obs, publish  # noqa: E402
from lightgbm_tpu_torch.runtime.serving import ServingRuntime  # noqa: E402

CPU = {"device_type": "cpu", "verbose": -1}


def _synth_model(n_trees=12, num_leaves=15, n_feat=8, seed=1):
    from bench import synth_serving_model
    return synth_serving_model(n_trees, num_leaves, n_feat,
                               seed=seed).save_model_to_string()


def _warmup_count(kind, outcome):
    return telemetry.counter("lgbm_warmup_total").value(kind=kind,
                                                        outcome=outcome)


def test_manifest_roundtrip_and_section_merge(tmp_path):
    d = str(tmp_path)
    warmup.write_manifest(d, "serving",
                          warmup.build_serving_section(8, [64, 16], 3))
    warmup.write_manifest(
        d, "train_online",
        warmup.build_train_section({"num_leaves": 15}, 8, 3))
    sec, reason = warmup.read_manifest(d, "serving")
    assert reason == "ok" and sec["row_buckets"] == [16, 64]
    sec2, reason2 = warmup.read_manifest(d, "train_online")
    assert reason2 == "ok" and sec2["params_sig"]["num_leaves"] == 15
    doc = json.load(open(warmup.manifest_path(d)))
    assert set(doc["sections"]) == {"serving", "train_online"}
    assert doc["checksum"]
    # the JAX package reads the port's manifest, and merges into it
    assert jwarmup.read_manifest(d, "serving") == (sec, "ok")
    jwarmup.write_manifest(d, "serving",
                           jwarmup.build_serving_section(8, [32], 4))
    sec3, reason3 = warmup.read_manifest(d, "serving")
    assert reason3 == "ok" and sec3["row_buckets"] == [32]
    assert warmup.read_manifest(d, "train_online") == (sec2, "ok")
    assert warmup.params_sig({"num_leaves": 7}, 6) == \
        jwarmup.params_sig({"num_leaves": 7}, 6)


def test_manifest_missing_and_torn(tmp_path):
    d = str(tmp_path)
    assert warmup.read_manifest(d, "serving") == (None, "missing")
    with open(warmup.manifest_path(d), "w") as fh:
        fh.write('{"schema_version": 1, "sections":')
    assert warmup.read_manifest(d, "serving") == (None, "torn")
    with open(warmup.manifest_path(d), "w") as fh:
        json.dump({"schema_version": 1, "sections": {"serving": {}},
                   "checksum": "0" * 64}, fh)
    assert warmup.read_manifest(d, "serving") == (None, "torn")


@pytest.mark.parametrize("buckets,nf,gen,want", [
    ([16, 64], 8, 3, "ok"), ([16, 64], 8, 7, "ok"),
    ([16, 64], 9, 3, "shape_mismatch"), ([16, 64], 9, 7, "manifest_stale"),
    ([], 8, 3, "manifest_invalid"), ([16, "x"], 8, 3, "manifest_invalid"),
    ([1 << 23], 8, 3, "manifest_invalid")])
def test_classify_serving_outcomes(buckets, nf, gen, want):
    sec = dict(warmup.build_serving_section(8, [16], 3),
               row_buckets=buckets)
    assert warmup.classify_serving_section(sec, nf, gen) == want
    assert jwarmup.classify_serving_section(sec, nf, gen) == want


def test_classify_train_outcomes():
    params = {"objective": "binary", "num_leaves": 31}
    sec = warmup.build_train_section(params, 28, 2)
    assert warmup.classify_train_section(sec, params, 28) == "ok"
    assert jwarmup.classify_train_section(sec, params, 28) == "ok"
    assert warmup.classify_train_section(sec, params, 29) \
        == "shape_mismatch"
    assert warmup.classify_train_section(
        sec, {"objective": "binary", "num_leaves": 63}, 28) \
        == "shape_mismatch"
    assert warmup.classify_train_section({"kind": "train_online"},
                                         params, 28) == "manifest_invalid"


def test_concurrent_readers_never_observe_torn_manifest(tmp_path):
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=1, grace_s=0.0)
    text = _synth_model()
    pub.publish(text, meta={"cycle": 1})
    pub.publish_manifest("serving", warmup.build_serving_section(8, [16], 1))
    bad = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            sec, reason = warmup.read_manifest(d, "serving")
            if reason != "ok":
                bad.append(reason)

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    for gen in range(2, 14):
        pub.publish(text, meta={"cycle": gen})
        pub.publish_manifest(
            "serving", warmup.build_serving_section(8, [16, 64], gen))
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not bad, bad[:5]
    assert os.path.exists(warmup.manifest_path(d))
    assert len(publish.generation_paths(d)) <= 2


def test_healthz_warming_until_provider_flips():
    ready = threading.Event()
    srv = telemetry.start_http_server(0, health_provider=ready.is_set)
    try:
        url = "http://127.0.0.1:%d/healthz" % srv.port
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=10)
        assert ei.value.code == 503 and ei.value.read() == b"warming\n"
        ready.set()
        assert urllib.request.urlopen(url, timeout=10).read() == b"ok\n"
    finally:
        srv.stop()


def _serving_pub(tmp_path, n_feat=8):
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=0)
    pub.publish(_synth_model(n_feat=n_feat), meta={"cycle": 1})
    return d, pub


def test_prewarm_from_manifest_captures_buckets(tmp_path):
    d, pub = _serving_pub(tmp_path)
    pub.publish_manifest("serving",
                         warmup.build_serving_section(8, [16, 64], 1))
    base_ok = _warmup_count("serving", "manifest_ok")
    with ServingRuntime(publish_dir=d, params=dict(CPU),
                        poll_interval_s=0.05, batch_window_s=0.001) as rt:
        assert rt.ready
        assert rt.prewarm_events[0]["outcome"] == "manifest_ok"
        assert rt.prewarm_events[0]["buckets"] == [16, 64]
        assert _warmup_count("serving", "manifest_ok") == base_ok + 1
        # the 64-row bucket's program exists before the first request
        pred = rt._entries["default"].booster._dev_predictor
        before = pred.capture_count()
        rec = rt.predict(np.zeros((50, 8)))
        assert rec.served_by == "device" and pred.capture_count() == before


@pytest.mark.parametrize("manifest,outcome", [
    ("torn", "manifest_torn"), ("width", "shape_mismatch"),
    ("stale", "manifest_stale"), ("missing", "manifest_missing")])
def test_prewarm_degrades_and_serves(tmp_path, manifest, outcome):
    d, pub = _serving_pub(tmp_path)
    if manifest == "torn":
        with open(warmup.manifest_path(d), "w") as fh:
            fh.write("{torn")
    elif manifest == "width":
        pub.publish_manifest("serving",
                             warmup.build_serving_section(9, [16], 1))
    elif manifest == "stale":
        pub.publish_manifest("serving",
                             warmup.build_serving_section(9, [16], 7))
    base = _warmup_count("serving", outcome)
    with ServingRuntime(publish_dir=d, params=dict(CPU),
                        batch_window_s=0.001) as rt:
        assert rt.ready and rt.prewarm_events[0]["outcome"] == outcome
        assert rt.predict(np.zeros((3, 8))).generation == 1
    assert _warmup_count("serving", outcome) == base + 1


def test_stop_exports_observed_buckets(tmp_path, monkeypatch):
    """The export reads the buckets the program ledger saw captured at
    the predictor's site (on the card every new bucket is a capture;
    here the ledger is fed what a card run records)."""
    monkeypatch.setattr(graph_obs, "LEDGER", graph_obs.ProgramLedger())
    for rows in (16, 64):
        graph_obs.record_build(warmup.PREDICT_SITE, 0.01, graph_obs.signature(
            torch.zeros(rows, 8), torch.zeros(rows, 1), early_mode=None,
            early_freq=10))
    graph_obs.record_build(warmup.PREDICT_SITE, 0.01, graph_obs.signature(
        torch.zeros(128, 5), torch.zeros(128, 1)))          # another model
    assert warmup.serving_row_buckets(8) == [16, 64]
    d, _pub = _serving_pub(tmp_path)
    rt = ServingRuntime(publish_dir=d, params=dict(CPU),
                        batch_window_s=0.001)
    rt.start()
    rt.predict(np.zeros((50, 8)))
    rt.stop()
    sec, reason = warmup.read_manifest(d, "serving")
    assert reason == "ok" and sec["num_features"] == 8
    assert sec["row_buckets"] == [16, 64] and sec["generation"] == 1
    with ServingRuntime(publish_dir=d, params=dict(CPU),
                        batch_window_s=0.001) as rt2:
        assert rt2.prewarm_events[0]["outcome"] == "manifest_ok"
        assert rt2.prewarm_events[0]["buckets"] == [16, 64]


def test_record_prewarm_counts_every_outcome():
    base = _warmup_count("train_online", "error")
    warmup.record_prewarm("train_online", "error", 0.25)
    assert _warmup_count("train_online", "error") == base + 1


def test_trainer_exports_manifest_and_relaunch_prewarms(tmp_path):
    """Each cycle's publish carries the train_online section; a relaunch
    whose signature matches trains one throwaway iteration before its
    first slot (manifest_ok) and goes on to publish the same bytes."""
    import sys as _sys

    from lightgbm_tpu_torch.runtime.continuous import ContinuousTrainer
    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, 6))
    y = (X[:, 0] > 0).astype(np.float64)
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.7g")
    out = str(tmp_path / "m.txt")
    params = {"data": data, "output_model": out, "objective": "binary",
              "num_leaves": 7, "min_data_in_leaf": 5, "verbose": -1,
              "seed": 7, "online_rounds": 1, "online_interval": 0.2,
              "device_type": "cpu"}
    t1 = ContinuousTrainer(dict(params, online_cycles=1))
    t1.wd.stream = _sys.stderr
    assert t1.run() == 0
    sec, reason = warmup.read_manifest(out + ".pub", "train_online")
    assert reason == "ok"
    assert sec["params_sig"]["num_leaves"] == 7
    assert sec["params_sig"]["n_features"] == 6
    base_ok = _warmup_count("train_online", "manifest_ok")
    t2 = ContinuousTrainer(dict(params, online_cycles=2))
    t2.wd.stream = _sys.stderr
    assert t2.run() == 0
    assert _warmup_count("train_online", "manifest_ok") == base_ok + 1
    assert any(isinstance(s.get("prewarm"), dict)
               and s["prewarm"]["outcome"] == "manifest_ok"
               for s in t2.wd.stages)
    assert [g for g, _ in publish.generation_paths(out + ".pub")] == [2, 1]
