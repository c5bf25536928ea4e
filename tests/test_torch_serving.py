"""The port's serving runtime (lightgbm_tpu_torch/runtime/serving.py) on
the CPU (``device_type=cpu``), against the offline predictor of each
generation and against the JAX package's runtime: concurrent clients with
a hot swap and zero drops, multi-model tenancy, the breaker's host path
under ``die_at_predict`` and ``slow_predict`` and its recovery, the
admission sheds, a stopped runtime, ``submit_view``, the TCP front end,
one predictor driven from two threads, and `resolve_backend`, which
raises on a failed probe instead of landing on the CPU."""
import json
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.device_predictor import DevicePredictor
from lightgbm_tpu_torch.runtime import (graph_obs, publish, resilience,
                                        serving, telemetry, warmup)
from lightgbm_tpu_torch.runtime.serving import (ServeRejected,
                                                ServingRuntime,
                                                ServingServer)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CPU = {"device_type": "cpu"}
#: the hot-swap test's client threads: more than the cores
CLIENTS = (os.cpu_count() or 4) + 4


def _synth_model(n_trees=16, num_leaves=15, n_feat=6, seed=1):
    """A serving-shape ensemble written by the JAX package's bench helper
    (no training run)."""
    from bench import synth_serving_model
    return synth_serving_model(n_trees, num_leaves, n_feat,
                               seed=seed).save_model_to_string()


def _booster(text):
    return lt.Booster(params=dict(CPU), model_str=text)


def _runtime(**kw):
    kw.setdefault("params", dict(CPU))
    return ServingRuntime(**kw)


def _wait_for(cond, timeout=10.0):
    """Poll `cond` until it holds (a bounded wait on an observable
    state, not a fixed sleep)."""
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.01)
    return True


@pytest.fixture()
def clean_fault_env():
    old = os.environ.pop("LGBM_TPU_FAULT", None)
    yield
    if old is None:
        os.environ.pop("LGBM_TPU_FAULT", None)
    else:
        os.environ["LGBM_TPU_FAULT"] = old


def _host_batches():
    snap = telemetry.snapshot("t")
    return sum(e["value"] for e in snap["metrics"].get(
        "lgbm_serve_batches_total", {}).get("series", [])
        if e["labels"] == {"path": "host"})


def test_concurrent_clients_hot_swap_zero_drops(tmp_path):
    pub = publish.ModelPublisher(str(tmp_path / "pub"), keep_last=0)
    t1, t2 = _synth_model(seed=1), _synth_model(seed=2, n_trees=20)
    pub.publish(t1, meta={"cycle": 1})
    probe = np.random.default_rng(0).standard_normal((48, 6))
    refs = {1: _booster(t1).predict(probe, device=True),
            2: _booster(t2).predict(probe, device=True)}
    outcomes = {"completed": 0, "rejected": 0}
    mismatches, errors, gens = [], [], []
    lock = threading.Lock()
    with _runtime(publish_dir=str(tmp_path / "pub"), poll_interval_s=0.02,
                  batch_window_s=0.002) as rt:
        swapped = threading.Event()

        def client(seed):
            crng = np.random.default_rng(seed)
            for k in range(30):
                idx = crng.integers(0, len(probe), size=int(
                    crng.integers(1, 9)))
                try:
                    rec = rt.predict(probe[idx])
                except ServeRejected:
                    with lock:
                        outcomes["rejected"] += 1
                    continue
                except BaseException as e:   # noqa: BLE001 — ledger
                    errors.append(repr(e))
                    continue
                with lock:
                    outcomes["completed"] += 1
                    gens.append(rec.generation)
                if rec.served_by != "device" or not np.array_equal(
                        rec.values, refs[rec.generation][idx]):
                    mismatches.append((rec.generation, rec.served_by))
                if k == 10 and seed == 100:
                    pub.publish(t2, meta={"cycle": 2})
                    swapped.set()
                if k > 10:
                    swapped.wait(10)

        # more clients than cores, and a short switch interval: a lost
        # update in admission or a torn response shows as a mismatch
        threads = [threading.Thread(target=client, args=(100 + i,))
                   for i in range(CLIENTS)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert _wait_for(lambda: rt.generation() == 2)
        rec = rt.predict(probe[:5])
        assert rec.generation == 2 and np.array_equal(rec.values,
                                                      refs[2][:5])
        st = rt.stats()
    assert errors == [] and mismatches == []
    assert outcomes["completed"] == CLIENTS * 30 - outcomes["rejected"]
    assert st["admitted"] == st["completed"] \
        + sum(st["rejected"].values()) - st["rejected"].get("shutdown", 0)
    assert set(gens) <= {1, 2} and 2 in gens
    assert st["swaps"] >= 2 and st["batches_host"] == 0
    assert st["prewarm_failures"] == 0 and st["degradations"] == 0


def test_multi_model_tenancy(tmp_path):
    pa = publish.ModelPublisher(str(tmp_path / "a"), keep_last=0)
    pb = publish.ModelPublisher(str(tmp_path / "b"), keep_last=0)
    ta, tb = _synth_model(seed=5), _synth_model(seed=6, n_trees=20)
    pa.publish(ta, meta={})
    pb.publish(tb, meta={})
    probe = np.random.default_rng(2).standard_normal((16, 6))
    with _runtime(models={"a": str(tmp_path / "a"),
                          "b": str(tmp_path / "b")},
                  poll_interval_s=0.05) as rt:
        got_a = rt.predict(probe, model_id="a")
        got_b = rt.predict(probe, model_id="b")
        assert np.array_equal(got_a.values,
                              _booster(ta).predict(probe, device=True))
        assert np.array_equal(got_b.values,
                              _booster(tb).predict(probe, device=True))
        with pytest.raises(ServeRejected) as ei:
            rt.predict(probe, model_id="nope", attempts=1)
        assert ei.value.reason == "no_model" and ei.value.retryable
        assert rt.stats()["generations"] == {"a": 1, "b": 1}


def test_die_at_predict_to_host_and_back(tmp_path, clean_fault_env):
    text = _synth_model(seed=3)
    probe = np.random.default_rng(1).standard_normal((8, 6))
    ref_host = _booster(text).predict(probe)
    ref_dev = _booster(text).predict(probe, device=True)
    report = str(tmp_path / "trail.json")
    host0 = _host_batches()
    with _runtime(model_str=text, breaker_cooldown_s=0.05,
                  predict_deadline_s=5.0, batch_window_s=0.0,
                  report_path=report) as rt:
        assert rt.predict(probe).served_by == "device"
        os.environ["LGBM_TPU_FAULT"] = "die_at_predict:1"
        rec = rt.predict(probe)
        assert rec.served_by == "host"
        assert np.array_equal(rec.values, ref_host)
        assert rt.degradation_events[0]["event"] == "serving_degradation"
        assert "DevicePredictFault" in rt.degradation_events[0]["reason"]
        del os.environ["LGBM_TPU_FAULT"]
        open_until = rt.stats()["breaker"]["open_until"]
        assert _wait_for(lambda: time.monotonic() > open_until)
        rec = rt.predict(probe)
        assert rec.served_by == "device"
        assert np.array_equal(rec.values, ref_dev)
        assert rt.recovery_events[0]["event"] == "serving_recovery"
        st = rt.stats()
    assert st["batches_host"] == 1 and st["degradations"] == 1
    assert st["recoveries"] == 1
    assert _host_batches() - host0 == 1
    trail = json.load(open(report))
    assert any("degradation_event" in s for s in trail["stages"])
    assert any("recovery_event" in s for s in trail["stages"])


def test_slow_predict_times_out_to_host_and_back(clean_fault_env):
    """A hung device batch is abandoned at the predict deadline and
    re-served from the host; the breaker probes again only once the
    abandoned call has left the predictor."""
    text = _synth_model(seed=4)
    probe = np.random.default_rng(3).standard_normal((6, 6))
    ref_host = _booster(text).predict(probe)
    ref_dev = _booster(text).predict(probe, device=True)
    with _runtime(model_str=text, breaker_cooldown_s=0.05,
                  predict_deadline_s=0.3, batch_window_s=0.0) as rt:
        assert rt.predict(probe).served_by == "device"
        os.environ["LGBM_TPU_FAULT"] = "slow_predict:1.0"
        t0 = time.monotonic()
        rec = rt.predict(probe)
        assert time.monotonic() - t0 < 0.9
        assert rec.served_by == "host"
        assert np.array_equal(rec.values, ref_host)
        assert any(s.get("status") == "timeout" for s in rt.wd.stages)
        assert rt.wd.tracebacks is not None
        del os.environ["LGBM_TPU_FAULT"]
        # while the abandoned call runs, the breaker does not probe
        assert rt.stats()["abandoned_running"] == 1
        assert rt.predict(probe).served_by == "host"
        assert _wait_for(lambda: rt.stats()["abandoned_running"] == 0)
        rec = rt.predict(probe)
        assert rec.served_by == "device"
        assert np.array_equal(rec.values, ref_dev)
        st = rt.stats()
    assert st["abandoned"] == 1 and st["degradations"] == 1
    assert st["recoveries"] == 1 and st["batches_host"] == 2


def test_queue_full_and_expired_deadline_shed(clean_fault_env):
    text = _synth_model(seed=7)
    probe = np.random.default_rng(4).standard_normal((4, 6))
    os.environ["LGBM_TPU_FAULT"] = "slow_predict:0.5"
    with _runtime(model_str=text, max_queue=2, predict_deadline_s=0.2,
                  breaker_cooldown_s=30.0, batch_window_s=0.0) as rt:
        reqs, rejected = [], []
        for _ in range(8):
            try:
                reqs.append(rt.submit(probe, deadline_s=20.0))
            except ServeRejected as e:
                rejected.append(e)
        assert rejected, "the bounded queue never shed"
        for e in rejected:
            d = e.to_dict()
            assert e.retryable and d["error"] == "rejected"
            assert d["reason"] == "queue_full"
            assert isinstance(d["queue_depth"], int) and "wallclock" in d
            assert d["priority"] == 0 and d["retry_after_s"] > 0
        # a request whose deadline passes before its batch forms is shed
        assert _wait_for(lambda: rt.stats()["queue_depth"] == 0)
        blocker = rt.submit(probe, deadline_s=20.0)
        assert _wait_for(lambda: rt.stats()["queue_depth"] == 0)
        doomed = rt.submit(probe, deadline_s=0.0)
        with pytest.raises(ServeRejected) as ei:
            doomed.wait(timeout=10)
        assert ei.value.reason == "deadline_exceeded" and ei.value.retryable
        del os.environ["LGBM_TPU_FAULT"]
        for r in reqs + [blocker]:
            assert r.wait(timeout=30).values.shape[0] == 4
        assert rt.stats()["rejected"]["deadline_exceeded"] >= 1


def test_stopped_runtime_refuses():
    rt = _runtime(model_str=_synth_model(seed=9)).start()
    rt.stop()
    with pytest.raises(ServeRejected) as ei:
        rt.submit(np.zeros(6))
    assert ei.value.reason == "shutdown" and ei.value.retryable is False
    with pytest.raises(ServeRejected):
        _runtime(model_str=_synth_model(seed=9)).submit(np.zeros(6))


def test_submit_view_serves_f32_without_conversion():
    text = _synth_model(seed=15)
    probe = np.random.default_rng(10).standard_normal((4, 6)) \
        .astype(np.float32)
    with _runtime(model_str=text, batch_window_s=0.0) as rt:
        ref = rt.predict(np.asarray(probe, np.float64)).values
        req = rt.submit_view(probe)
        assert req.X is probe                 # queued as is, no copy
        rec = req.wait(timeout=30)
        # the device path computes in f32: the f32 view is the same input
        assert np.array_equal(rec.values, ref)

        class _Req:
            def __init__(self, X):
                self.X, self.n_rows = X, X.shape[0]
        b1 = [_Req(probe[:2]), _Req(probe[2:])]
        g1, g2 = rt._gather_batch(b1), rt._gather_batch(b1)
        assert (g1.base if g1.base is not None else g1) is \
            (g2.base if g2.base is not None else g2)
        assert g1.dtype == np.float32


def test_tcp_roundtrip():
    text = _synth_model(seed=12)
    probe = np.random.default_rng(8).standard_normal((3, 6))
    with _runtime(model_str=text, batch_window_s=0.0) as rt:
        srv = ServingServer(rt)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10) as s:
                f = s.makefile("rw")
                f.write(json.dumps({"features": probe.tolist()}) + "\n")
                f.flush()
                resp = json.loads(f.readline())
                assert resp["generation"] == 0
                assert resp["served_by"] == "device"
                assert np.array_equal(
                    resp["values"], _booster(text).predict(probe,
                                                           device=True))
                assert set(resp["stages"]) == {
                    "queue_wait_s", "batch_gather_s", "device_s", "drain_s"}
                f.write(json.dumps({"cmd": "stats"}) + "\n")
                f.flush()
                st = json.loads(f.readline())
                assert st["completed"] >= 1 and "breaker" in st
                f.write("not json\n")
                f.flush()
                assert json.loads(f.readline())["error"] == "bad_request"
        finally:
            srv.shutdown()
            srv.server_close()


def test_one_predictor_two_threads_serialize(monkeypatch):
    """A call held inside the predictor (the slow_predict seam, here a
    hook that waits on an event) keeps a second caller out until it
    leaves: the two never share the staging buffers mid-call, and both
    answers are the predictor's own."""
    bst = _booster(_synth_model(seed=10))
    dp = DevicePredictor(bst._model, batch_rows=16, device="cpu")
    rng = np.random.default_rng(0)
    Xa, Xb = rng.standard_normal((64, 6)), rng.standard_normal((40, 6))
    want_a, want_b = dp.predict_raw(Xa), dp.predict_raw(Xb)
    inside, release = threading.Event(), threading.Event()
    held = threading.current_thread()
    seen = []

    def seam():
        me = threading.current_thread()
        seen.append(me.name)
        if me.name == "caller-a" and len(seen) == 2:
            inside.set()
            release.wait(10)

    monkeypatch.setattr(resilience, "maybe_fail_predict", seam)
    out = {}
    ta = threading.Thread(name="caller-a",
                          target=lambda: out.update(a=dp.predict_raw(Xa)))
    tb = threading.Thread(name="caller-b",
                          target=lambda: out.update(b=dp.predict_raw(Xb)))
    ta.start()
    assert inside.wait(10)
    tb.start()
    tb.join(0.3)
    # b waits on the lock a holds: it has not reached a micro-batch
    assert tb.is_alive() and "caller-b" not in seen
    release.set()
    ta.join(10)
    tb.join(10)
    assert held is threading.current_thread()
    assert seen == ["caller-a"] * 4 + ["caller-b"] * 3
    assert np.array_equal(out["a"], want_a)
    assert np.array_equal(out["b"], want_b)


def test_resolve_backend_raises_and_never_lands_on_cpu(monkeypatch):
    # a real probe child with an unknown platform
    monkeypatch.setenv("LGBM_TPU_FAULT", "bogus_platform")
    with pytest.raises(resilience.BackendUnavailable) as ei:
        resilience.resolve_backend(attempts=1, deadline=60.0)
    ev = ei.value.event
    assert ev["event"] == "platform_degradation" and ev["to"] is None
    assert ev["from"] == "bogus" and ev["attempts"] == 1
    assert ev["probes"][0]["ok"] is False and "tail" not in ev["probes"][0]
    monkeypatch.delenv("LGBM_TPU_FAULT")
    # the runtime's start probes the card and raises the same way,
    # leaving nothing running and no platform setting behind
    calls = []

    def failing_probe(platform=None, deadline=20.0):
        calls.append(platform)
        return {"platform": platform, "ok": False, "backend": None,
                "reason": "init failed (rc=1)", "rc": 1}

    monkeypatch.setattr(resilience, "probe_platform", failing_probe)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    env_before = dict(os.environ)
    rt = ServingRuntime(model_str=_synth_model(seed=9), params={},
                        probe_platform_on_start=True)
    with pytest.raises(resilience.BackendUnavailable):
        rt.start()
    assert calls == ["cuda", "cuda"]
    assert rt.start_degradation["to"] is None and not rt.ready
    assert dict(os.environ) == env_before
    with pytest.raises(ServeRejected):
        rt.submit(np.zeros(6))
    # asked for the CPU, the probe is the CPU's
    monkeypatch.setattr(resilience, "probe_platform", lambda platform=None,
                        deadline=20.0: {"platform": platform, "ok": True,
                                        "backend": platform})
    assert resilience.resolve_backend("cpu")[0] == "cpu"


def test_prewarm_failures_are_counted_and_kernel_faults_raise(
        tmp_path, monkeypatch):
    """At start-up a device failure that is not an injected fault raises
    out of start(); after readiness a hot swap's failed prewarm is
    counted and the swap goes on."""
    text = _synth_model(seed=21)
    real = lt.Booster.predict

    def broken(self, data, *a, **kw):
        if kw.get("device"):
            raise RuntimeError("CUDA graph capture failed")
        return real(self, data, *a, **kw)

    monkeypatch.setattr(lt.Booster, "predict", broken)
    rt = _runtime(model_str=text)
    with pytest.raises(RuntimeError, match="capture failed"):
        rt.start()
    assert rt.stats()["prewarm_failures"] == 1 and not rt.ready
    monkeypatch.setattr(lt.Booster, "predict", real)
    pub = publish.ModelPublisher(str(tmp_path / "pub"), keep_last=0)
    pub.publish(text)
    with _runtime(publish_dir=str(tmp_path / "pub"),
                  poll_interval_s=0.02) as rt:
        monkeypatch.setattr(lt.Booster, "predict", broken)
        pub.publish(_synth_model(seed=22))
        assert _wait_for(lambda: rt.generation() == 2)
        assert rt.stats()["prewarm_failures"] == 1
        monkeypatch.setattr(lt.Booster, "predict", real)
        probe = np.zeros((2, 6))
        assert rt.predict(probe).served_by == "device"


def test_manifest_prewarm_and_export(tmp_path, monkeypatch):
    """A serving section's buckets are prewarmed before readiness (each
    a program of the predictor), bounded by MAX_PREWARM_BUCKETS and
    clamped to twice max_batch_rows; stop exports the buckets the
    program ledger saw captured."""
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=0)
    pub.publish(_synth_model(seed=30))
    buckets = [16 << i for i in range(10)]             # 16 .. 8192
    pub.publish_manifest("serving", warmup.build_serving_section(
        6, buckets + [1 << 20], generation=1))
    with _runtime(publish_dir=d, max_batch_rows=4096) as rt:
        ev = rt.prewarm_events[0]
        assert ev["outcome"] == "manifest_ok"
        assert ev["buckets"] == buckets
        pred = rt._entries["default"].booster._dev_predictor
        assert pred.capture_count() == len(buckets)
    # the captures at the predictor's site are the card's; here the
    # ledger holds what a card run would have recorded
    monkeypatch.setattr(warmup, "serving_row_buckets",
                        lambda num_features=None: [16, 64])
    with _runtime(publish_dir=d) as rt:
        pass
    sec, reason = warmup.read_manifest(d, "serving")
    assert reason == "ok" and sec["row_buckets"] == [16, 64]


def test_jax_written_model_served_by_both_runtimes():
    """One JAX-written model through the JAX runtime and the port's: the
    responses agree to the device predictor's rtol 1e-5."""
    from lightgbm_tpu.runtime.serving import ServingRuntime as JRuntime
    text = _synth_model(n_trees=24, num_leaves=31, seed=40)
    probe = np.random.default_rng(41).standard_normal((200, 6))
    with JRuntime(model_str=text, batch_window_s=0.0) as jrt:
        want = jrt.predict(probe, deadline_s=60.0)
    with _runtime(model_str=text, batch_window_s=0.0) as rt:
        got = rt.predict(probe)
    assert got.served_by == want.served_by == "device"
    assert got.generation == want.generation == 0
    np.testing.assert_allclose(got.values, want.values, rtol=1e-5,
                               atol=1e-7)


def test_compiled_stamp_reads_the_predictor_site(monkeypatch):
    """A batch is stamped `compiled` when the program ledger's builds at
    the predictor's site moved during it."""
    text = _synth_model(seed=50)
    with _runtime(model_str=text, batch_window_s=0.0) as rt:
        assert rt.predict(np.zeros((3, 6))).compiled is False
        real = serving.graph_obs.total_compiles
        ticks = iter(range(100))
        monkeypatch.setattr(serving.graph_obs, "total_compiles",
                            lambda site=None: next(ticks))
        assert rt.predict(np.zeros((3, 6))).compiled is True
        monkeypatch.setattr(serving.graph_obs, "total_compiles", real)
    assert graph_obs.total_compiles("no.such.site") == 0
