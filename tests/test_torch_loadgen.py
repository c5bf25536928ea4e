"""The port's load generator (lightgbm_tpu_torch/runtime/loadgen.py) and
its serving runtime's admission knobs on the CPU (``device_type=cpu``),
mirroring the JAX package's tests/test_prodsim.py: seeded Poisson
arrivals over the three traffic shapes (array for array the JAX
package's), the open loop against a live runtime with every response
byte-verified, the verifier's wrong-generation and mismatch verdicts;
the priority reservations, the per-tenant quota, load-shed mode, the
policy thread closing the loop under pressure, and the staleness
histogram.  (The JAX package's two end-to-end production-sim tests drive
a script outside the package and have no counterpart here.)
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu.runtime import loadgen as jloadgen
from lightgbm_tpu_torch.runtime import loadgen as tloadgen
from lightgbm_tpu_torch.runtime import publish, telemetry
from lightgbm_tpu_torch.runtime import serving as _serving
from lightgbm_tpu_torch.runtime.loadgen import (LoadGenerator,
                                                RequestClass,
                                                ResponseVerifier,
                                                TrafficShape,
                                                poisson_arrivals)
from lightgbm_tpu_torch.runtime.policy import AutoscaleShedPolicy
from lightgbm_tpu_torch.runtime.serving import ServeRejected

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CPU = {"device_type": "cpu"}


def ServingRuntime(**kw):
    """The port's runtime on the CPU."""
    kw.setdefault("params", dict(CPU))
    return _serving.ServingRuntime(**kw)


def _synth_model(n_trees=16, num_leaves=15, n_feat=6, seed=1):
    from bench import synth_serving_model
    return synth_serving_model(n_trees, num_leaves, n_feat,
                               seed=seed).save_model_to_string()


@pytest.fixture()
def clean_fault_env():
    old = os.environ.pop("LGBM_TPU_FAULT", None)
    yield
    if old is None:
        os.environ.pop("LGBM_TPU_FAULT", None)
    else:
        os.environ["LGBM_TPU_FAULT"] = old


def _shapes(mod):
    return [mod.TrafficShape.diurnal(10, 200, period_s=8.0),
            mod.TrafficShape.bursty(5, 80, period_s=2.0, burst_len_s=0.5),
            mod.TrafficShape.step([(1.0, 5), (2.0, 100), (1.0, 30)])]


@pytest.mark.parametrize("k,seed", [(0, 42), (1, 7), (2, 2026)])
def test_poisson_arrivals_equal_the_jax_packages(k, seed):
    """Same shape, duration and seed: the port's arrivals are the JAX
    package's, array for array (both draw from np.random.default_rng)."""
    mine = poisson_arrivals(_shapes(tloadgen)[k], 8.0, seed=seed)
    theirs = jloadgen.poisson_arrivals(_shapes(jloadgen)[k], 8.0,
                                       seed=seed)
    assert mine.size > 0
    assert np.array_equal(mine, theirs)


def test_poisson_arrivals_deterministic_and_follow_the_shape():
    shape = TrafficShape.diurnal(10, 200, period_s=8.0)
    a = poisson_arrivals(shape, 8.0, seed=42)
    b = poisson_arrivals(shape, 8.0, seed=42)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, poisson_arrivals(shape, 8.0, seed=43))
    # diurnal starts at the trough: the middle half must be denser
    trough = np.sum(a < 2.0) + np.sum(a >= 6.0)
    peak = np.sum((a >= 2.0) & (a < 6.0))
    assert peak > trough
    # step shape holds its levels
    st = TrafficShape.step([(1.0, 5), (1.0, 100)])
    assert st.rate(0.5) == 5 and st.rate(1.5) == 100 and st.rate(9.0) == 100
    burst = TrafficShape.bursty(5, 80, period_s=2.0, burst_len_s=0.5)
    assert burst.rate(0.2) == 80 and burst.rate(1.0) == 5


def test_loadgen_open_loop_against_live_runtime_verifies_bytes(tmp_path):
    """End-to-end loadgen pin: every completed response byte-verified
    against the offline predictor for its reported generation, offered
    counts land in the registry."""
    telemetry.reset()
    text = _synth_model(seed=3)
    pub_dir = str(tmp_path / "pub")
    publish.ModelPublisher(pub_dir, keep_last=0).publish(text, generation=1)
    probe = np.random.default_rng(2).standard_normal((32, 6))
    with ServingRuntime(publish_dir=pub_dir, max_queue=128,
                        poll_interval_s=0.05) as rt:
        deadline = time.monotonic() + 20
        while rt.generation() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        gen = LoadGenerator(
            rt, [RequestClass("gold", 0, rows=2),
                 RequestClass("bulk", 2, weight=2.0, rows=4)],
            TrafficShape.diurnal(20, 60, period_s=1.5), 1.5, probe, seed=9,
            verifier=ResponseVerifier(probe, pub_dir=pub_dir,
                                      params={"verbose": -1, **CPU}))
        led = gen.run()
    assert led["offered_total"] > 0
    # the open loop walked the seeded arrivals, every one offered
    assert np.array_equal(gen.arrivals, poisson_arrivals(
        TrafficShape.diurnal(20, 60, period_s=1.5), 1.5, seed=9))
    assert led["offered_total"] == len(gen.arrivals)
    assert led["verification"].get("ok", 0) == \
        sum(c["completed"] for c in led["classes"].values()) > 0
    assert led["verification"].get("mismatch", 0) == 0
    assert led["verification"].get("wrong_generation", 0) == 0
    assert led["non_machine_readable_rejections"] == 0
    offered = telemetry.counter("lgbm_loadgen_offered_total")
    assert offered.value(cls="gold") == led["classes"]["gold"]["offered"]


def test_verifier_flags_a_wrong_generation(tmp_path):
    """A response naming a generation that was never validly published
    is a wrong_generation verdict, and corrupted values are a
    mismatch."""
    text = _synth_model(seed=4)
    pub_dir = str(tmp_path / "pub")
    publish.ModelPublisher(pub_dir, keep_last=0).publish(text, generation=1)
    probe = np.random.default_rng(3).standard_normal((8, 6))
    ver = ResponseVerifier(probe, pub_dir=pub_dir,
                           params={"verbose": -1, **CPU})

    class FakeResult:
        def __init__(self, gen, served_by, values):
            self.generation = gen
            self.served_by = served_by
            self.values = values

    refs = ver.refs(1)
    idx = np.asarray([1, 3])
    ok = FakeResult(1, "host", refs["host"][idx])
    assert ver.verify(ok, idx) == "ok"
    assert ver.verify(FakeResult(99, "host", refs["host"][idx]),
                      idx) == "wrong_generation"
    corrupted = FakeResult(1, "host", refs["host"][idx] + 1e-9)
    assert ver.verify(corrupted, idx) == "mismatch"


# -- priority classes, quotas and shed mode on the serving runtime ----------

def test_priority_reservation_sheds_low_class_first(clean_fault_env):
    """Under queue pressure the lowest class hits its reservation and
    sheds (machine-readable WITH its class) while the highest class
    still admits — and with priority_levels=1 the same flood fills the
    whole queue: the knob changes the outcome."""
    text = _synth_model(seed=11)
    probe = np.random.default_rng(6).standard_normal((2, 6))
    os.environ["LGBM_TPU_FAULT"] = "slow_predict:0.8"
    with ServingRuntime(model_str=text, max_queue=6, priority_levels=3,
                        predict_deadline_s=0.3, breaker_cooldown_s=30.0,
                        batch_window_s=0.0) as rt:
        blocker = rt.submit(probe, deadline_s=30.0)
        time.sleep(0.1)                   # blocker batch is in flight
        admitted_low, rejections = [], []
        for _ in range(6):
            try:
                admitted_low.append(rt.submit(probe, deadline_s=30.0,
                                              priority=2))
            except ServeRejected as e:
                rejections.append(e)
        # class p2's reservation is 6*(3-2)/3 = 2 slots
        assert len(admitted_low) == 2 and len(rejections) == 4
        for e in rejections:
            d = e.to_dict()
            assert d["reason"] == "queue_full" and d["retryable"] is True
            assert d["priority"] == 2
        # the highest class still has queue room at this depth
        high = rt.submit(probe, deadline_s=30.0, priority=0)
        del os.environ["LGBM_TPU_FAULT"]
        for r in [blocker, high] + admitted_low:
            r.wait(timeout=30)            # zero drops for admitted work
        cls = telemetry.counter("lgbm_serve_class_requests_total")
        assert cls.value(cls="p2", outcome="queue_full") >= 4

    # same flood, single class: every submit admits (knob flips outcome)
    os.environ["LGBM_TPU_FAULT"] = "slow_predict:0.8"
    with ServingRuntime(model_str=text, max_queue=6, priority_levels=1,
                        predict_deadline_s=0.3, breaker_cooldown_s=30.0,
                        batch_window_s=0.0) as rt:
        blocker = rt.submit(probe, deadline_s=30.0)
        time.sleep(0.1)
        admitted = []
        for _ in range(6):
            admitted.append(rt.submit(probe, deadline_s=30.0, priority=2))
        assert len(admitted) == 6
        del os.environ["LGBM_TPU_FAULT"]
        for r in [blocker] + admitted:
            r.wait(timeout=30)


def test_quota_bounds_a_hot_tenant(tmp_path, clean_fault_env):
    """A hot tenant past its queue share is shed `quota_exceeded`
    (retryable, machine-readable) while the cold tenant still admits;
    without the quota the hot tenant fills the whole queue."""
    hot_dir, cold_dir = str(tmp_path / "hot"), str(tmp_path / "cold")
    publish.ModelPublisher(hot_dir, keep_last=0).publish(
        _synth_model(seed=12), generation=1)
    publish.ModelPublisher(cold_dir, keep_last=0).publish(
        _synth_model(seed=13), generation=1)
    probe = np.random.default_rng(7).standard_normal((1, 6))

    def flood(rt, model_id, n):
        admitted, rejections = [], []
        for _ in range(n):
            try:
                admitted.append(rt.submit(probe, deadline_s=30.0,
                                          model_id=model_id))
            except ServeRejected as e:
                rejections.append(e)
        return admitted, rejections

    os.environ["LGBM_TPU_FAULT"] = "slow_predict:0.8"
    with ServingRuntime(models={"hot": hot_dir, "cold": cold_dir},
                        quotas={"hot": 0.5}, max_queue=8,
                        predict_deadline_s=0.3, breaker_cooldown_s=30.0,
                        poll_interval_s=0.05, batch_window_s=0.0) as rt:
        deadline = time.monotonic() + 20
        while (rt.generation("hot") is None
               or rt.generation("cold") is None) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        blocker = rt.submit(probe, deadline_s=30.0, model_id="hot")
        time.sleep(0.1)
        admitted, rejections = flood(rt, "hot", 8)
        assert len(admitted) == 4         # 0.5 * max_queue
        assert rejections and all(e.reason == "quota_exceeded"
                                  and e.retryable for e in rejections)
        # the cold tenant is NOT starved
        cold_req = rt.submit(probe, deadline_s=30.0, model_id="cold")
        del os.environ["LGBM_TPU_FAULT"]
        for r in [blocker, cold_req] + admitted:
            r.wait(timeout=30)

    os.environ["LGBM_TPU_FAULT"] = "slow_predict:0.8"
    with ServingRuntime(models={"hot": hot_dir, "cold": cold_dir},
                        max_queue=8, predict_deadline_s=0.3,
                        breaker_cooldown_s=30.0, poll_interval_s=0.05,
                        batch_window_s=0.0) as rt:
        deadline = time.monotonic() + 20
        while rt.generation("hot") is None \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        blocker = rt.submit(probe, deadline_s=30.0, model_id="hot")
        time.sleep(0.1)
        admitted, rejections = flood(rt, "hot", 8)
        assert len(admitted) > 4          # no quota: hot hogs the queue
        del os.environ["LGBM_TPU_FAULT"]
        for r in [blocker] + admitted:
            r.wait(timeout=30)


def test_load_shed_mode_rejects_lowest_class_only():
    """With the policy latch on, the lowest class is shed at admission
    (`load_shed`, retryable, class-tagged); higher classes admit."""
    text = _synth_model(seed=14)
    probe = np.random.default_rng(8).standard_normal((1, 6))
    with ServingRuntime(model_str=text, max_queue=16,
                        priority_levels=3) as rt:
        with rt._cond:
            rt._shed_low = True
        with pytest.raises(ServeRejected) as ei:
            rt.submit(probe, priority=2)
        d = ei.value.to_dict()
        assert d["reason"] == "load_shed" and d["retryable"] is True
        assert d["priority"] == 2
        rt.submit(probe, priority=1).wait(timeout=30)
        with rt._cond:
            rt._shed_low = False
        rt.submit(probe, priority=2).wait(timeout=30)


def test_policy_thread_closes_the_loop_under_pressure(clean_fault_env):
    """Integration: a stalled device path + flood drives queue depth
    over the watermark; the policy thread widens the window, latches
    shed, and the lowest class starts shedding `load_shed`."""
    text = _synth_model(seed=15)
    probe = np.random.default_rng(9).standard_normal((1, 6))
    pol = AutoscaleShedPolicy(high_watermark=0.5, low_watermark=0.1,
                              patience=2, interval_s=0.02,
                              min_window_s=0.002, max_window_s=0.016)
    os.environ["LGBM_TPU_FAULT"] = "slow_predict:0.8"
    with ServingRuntime(model_str=text, max_queue=8, priority_levels=3,
                        predict_deadline_s=0.3, breaker_cooldown_s=30.0,
                        batch_window_s=0.002, policy=pol) as rt:
        pending = [rt.submit(probe, deadline_s=30.0, priority=0)]
        time.sleep(0.1)
        for _ in range(6):      # p0 holds the full queue: depth > watermark
            pending.append(rt.submit(probe, deadline_s=30.0, priority=0))
        deadline = time.monotonic() + 10
        while not pol.shed_active and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pol.shed_active, "policy never latched shed"
        assert rt.batch_window_s > 0.002
        with pytest.raises(ServeRejected) as ei:
            rt.submit(probe, priority=2)
        assert ei.value.reason == "load_shed"
        assert any(d["action"] == "shed_on" for d in pol.decisions)
        del os.environ["LGBM_TPU_FAULT"]
        for r in pending:
            r.wait(timeout=30)
        st = rt.stats()
        assert st["policy"]["decisions"] >= 2


def test_staleness_histogram_records_serving_generation_age(tmp_path):
    telemetry.reset()
    pub_dir = str(tmp_path / "pub")
    publish.ModelPublisher(pub_dir, keep_last=0).publish(
        _synth_model(seed=16), generation=1)
    probe = np.random.default_rng(10).standard_normal((2, 6))
    with ServingRuntime(publish_dir=pub_dir, poll_interval_s=0.05) as rt:
        deadline = time.monotonic() + 20
        while rt.generation() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        rt.predict(probe)
    st = telemetry.histogram("lgbm_serve_staleness_seconds").state()
    assert st["count"] >= 1
    # published moments ago: the recorded staleness is small and sane
    assert 0.0 <= st["sum"] / st["count"] < 60.0
