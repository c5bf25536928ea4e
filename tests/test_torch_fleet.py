"""The port's serving fleet (lightgbm_tpu_torch/runtime/fleet.py) on the
CPU (``device_type=cpu`` in every replica spec), mirroring the JAX
package's tests/test_fleet.py: bounded residency never evicts a model
with queued requests; ``die_at_spawn`` kills a replica after its prewarm
and before it publishes an endpoint; the controller spawns two replicas
(the second spawn dies under ``die_at_spawn:2`` and is relaunched as the
third), `FleetClient` serves byte-verified answers over the wire and
over the shared-memory ring (the JAX package's offline predict within
rtol 1e-5), and a graceful stop drains every live replica to exit 0.
A replica's start-up runs no nvcc (a stand-in nvcc on its PATH leaves
no mark) and builds or loads no kernel.  A replica whose card does not
come up exits with `BACKEND_UNAVAILABLE_EXIT` before it publishes an
endpoint, and the controller backs its relaunch off."""
import json
import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.runtime import fleet, publish
from lightgbm_tpu_torch.runtime.policy import FleetScalePolicy
from lightgbm_tpu_torch.runtime.serving import ServingRuntime

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CPU = {"device_type": "cpu"}


def _synth_model(seed=1):
    from bench import synth_serving_model
    return synth_serving_model(12, 15, 6, seed=seed).save_model_to_string()


def _published(tmp_path, name="pub", seed=1):
    d = str(tmp_path / name)
    text = _synth_model(seed=seed)
    publish.ModelPublisher(d).publish(text)
    return d, text


def _fake_nvcc(tmp_path):
    """A directory holding an `nvcc` that leaves a mark when run."""
    bindir = tmp_path / "fakebin"
    bindir.mkdir()
    mark = tmp_path / "nvcc-ran"
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\ntouch %s\nexit 1\n" % mark)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(bindir), mark


def _replica_env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.pop("LGBM_TPU_FAULT", None)
    env.update(extra)
    return env


def test_lru_never_evicts_model_with_queued_requests(tmp_path):
    """The LRU candidate set excludes any model with queued or in-flight
    requests; with every resident model busy the page-in defers."""
    d1, _ = _published(tmp_path, "m1", seed=1)
    d2, _ = _published(tmp_path, "m2", seed=2)
    with ServingRuntime(models={"m1": d1, "m2": d2}, max_resident=2,
                        poll_interval_s=0.05, params=dict(CPU)) as rt:
        rt._wanted["m1"] = time.monotonic()
        rt._wanted["m2"] = time.monotonic()
        deadline = time.monotonic() + 20
        while set(rt._entries) != {"m1", "m2"}:
            assert time.monotonic() < deadline, "models never loaded"
            time.sleep(0.05)
        with rt._cond:
            rt._queued_by_model["m1"] += 1
        rt._lru["m1"] = 0.0
        rt._lru["m2"] = time.monotonic()
        assert rt._evict_lru("m3") is True
        assert "m1" in rt._entries and "m2" not in rt._entries
        assert rt._evict_lru("m2") is False
        assert "m1" in rt._entries
        events = [e["event"] for e in rt.residency_events]
        assert "defer" in events and events.count("evict") == 1
        with rt._cond:
            rt._queued_by_model["m1"] -= 1


def _run_replica(tmp_path, spec, **env):
    spec_path = str(tmp_path / "replica.json")
    ep_path = str(tmp_path / "replica.endpoint.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    p = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.runtime.fleet",
         "--replica", spec_path, "--endpoint", ep_path],
        env=_replica_env(**env), timeout=180, capture_output=True,
        text=True)
    return p, ep_path


def test_die_at_spawn_fault_exits_before_ready(tmp_path):
    """`die_at_spawn:1` with spawn ordinal 1: `python -m
    lightgbm_tpu_torch.runtime.fleet --replica` prewarms and exits 137
    without publishing its endpoint, and ran no nvcc."""
    d, _ = _published(tmp_path)
    bindir, mark = _fake_nvcc(tmp_path)
    p, ep_path = _run_replica(
        tmp_path, {"models": {"default": d}, "shed_policy": False,
                   "batch_window_s": 0.001, "params": dict(CPU)},
        LGBM_TPU_FAULT="die_at_spawn:1", LGBM_TPU_SPAWN_ORDINAL="1",
        PATH=bindir + os.pathsep + os.environ.get("PATH", ""))
    assert p.returncode == 137, p.stderr[-800:]
    assert "FAULT die_at_spawn" in p.stderr
    assert not os.path.exists(ep_path)
    assert not mark.exists()


def test_replica_without_a_card_exits_before_its_endpoint(tmp_path):
    """A replica whose spec does not ask for the CPU probes the card; on
    a machine without one it raises BackendUnavailable and exits with
    BACKEND_UNAVAILABLE_EXIT before publishing an endpoint: it never
    serves from the host."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    d, _ = _published(tmp_path)
    p, ep_path = _run_replica(tmp_path, {"models": {"default": d},
                                         "shed_policy": False})
    assert p.returncode == fleet.BACKEND_UNAVAILABLE_EXIT, p.stderr[-800:]
    assert "platform_degradation" in p.stderr
    assert '"to": null' in p.stderr
    assert not os.path.exists(ep_path)


def test_a_replica_dead_before_ready_backs_the_relaunch_off(tmp_path):
    """The controller's crash-loop guard: a replica that exits before it
    was ever ready (a card that did not come up) is reaped, counted as
    a relaunch, and the next spawn waits a doubling backoff."""
    d, _ = _published(tmp_path)
    pol = FleetScalePolicy(min_replicas=1, max_replicas=1)
    ctl = fleet.FleetController(str(tmp_path / "fleet"),
                                {"models": {"default": d}}, policy=pol)

    class _Exited:
        pid = 12345

        def poll(self):
            return fleet.BACKEND_UNAVAILABLE_EXIT

    spawned = []
    ctl._spawn = lambda reason="scale_up": spawned.append(reason)
    for k, want in enumerate((1.0, 2.0, 4.0)):
        h = fleet.ReplicaHandle("replica-%03d" % k, _Exited(), k + 1,
                                str(tmp_path / ("ep%d.json" % k)))
        ctl.replicas.append(h)
        t0 = time.monotonic()
        ctl._reap()
        assert ctl._spawn_backoff_s == want
        assert ctl._spawn_backoff_until >= t0 + want
        assert h in ctl.retired and not ctl.replicas
    assert ctl.relaunches == 3 and spawned == []
    deaths = [e for e in ctl.events if e["action"] == "death"]
    assert [e["returncode"] for e in deaths] == \
        [fleet.BACKEND_UNAVAILABLE_EXIT] * 3
    assert not any(e["was_ready"] for e in deaths)


def test_fleet_controller_round_trip_and_graceful_stop(tmp_path):
    """Two replicas under the controller with die_at_spawn:2 in their
    environment: the second spawn dies before it is ready and is
    relaunched as spawn 3, which is ready before any request.  Two
    FleetClients, one on the wire and one on the shared-memory ring,
    each serve byte-verified float32 answers (the port's offline device
    predict, the JAX package's within rtol 1e-5); the graceful stop
    drains each live replica to exit 0.  No replica ran nvcc, built or
    loaded a kernel."""
    from lightgbm_tpu.basic import Booster as JBooster
    d, text = _published(tmp_path)
    bindir, mark = _fake_nvcc(tmp_path)
    spec = {"models": {"default": d}, "response_dtype": "float32",
            "max_queue": 64, "batch_window_s": 0.002,
            "shed_policy": False, "params": dict(CPU)}
    pol = FleetScalePolicy(min_replicas=2, max_replicas=2,
                           slo_p99_s=5.0, high_watermark=0.95,
                           low_watermark=0.0, patience=10 ** 6,
                           scale_down_patience=10 ** 6, interval_s=0.2)
    ctl = fleet.FleetController(
        str(tmp_path / "fleet"), spec, policy=pol, interval_s=0.2,
        env={"LGBM_TPU_FAULT": "die_at_spawn:2", "OMP_NUM_THREADS": "1",
             "PATH": bindir + os.pathsep + os.environ.get("PATH", "")})
    clients = []
    try:
        ctl.start()
        assert ctl.wait_ready(2, timeout=150) == 2
        assert sorted(h.ordinal for h in ctl.replicas) == [1, 3]
        probe = np.random.default_rng(7).standard_normal(
            (16, 6)).astype(np.float32).astype(np.float64)
        ref = lt.Booster(params=dict(CPU), model_str=text).predict(
            probe, device=True).astype(np.float32)
        jref = JBooster(model_str=text).predict(probe, device=True)
        np.testing.assert_allclose(ref, jref, rtol=1e-5, atol=1e-6)
        for prefer_shm in (False, True):
            cli = fleet.FleetClient(ctl, workers=2, predict_deadline_s=10,
                                    request_timeout_s=20,
                                    prefer_shm=prefer_shm)
            clients.append(cli)
            futs = [(cli.submit(probe[i:i + 2]), i)
                    for i in range(0, 16, 2)]
            for fut, i in futs:
                rec = fut.wait(timeout=30)
                assert rec.generation == 1 and rec.served_by == "device"
                assert np.array_equal(rec.values, ref[i:i + 2])
            kind = "shm" if prefer_shm else "wire"
            assert cli.transports == {"shm": 0, "wire": 0, kind: 8}
    finally:
        for cli in clients:
            cli.close()
        rep = ctl.stop()
    actions = [e["action"] for e in rep["events"]]
    assert actions.count("ready") == 2
    # the corpse is reaped, then the paced top-up (after the crash-loop
    # backoff) spawns its successor
    death = actions.index("death")
    assert rep["events"][death]["returncode"] == 137
    assert not rep["events"][death]["was_ready"]
    assert rep["events"][death]["replica"] == "replica-002"
    respawn = [e for e in rep["events"][death:]
               if e["action"] in ("spawn", "relaunch")]
    assert respawn[0]["ordinal"] == 3
    assert rep["relaunches"] == 1 and rep["replica_seconds"] > 0
    ready = [e for e in rep["events"] if e["action"] == "ready"]
    assert all(e["spawn_to_ready_s"] > 0 for e in ready)
    assert not ctl.replicas
    live = [h for h in ctl.retired if h.ordinal in (1, 3)]
    assert [h.proc.returncode for h in live] == [0, 0]
    for h in live:
        with open(h.endpoint_path) as fh:
            ep = json.load(fh)
        assert ep["drained"] and ep["pid"] == h.proc.pid
        assert ep["kernel_builds"] == 0
        assert ep["peak_device_bytes"] is None       # device_type=cpu
        assert ep["wire_port"] and ep["wire_uds"].endswith(".sock")
    assert not mark.exists()
