"""The debug bundle of the PyTorch port (lightgbm_tpu_torch/runtime/
doctor.py): the round trip of tests/test_doctor.py (one atomic tar whose
manifest checksums verify, carrying the environment fingerprint, the
stage trail, the metrics snapshot, the program ledger, the build cache's
status, the trace ring and recent artifacts), tampering detected, and a
member that cannot be gathered recorded, not raised.  The fingerprint
must not initialize CUDA."""
import io
import json
import os
import tarfile

import torch

from lightgbm_tpu_torch.runtime import (doctor, graph_obs, resilience,
                                        telemetry)

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def _mk_trail(path):
    resilience.atomic_write(path, json.dumps(
        {"label": "t", "stages": [{"stage": "s1", "t": 0.1}],
         "culprit": None}))


def test_bundle_round_trip_checksums_verify(tmp_path, monkeypatch):
    trail = str(tmp_path / "trail.json")
    _mk_trail(trail)
    monkeypatch.setenv("LGBM_TPU_STAGE_REPORT", trail)
    (tmp_path / "BENCH_r99.json").write_text('{"n": 99, "parsed": {}}')
    telemetry.counter("lgbm_train_iterations_total").inc()
    graph_obs.cache_event("t.doctor", "hit")

    rec = doctor.collect_debug_bundle(
        out_dir=str(tmp_path), config={"task": "train"},
        artifact_dir=str(tmp_path), note="unit test")
    assert os.path.exists(rec["path"])
    names = {m["name"] for m in rec["manifest"]["members"]}
    assert {"env.json", "metrics.json", "graph_ledger.json",
            "warmup_status.json", "trace.json",
            "artifacts/BENCH_r99.json"} <= names
    assert any(n.startswith("trails/") for n in names)
    assert "errors" not in rec["manifest"]
    v = doctor.verify_bundle(rec["path"])
    assert v["ok"], v
    assert v["members"] == len(names)
    with tarfile.open(rec["path"]) as tar:
        by = {i.name.split("/", 1)[1]: tar.extractfile(i).read()
              for i in tar.getmembers()}
    env = json.loads(by["env.json"])
    assert env["config"] == {"task": "train"}
    assert "LGBM_TPU_STAGE_REPORT" in env["env"]
    assert env["torch_version"] == torch.__version__
    assert "nvidia_smi" in env
    ledger = json.loads(by["graph_ledger.json"])
    assert "t.doctor" in ledger["sites"]
    metrics = json.loads(by["metrics.json"])
    assert "lgbm_train_iterations_total" in metrics["metrics"]
    trail_name = [n for n in by if n.startswith("trails/")][0]
    assert json.loads(by[trail_name])["stages"][0]["stage"] == "s1"


def test_fingerprint_leaves_cuda_uninitialized():
    fp = doctor.env_fingerprint({"device_type": "cpu"})
    assert fp["cuda_initialized"] is False
    assert "cuda_device" not in fp
    assert not torch.cuda.is_initialized()
    assert fp["torch_cuda"] == torch.version.cuda


def test_bundle_tamper_detected(tmp_path):
    rec = doctor.collect_debug_bundle(out_dir=str(tmp_path),
                                      artifact_dir=str(tmp_path))
    tampered = str(tmp_path / "tampered.tar.gz")
    with tarfile.open(rec["path"]) as src, \
            tarfile.open(tampered, "w:gz") as dst:
        for info in src.getmembers():
            data = src.extractfile(info).read()
            if info.name.endswith("env.json"):
                data = data.replace(b"{", b"{ ", 1)
                info.size = len(data)
            dst.addfile(info, io.BytesIO(data))
    v = doctor.verify_bundle(tampered)
    assert not v["ok"]
    assert any("env.json" in m for m in v["mismatches"])


def test_collection_failure_degrades_to_manifest_error(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(doctor, "_metrics_member",
                        lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    rec = doctor.collect_debug_bundle(out_dir=str(tmp_path),
                                      artifact_dir=str(tmp_path))
    assert "metrics.json" in rec["manifest"]["errors"]
    assert doctor.verify_bundle(rec["path"])["ok"]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
