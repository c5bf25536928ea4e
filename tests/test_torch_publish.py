"""The port's publish / subscribe seam (lightgbm_tpu_torch/runtime/
publish.py) against the JAX package's (lightgbm_tpu/runtime/publish.py):
generation files, the manifest fallback, torn and corrupt generations,
bounded retry, keep-last-K with its grace window, rollback markers, the
snapshot retention grace, and the file formats across packages (a
generation either package publishes resolves in the other, and with the
clock fixed both write the same bytes).  Host-only: no model trains."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu.runtime import publish as jpublish
from lightgbm_tpu.runtime import resilience as jres
from lightgbm_tpu_torch.runtime import publish, resilience

torch.set_num_threads(1)

_MODEL = "tree\nversion=v3\nnum_leaves=2\nend of trees\n"


def test_publish_resolve_roundtrip(tmp_path):
    pub = publish.ModelPublisher(str(tmp_path / "pub"), keep_last=0)
    for i in range(3):
        rec = pub.publish(_MODEL.replace("2", str(i + 2)),
                          meta={"cycle": i + 1})
        assert rec.generation == i + 1
    sub = publish.ModelSubscriber(str(tmp_path / "pub"))
    got = sub.resolve()
    assert got.generation == 3
    assert got.model_text == _MODEL.replace("2", "4")
    assert got.meta["cycle"] == 3 and "published_at" in got.meta
    for _, p in publish.generation_paths(str(tmp_path / "pub")):
        assert publish.validate_generation(p)[0]
    assert not [f for f in os.listdir(tmp_path / "pub") if ".tmp" in f]


def test_subscriber_skips_torn_generation_and_counts_it(tmp_path):
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=0)
    pub.publish(_MODEL, meta={"cycle": 1})
    good = pub.publish(_MODEL, meta={"cycle": 2})
    torn = os.path.join(d, "gen_00000003.txt")
    with open(good.path) as fh:
        body = fh.read()
    with open(torn, "w") as fh:
        fh.write(body[: len(body) // 2])
    sub = publish.ModelSubscriber(d)
    assert sub.resolve().generation == 2
    assert sub.skipped_invalid == 1
    assert publish.validate_generation(torn) == (
        False, "torn or checksum-invalid")
    # a bit flip fails the checksum too
    with open(torn, "w") as fh:
        fh.write(body.replace("num_leaves=2", "num_leaves=3"))
    sub2 = publish.ModelSubscriber(d)
    assert sub2.resolve().generation == 2 and sub2.skipped_invalid == 1


@pytest.mark.parametrize("manifest", ["stale", "corrupt", "missing"])
def test_subscriber_survives_stale_and_corrupt_manifest(tmp_path, manifest):
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=0)
    pub.publish(_MODEL, meta={"cycle": 1})
    pub.publish(_MODEL, meta={"cycle": 2})
    mpath = os.path.join(d, publish.MANIFEST)
    if manifest == "stale":
        # the die_at_publish window: the manifest names generation 1
        with open(mpath) as fh:
            m = json.load(fh)
        m["latest"], m["file"] = 1, "gen_00000001.txt"
        resilience.atomic_write(mpath, json.dumps(m))
    elif manifest == "corrupt":
        with open(mpath, "w") as fh:
            fh.write('{"latest": ')
    else:
        os.unlink(mpath)
    assert publish.ModelSubscriber(d).resolve().generation == 2
    assert jpublish.ModelSubscriber(d).resolve().generation == 2


def test_subscriber_bounded_retry_then_raises(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
    sub = publish.ModelSubscriber(str(tmp_path / "empty"), attempts=3)
    with pytest.raises(publish.NoValidGeneration, match="3 attempts"):
        sub.resolve()
    assert len(sleeps) == 2 and all(s > 0 for s in sleeps)
    # the JAX package's jittered schedule, delay for delay
    jsleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: jsleeps.append(s))
    with pytest.raises(jpublish.NoValidGeneration):
        jpublish.ModelSubscriber(str(tmp_path / "empty"),
                                 attempts=3).resolve()
    assert jsleeps == sleeps


def test_publisher_prune_respects_grace_window(tmp_path):
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=2, grace_s=3600.0)
    for i in range(5):
        pub.publish(_MODEL, meta={"cycle": i + 1})
    assert [g for g, _ in publish.generation_paths(d)] == [5, 4, 3, 2, 1]
    for gen, path in publish.generation_paths(d)[2:]:
        os.utime(path, (time.time() - 7200, time.time() - 7200))
    pub.publish(_MODEL, meta={"cycle": 6})
    kept = [g for g, _ in publish.generation_paths(d)]
    assert 6 in kept and 5 in kept
    assert not any(g in kept for g in (1, 2, 3))
    # a generation the rollback marker pins is never pruned
    publish.mark_rollback(d, 6, pinned_generation=4, reason="pin")
    os.utime(os.path.join(d, "gen_00000004.txt"),
             (time.time() - 7200, time.time() - 7200))
    pub0 = publish.ModelPublisher(d, keep_last=2, grace_s=0.0)
    pub0.publish(_MODEL, meta={"cycle": 7})
    assert [g for g, _ in publish.generation_paths(d)] == [7, 6, 4]


def test_snapshot_retention_grace_window(tmp_path):
    import lightgbm_tpu_torch as lt
    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lt.Booster({"objective": "binary", "verbose": -1,
                      "device_type": "cpu", "num_leaves": 4},
                     lt.Dataset(X, label=y))
    out = str(tmp_path / "m.txt")
    for _ in range(4):
        bst.update()
        resilience.write_snapshot(bst, out, retention=2,
                                  retention_grace_s=3600.0,
                                  extra_state={"cycle": 1})
    assert [it for it, _ in resilience.snapshot_paths(out)] == [4, 3, 2, 1]
    for it, p in resilience.snapshot_paths(out)[2:]:
        os.utime(p, (time.time() - 7200, time.time() - 7200))
    bst.update()
    path = resilience.write_snapshot(bst, out, retention=2,
                                     retention_grace_s=3600.0)
    assert [it for it, _ in resilience.snapshot_paths(out)] == [5, 4, 3]
    # the service state rides the footer; the model text is the prefix
    assert resilience.load_snapshot_state(
        resilience.snapshot_paths(out)[1][1])["service"] == {"cycle": 1}
    assert resilience.snapshot_model_text(path) == \
        bst._model.save_model_to_string()
    assert resilience.snapshot_model_text(str(tmp_path / "none")) is None


def test_rejection_record_is_invisible_to_subscribers(tmp_path):
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=0)
    pub.publish(_MODEL, meta={"cycle": 1})
    rej = pub.record_rejection(_MODEL.replace("2", "9"),
                               {"verdict": "reject"}, cycle=2)
    assert [g for g, _ in publish.rejection_paths(d)] == [2]
    assert publish.ModelSubscriber(d).resolve().generation == 1
    with open(rej) as fh:
        split = publish._split_validate(fh.read())
    assert split[1]["gate"] == {"verdict": "reject"}
    assert jpublish.rejection_paths(d) == publish.rejection_paths(d)


def test_concurrent_rollback_markers_merge(tmp_path):
    """Two writers condemning different generations concurrently both
    land (read-merge-atomic-write), and a subscriber steps past both."""
    d = str(tmp_path / "pub")
    pub = publish.ModelPublisher(d, keep_last=0)
    for i in range(3):
        pub.publish(_MODEL, meta={"cycle": i + 1})
    errs = []

    def condemn(gen, mod):
        try:
            for _ in range(20):
                mod.mark_rollback(d, gen, pinned_generation=1,
                                  reason="r%d" % gen)
        except Exception as e:           # noqa: BLE001 — ledger
            errs.append(e)

    ts = [threading.Thread(target=condemn, args=(3, publish)),
          threading.Thread(target=condemn, args=(2, jpublish))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    marker = publish.read_rollback_marker(d)
    assert set(marker["bad_generations"]) == {2, 3}
    assert marker == jpublish.read_rollback_marker(d)
    sub = publish.ModelSubscriber(d)
    assert sub.resolve().generation == 1
    assert sub.skipped_rolled_back == 2
    # a pin releases once a generation newer than its bound lands
    sub.pin_generation(1, release_above=3)
    assert sub.resolve().generation == 1 and sub.pinned_generation == 1
    pub.publish(_MODEL, meta={"cycle": 4})
    assert sub.resolve().generation == 4 and sub.pinned_generation is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_generations_cross_packages(tmp_path, writer):
    """A generation one package publishes resolves in the other's
    subscriber to the same model text and meta."""
    d = str(tmp_path / "pub")
    wmod, rmod = (jpublish, publish) if writer == "jax" \
        else (publish, jpublish)
    pub = wmod.ModelPublisher(d, keep_last=0)
    recs = [pub.publish(_MODEL.replace("2", str(i + 2)),
                        meta={"cycle": i + 1, "total_iter": 2 * (i + 1)})
            for i in range(2)]
    got = rmod.ModelSubscriber(d).resolve()
    assert got.generation == 2
    assert got.model_text == recs[1].model_text
    assert got.meta == recs[1].meta
    assert rmod.validate_generation(recs[0].path) == (True, "ok")
    # the reader's publisher continues the writer's numbering
    assert rmod.ModelPublisher(d).next_generation() == 3


def test_publishers_write_the_same_bytes(tmp_path, monkeypatch):
    """With the clock fixed, both publishers write every file byte for
    byte alike: generations, the manifest, rejections, the rollback
    marker."""
    monkeypatch.setattr(time, "time", lambda: 1792000000.25)
    for mod in (resilience, jres):
        monkeypatch.setattr(mod, "wallclock", lambda: "2026-10-18T00:00:00")
    out = {}
    for name, mod in (("jax", jpublish), ("torch", publish)):
        d = str(tmp_path / name)
        pub = mod.ModelPublisher(d, keep_last=0)
        pub.publish(_MODEL, meta={"cycle": 1, "gate": {"verdict": "pass"}})
        pub.publish(_MODEL.replace("2", "3"), meta={"cycle": 2})
        pub.record_rejection(_MODEL, {"verdict": "reject"}, cycle=3)
        mod.mark_rollback(d, 2, pinned_generation=1, reason="canary")
        out[name] = {f: open(os.path.join(d, f), "rb").read()
                     for f in sorted(os.listdir(d))}
    assert sorted(out["jax"]) == sorted(out["torch"]) == [
        "MANIFEST.json", "ROLLBACK.json", "gen_00000001.txt",
        "gen_00000002.txt", "rejected_00000003.txt"]
    for f in out["jax"]:
        assert out["jax"][f] == out["torch"][f], f
