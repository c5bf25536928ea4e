"""The trace flight recorder of the PyTorch port
(lightgbm_tpu_torch/runtime/tracing.py): the non-serving cases of
tests/test_tracing.py against the port's module (ids and traceparent,
span nesting and export, context across threads and from the
environment, the disabled path, concurrent writers, merging, the span
name normalization the recorder shares with telemetry), the doctor
bundle's trace member, the merge tool, and the training engine's
``tree dispatch`` instants inside each iteration's span."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.runtime import telemetry, tracing

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_ring():
    tracing.reset()
    yield
    tracing.reset()


def test_traceparent_roundtrip_and_malformed():
    t, s = tracing.new_trace_id(), tracing.new_span_id()
    assert len(t) == 32 and len(s) == 16
    assert tracing.parse_traceparent(tracing.make_traceparent(t, s)) == (t, s)
    for bad in (None, "", "garbage", "00-short-short-01", 42,
                "00-" + "0" * 32 + "-" + "0" * 16 + "-01",     # zero ids
                "00-" + "z" * 32 + "-" + "f" * 16 + "-01"):    # non-hex
        assert tracing.parse_traceparent(bad) is None

    ids = {tracing.new_span_id() for _ in range(1000)}
    assert len(ids) == 1000                    # unique id stream


def test_span_nesting_parent_child_and_export():
    with tracing.span("root", foo=1) as root_ctx:
        assert tracing.current() == root_ctx
        assert tracing.parse_traceparent(
            tracing.current_traceparent()) == root_ctx
        with tracing.span("child"):
            tracing.instant("mark", k="v")
    assert tracing.current() is None           # stack unwound

    doc = tracing.export_chrome()
    by_name = {e["name"]: e for e in doc["traceEvents"]
               if e["ph"] in ("X", "i")}
    root, child = by_name["root"], by_name["child"]
    assert child["args"]["trace"] == root["args"]["trace"]
    assert child["args"]["parent"] == root["args"]["span"]
    assert by_name["mark"]["args"]["trace"] == root["args"]["trace"]
    assert root["args"]["foo"] == 1
    # timestamps are ABSOLUTE unix microseconds (the merge contract)
    assert abs(root["ts"] / 1e6 - time.time()) < 300
    assert root["dur"] >= child["dur"] >= 0


def test_span_error_status():
    with pytest.raises(RuntimeError):
        with tracing.span("boom"):
            raise RuntimeError("x")
    ev = [e for e in tracing.export_chrome()["traceEvents"]
          if e.get("name") == "boom"][0]
    assert ev["args"]["status"] == "error"


def test_attach_and_bind_carry_context_across_threads():
    seen = {}
    with tracing.span("dispatcher") as ctx:
        captured = tracing.context()

        def worker():
            with tracing.attach(captured):
                seen["inside"] = tracing.current()
            seen["outside"] = tracing.current()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["inside"] == ctx and seen["outside"] is None

    # bind(): the assembler hand-off seam — runs fn under the captured
    # context AND records a span for the invocation
    with tracing.span("iteration") as it_ctx:
        fn = tracing.bind(lambda: tracing.current(), "drain", trees=2)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("ctx", fn()))
    t.start()
    t.join()
    assert out["ctx"][0] == it_ctx[0]          # same trace id
    drain = [e for e in tracing.export_chrome()["traceEvents"]
             if e.get("name") == "drain"][0]
    assert drain["args"]["trace"] == it_ctx[0]
    assert drain["args"]["parent"] == it_ctx[1]
    assert drain["args"]["trees"] == 2


def test_process_root_from_env(monkeypatch):
    t, s = tracing.new_trace_id(), tracing.new_span_id()
    monkeypatch.setenv(tracing.TRACEPARENT_ENV,
                       tracing.make_traceparent(t, s))
    tracing.reset()                            # re-read the env seed
    assert tracing.process_root() == (t, s)
    with tracing.span("rooted"):
        pass
    ev = [e for e in tracing.export_chrome()["traceEvents"]
          if e.get("name") == "rooted"][0]
    # a root span opened with no explicit context parents under the env
    assert ev["args"]["trace"] == t and ev["args"]["parent"] == s


def test_disabled_path_records_nothing_and_bind_is_identity():
    prev = tracing.set_enabled(False)
    try:
        tracing.instant("x")
        tracing.record("x", 0, 0)
        tracing.flow_start("x", 1)
        tracing.counter_event("x", 1.0)
        with tracing.span("x") as ctx:
            assert ctx is None
        fn = lambda: 1                          # noqa: E731
        assert tracing.bind(fn, "name") is fn
    finally:
        tracing.set_enabled(prev)
    assert tracing.ring_summary()["recorded_total"] == 0


def test_concurrent_writers_no_torn_or_out_of_order_events(monkeypatch):
    monkeypatch.setattr(tracing, "_RING", tracing._Ring(1024))
    threads, per = 6, 300

    def work(i):
        for j in range(per):
            with tracing.span("w%d" % i, j=j):
                tracing.instant("m%d" % i)
    ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    summary = tracing.ring_summary()
    assert summary["recorded_total"] == threads * per * 2
    # bounded: the ring holds the newest `capacity`, the rest counted
    assert summary["events"] == 1024
    assert summary["dropped"] == threads * per * 2 - 1024
    doc = tracing.export_chrome()
    evs = [e for e in doc["traceEvents"] if e["ph"] in ("X", "i")]
    # no torn event: every record is structurally complete
    for e in evs:
        assert e["name"] and isinstance(e["ts"], float)
        if e["ph"] == "X":
            assert e["dur"] >= 0 and "span" in e["args"]
    # export order is globally monotonic (sorted on the shared clock)
    stamps = [e["ts"] for e in evs]
    assert stamps == sorted(stamps)
    assert doc["otherData"]["dropped"] == summary["dropped"]


def test_merge_traces_fuses_processes_onto_one_timeline(tmp_path):
    with tracing.span("a"):
        pass
    p1 = str(tmp_path / "one.json")
    tracing.export_chrome(p1, context_name="one")
    tracing.reset()
    with tracing.span("b"):
        pass
    p2 = str(tmp_path / "two.json")
    tracing.export_chrome(p2, context_name="two")

    out = str(tmp_path / "merged.json")
    doc = tracing.merge_traces([p1, p2], out_path=out)
    on_disk = json.load(open(out))
    assert on_disk["otherData"]["merged_from"] == \
        doc["otherData"]["merged_from"]
    # each source landed on its own pid slot with a {host,pid} name
    names = [e for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"]
    assert {e["pid"] for e in names} == {1, 2}
    assert all("pid=" in e["args"]["name"] for e in names)
    body = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    stamps = [e["ts"] for e in body]
    assert stamps == sorted(stamps)
    # the size bound cuts oldest-first and records the cut
    capped = tracing.merge_traces([p1, p2], max_events=1)
    assert capped["otherData"]["events"] == 1
    assert capped["otherData"]["truncated_oldest"] == len(body) - 1


def test_normalize_keeps_product_keys_distinguishable():
    n = telemetry.normalize_span_name
    # bounded product parameters survive: J=2 and J=4 are DIFFERENT
    # stages, not two samples of one (the pre-fix rewrite merged them)
    assert n("window dispatch J=4") == "window dispatch J=4"
    assert n("window dispatch J=2") != n("window dispatch J=4")
    assert n("depth=2 drain") == "depth=2 drain"
    # unbounded identifiers still collapse (cardinality stays bounded)
    assert n("cycle 17: train") == n("cycle 991: train") == "cycle N: train"
    assert n("batch model=default gen=12 rows=512") == \
        "batch model=default gen=N rows=N"
    assert n("online stage/cycle 3: publish") == \
        "online stage/cycle N: publish"
    assert n("recover: republish generation 7") == \
        "recover: republish generation N"
    # every registered watchdog-stage shape in the tree stays bounded:
    # a name made only of digits+keys cannot exceed the length cap
    assert len(n("x" * 500)) <= 80


def test_window_dispatch_span_series_distinct_by_J():
    telemetry.record_span("window dispatch J=2", 0.01)
    telemetry.record_span("window dispatch J=4", 0.02)
    snap = telemetry.snapshot()
    spans = {s["labels"]["span"]
             for s in snap["metrics"]["lgbm_span_seconds"]["series"]}
    assert {"window dispatch J=2", "window dispatch J=4"} <= spans


def test_record_span_lands_in_ring_with_raw_name():
    telemetry.record_span("cycle 42: publish", 0.05)
    evs = [e for e in tracing.export_chrome()["traceEvents"]
           if e.get("name") == "cycle 42: publish"]
    assert len(evs) == 1 and evs[0]["dur"] == pytest.approx(50_000, rel=0.1)


def test_export_to_dir_and_autostart_env(tmp_path, monkeypatch):
    with tracing.span("flushed"):
        pass
    path = tracing.export_to_dir(str(tmp_path / "traces"))
    assert path and os.path.exists(path)
    assert "trace_" in os.path.basename(path)
    doc = json.load(open(path))
    assert any(e.get("name") == "flushed" for e in doc["traceEvents"])
    # autostart only arms when the env var is set
    monkeypatch.delenv(tracing.TRACE_DIR_ENV, raising=False)
    monkeypatch.setattr(tracing, "_atexit_armed", False)
    assert tracing.maybe_autostart() is False
    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(tmp_path / "traces"))
    assert tracing.maybe_autostart() is True


def test_doctor_bundle_carries_trace_ring(tmp_path):
    from lightgbm_tpu_torch.runtime import doctor
    with tracing.span("pre-crash work"):
        pass
    rec = doctor.collect_debug_bundle(out_dir=str(tmp_path),
                                      artifact_dir=str(tmp_path))
    names = [m["name"] for m in rec["manifest"]["members"]]
    assert "trace.json" in names
    import tarfile
    with tarfile.open(rec["path"]) as tar:
        member = [m for m in tar.getmembers()
                  if m.name.endswith("trace.json")][0]
        doc = json.loads(tar.extractfile(member).read().decode())
    assert any(e.get("name") == "pre-crash work"
               for e in doc["traceEvents"])


def test_merge_tool_main(tmp_path, capsys):
    with tracing.span("a"):
        pass
    p1 = str(tmp_path / "one.json")
    tracing.export_chrome(p1)
    out = str(tmp_path / "merged.json")
    assert tracing.main(["merge", out, p1]) == 0
    assert json.load(open(out))["otherData"]["merged_from"][0]["file"] == \
        "one.json"
    assert tracing.main(["bogus"]) == 2
    assert "usage" in capsys.readouterr().out


@pytest.mark.parametrize("params", [{}, dict(objective="multiclass",
                                             num_class=3)])
def test_training_records_one_dispatch_per_tree(params):
    """GBDT records the JAX package's ``tree dispatch`` instant per tree,
    labelled with the iteration and the class, inside the iteration's
    ``train/iteration`` span."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((1200, 5))
    y = np.digitize(X[:, 0], [-0.4, 0.4]).astype(np.float64) \
        if params else (X[:, 0] > 0).astype(np.float64)
    p = dict(dict(objective="binary", num_leaves=7, verbose=-1,
                  device_type="cpu"), **params)
    lt.train(p, lt.Dataset(X, label=y), 3, verbose_eval=False)
    doc = tracing.export_chrome()
    evs = doc["traceEvents"]
    spans = {e["args"]["span"]: e for e in evs
             if e.get("name") == "train/iteration"}
    marks = [e for e in evs if e.get("name") == "tree dispatch"]
    K = 3 if params else 1
    assert len(spans) == 3 and len(marks) == 3 * K
    assert [(m["args"]["it"], m["args"]["k"]) for m in marks] == \
        [(i, k) for i in range(3) for k in range(K)]
    assert all(m["args"]["parent"] in spans for m in marks)
