"""Metrics, spans and exporters of the PyTorch port
(lightgbm_tpu_torch/runtime/telemetry.py): the non-serving, non-CLI cases
of tests/test_telemetry.py against the port's module (the registry's
bucket-exact quantiles, label-cardinality overflow, strict declaration,
Prometheus and JSON rendering, spans and the watchdog as their client,
the HTTP and JSON-lines exporters, atomic stage trails, host merging),
the port's METRIC_TABLE row for row against the JAX package's, the
training seam (Booster.update through train_iteration, the sync bridge)
and the torch.profiler hook."""
import glob
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.runtime import telemetry as jtelemetry
from lightgbm_tpu_torch.runtime import resilience, syncs, telemetry

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

TEST_TABLE = {
    "t_counter_total": {"type": "counter", "labels": ("kind",),
                        "help": "test counter"},
    "t_plain_total": {"type": "counter", "labels": (),
                      "help": "plain test counter"},
    "t_gauge": {"type": "gauge", "labels": (), "help": "test gauge"},
    "t_hist_seconds": {"type": "histogram", "labels": ("who",),
                       "help": "test histogram"},
}

#: the graph ledger's rows: the JAX package's names, types and labels,
#: with help that says what the port counts (CUDA graph captures, grower
#: programs and nvcc builds for XLA compiles; the kernel build cache for
#: jax's compilation cache)
LEDGER_ROWS = ("lgbm_xla_compiles_total", "lgbm_xla_compile_seconds",
               "lgbm_xla_retraces_total", "lgbm_program_cache_events_total",
               "lgbm_compile_cache_events_total")

#: rows whose help is the JAX package's help cut short before a closing
#: remark about that package's own history
TRIMMED_HELP = ("lgbm_fleet_reaction_seconds",)

#: the wire, SHM ring, load generator and fleet families
DATA_PLANE_ROWS = ("lgbm_serve_bytes_total", "lgbm_serve_frames_total",
                   "lgbm_shm_sessions_total", "lgbm_shm_frames_total",
                   "lgbm_shm_doorbell_syscalls_total",
                   "lgbm_loadgen_offered_total",
                   "lgbm_loadgen_verified_total", "lgbm_fleet_replicas",
                   "lgbm_fleet_scale_events_total",
                   "lgbm_fleet_reaction_seconds")


def _registry(**kw):
    return telemetry.MetricsRegistry(table=dict(TEST_TABLE), **kw)


def test_counter_gauge_basics():
    reg = _registry()
    reg.counter("t_counter_total").inc(kind="a")
    reg.counter("t_counter_total").inc(2.5, kind="a")
    reg.counter("t_counter_total").inc(kind="b")
    assert reg.counter("t_counter_total").value(kind="a") == 3.5
    assert reg.counter("t_counter_total").total() == 4.5
    reg.gauge("t_gauge").set(7)
    reg.gauge("t_gauge").inc(3)
    assert reg.gauge("t_gauge").value() == 10


def _two_host_snapshots():
    ra, rb = _registry(), _registry()
    ra.counter("t_plain_total").inc(3)
    ra.histogram("t_hist_seconds").observe(0.02, who="a")
    rb.counter("t_plain_total").inc(5)
    rb.gauge("t_gauge").set(7)
    return {"0": ra.snapshot("hostA"), "1": rb.snapshot("hostB")}


def test_histogram_quantiles_exact_within_bucket():
    """p50/p95/p99 from the fixed layout must sit within one bucket
    width of the true quantile, with sum/count exact."""
    reg = _registry()
    h = reg.histogram("t_hist_seconds")
    rng = np.random.default_rng(7)
    values = rng.uniform(0.0005, 4.0, size=5000)
    for v in values:
        h.observe(float(v), who="x")
    st = h.state(who="x")
    assert st["count"] == 5000
    assert abs(st["sum"] - values.sum()) < 1e-6
    for q in (0.5, 0.95, 0.99):
        est = h.quantile(q, who="x")
        true = float(np.quantile(values, q))
        assert abs(est - true) <= h.bucket_width_at(true), (q, est, true)


def test_histogram_empty_and_overflow_tail():
    reg = _registry()
    h = reg.histogram("t_hist_seconds")
    assert h.quantile(0.5, who="x") is None
    h.observe(1e9, who="x")              # beyond the largest finite edge
    q = h.quantile(0.99, who="x")
    assert q == h.buckets[-2]            # reported as the last finite edge


def test_label_cardinality_overflow_bucket():
    """Past max_label_sets, new label sets land in the explicit
    __overflow__ series — bounded memory, visible overload."""
    reg = _registry(max_label_sets=4)
    c = reg.counter("t_counter_total")
    for i in range(10):
        c.inc(kind="k%d" % i)
    keys = {k for k, _ in c.items()}
    assert len(keys) == 5                # 4 real + 1 overflow
    assert (telemetry.OVERFLOW_LABEL,) in keys
    assert c.value(kind=telemetry.OVERFLOW_LABEL) == 6
    assert c.total() == 10               # nothing dropped


def test_prometheus_rendering():
    reg = _registry()
    reg.counter("t_counter_total").inc(kind='we"ird\\')
    reg.histogram("t_hist_seconds").observe(0.003, who="w")
    reg.histogram("t_hist_seconds").observe(0.004, who="w")
    text = reg.render_prometheus()
    assert "# TYPE t_counter_total counter" in text
    assert "# HELP t_hist_seconds test histogram" in text
    assert 't_counter_total{kind="we\\"ird\\\\"} 1' in text
    # buckets are cumulative and end at +Inf == count
    assert 't_hist_seconds_bucket{who="w",le="+Inf"} 2' in text
    assert 't_hist_seconds_bucket{who="w",le="0.005"} 2' in text
    assert 't_hist_seconds_bucket{who="w",le="0.0025"} 0' in text
    assert 't_hist_seconds_count{who="w"} 2' in text


def test_disabled_path_records_nothing():
    reg = _registry()
    prev = telemetry.set_enabled(False)
    try:
        reg.counter("t_plain_total").inc()
        reg.gauge("t_gauge").set(5)
        reg.histogram("t_hist_seconds").observe(1.0, who="x")
    finally:
        telemetry.set_enabled(prev)
    assert reg.counter("t_plain_total").total() == 0
    assert reg.histogram("t_hist_seconds").state()["count"] == 0
    assert reg.ops == 0


def test_snapshot_carries_quantiles_and_json_roundtrips():
    reg = _registry()
    reg.histogram("t_hist_seconds").observe(0.02, who="x")
    snap = reg.snapshot("unit")
    line = json.dumps(snap)
    back = json.loads(line)
    ser = back["metrics"]["t_hist_seconds"]["series"][0]
    assert ser["count"] == 1 and ser["p50"] is not None
    assert back["context"] == "unit" and back["wallclock"]


def test_span_normalization_and_recording():
    assert telemetry.normalize_span_name("cycle 17: train") == \
        "cycle N: train"
    assert telemetry.normalize_span_name(
        "batch model=default gen=3 rows=512") == \
        "batch model=default gen=N rows=N"
    h = telemetry.histogram("lgbm_span_seconds")
    before = h.state(span="unit span N")
    with telemetry.span("unit span 42"):
        time.sleep(0.01)
    after = h.state(span="unit span N")
    assert after["count"] == before["count"] + 1
    assert after["sum"] - before["sum"] >= 0.009


def test_span_error_status():
    c = telemetry.counter("lgbm_spans_total")
    before = c.value(span="failing span", status="error")
    with pytest.raises(RuntimeError):
        with telemetry.span("failing span"):
            raise RuntimeError("boom")
    assert c.value(span="failing span", status="error") == before + 1


def test_watchdog_stage_closes_record_spans():
    """The stage-trail watchdog is a client of the span API: every
    stage close lands in lgbm_span_seconds under <label>/<stage> with
    digits normalized, status mirroring the trail."""
    h = telemetry.histogram("lgbm_span_seconds")
    key = "unit wd/step N"
    before = h.state(span=key)
    wd = resilience.Watchdog(0, label="unit wd", use_alarm=False)
    wd("step 1")
    time.sleep(0.005)
    wd("step 2")
    wd.done()
    after = h.state(span=key)
    assert after["count"] == before["count"] + 2
    # a thread-mode deadline expiry closes as status=timeout
    c = telemetry.counter("lgbm_spans_total")
    t_before = c.value(span=key, status="timeout")
    wd2 = resilience.Watchdog(0, label="unit wd", use_alarm=False)
    wd2("step 3")
    wd2.record_timeout(note="unit")
    assert c.value(span=key, status="timeout") == t_before + 1


def test_http_server_serves_prometheus_and_json():
    reg = _registry()
    reg.counter("t_plain_total").inc(3)
    srv = telemetry.start_http_server(port=0, registry=reg)
    try:
        base = "http://127.0.0.1:%d" % srv.port
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert "t_plain_total 3" in text
        snap = json.loads(urllib.request.urlopen(
            base + "/metrics.json", timeout=10).read().decode())
        assert snap["metrics"]["t_plain_total"]["series"][0]["value"] == 3
        assert urllib.request.urlopen(
            base + "/healthz", timeout=10).read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        srv.stop()


def test_metrics_file_writer_atomic_lines(tmp_path):
    """Every flush rewrites the file atomically: a concurrent reader
    must ALWAYS see a complete, parseable JSON-lines file (this is the
    torn-read satellite applied to the new exporter)."""
    reg = _registry()
    path = str(tmp_path / "m.jsonl")
    w = telemetry.MetricsFileWriter(path, interval_s=0, context="unit",
                                    registry=reg)
    problems = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                with open(path) as fh:
                    for line in fh.read().splitlines():
                        json.loads(line)
            except FileNotFoundError:
                pass
            except ValueError as e:
                problems.append(str(e))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    for i in range(60):
        reg.counter("t_plain_total").inc()
        w.write_now()
    stop.set()
    t.join(timeout=10)
    assert problems == []
    lines = open(path).read().splitlines()
    assert 1 <= len(lines) <= telemetry.SNAPSHOT_KEEP_LAST
    last = json.loads(lines[-1])
    assert last["metrics"]["t_plain_total"]["series"][0]["value"] == 60
    assert last["context"] == "unit"
    w.stop(final_flush=False)


def test_read_stage_report_tolerates_torn_and_missing(tmp_path):
    torn = tmp_path / "trail.json"
    good = {"stages": [{"name": "s"}], "culprit": None}
    torn.write_text(json.dumps(good)[: len(json.dumps(good)) // 2])
    assert resilience.read_stage_report(str(torn)) is None
    assert resilience.read_stage_report(str(tmp_path / "absent")) is None
    (tmp_path / "notdict.json").write_text("[1, 2]")
    assert resilience.read_stage_report(
        str(tmp_path / "notdict.json")) is None
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(good))
    assert resilience.read_stage_report(str(ok))["stages"][0]["name"] == "s"


def test_stage_trail_writes_are_atomic_under_concurrent_reads(tmp_path):
    """A scraper polling the stage trail while the watchdog rewrites it
    at every transition/annotate must never observe invalid JSON — the
    tmp+fsync+rename discipline, pinned live."""
    path = str(tmp_path / "trail.json")
    wd = resilience.Watchdog(0, label="atomic wd", use_alarm=False,
                             report_path=path)
    problems = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                with open(path) as fh:
                    json.load(fh)
            except FileNotFoundError:
                pass                     # not written yet
            except ValueError as e:
                problems.append("torn read: %s" % e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    for i in range(100):
        wd("stage %d" % i)
        wd.annotate("k", i)
    wd.done()
    stop.set()
    t.join(timeout=10)
    assert problems == []
    rep = resilience.read_stage_report(path)
    assert rep is not None and rep["stages"]


def test_metric_table_help_is_markdown_safe():
    """Pipes in help strings would silently shear the docs table."""
    for name, d in telemetry.METRIC_TABLE.items():
        assert "|" not in d["help"], name
        assert "\n" not in d["help"], name


def test_merge_host_snapshots_labels_every_series():
    hosts = _two_host_snapshots()
    merged = telemetry.merge_host_snapshots(hosts)
    assert merged["hosts"] == ["0", "1"]
    series = merged["metrics"]["t_plain_total"]["series"]
    assert [(e["labels"]["host"], e["value"]) for e in series] \
        == [("0", 3.0), ("1", 5.0)]
    h = merged["metrics"]["t_hist_seconds"]["series"][0]
    assert h["labels"] == {"host": "0", "who": "a"}
    # {host} labels STABLE: merging again yields the identical structure
    assert telemetry.merge_host_snapshots(hosts) == merged or \
        telemetry.merge_host_snapshots(hosts)["metrics"] == \
        merged["metrics"]


def test_render_prometheus_from_merged_snapshot():
    merged = telemetry.merge_host_snapshots(_two_host_snapshots())
    text = telemetry.render_prometheus_from_snapshot(
        merged, table=TEST_TABLE)
    assert 't_plain_total{host="0"} 3' in text
    assert 't_plain_total{host="1"} 5' in text
    assert 't_gauge{host="1"} 7' in text
    # histogram rendered with cumulative buckets + the +Inf tail
    assert 't_hist_seconds_bucket{host="0",who="a",le="+Inf"} 1' in text
    assert 't_hist_seconds_count{host="0",who="a"} 1' in text


def test_gather_host_snapshots_single_process_is_host_zero():
    reg = _registry()
    reg.counter("t_plain_total").inc()
    hosts = telemetry.gather_host_snapshots("ctx", registry=reg)
    assert list(hosts) == ["0"]
    assert hosts["0"]["context"] == "ctx"
    merged = telemetry.mesh_snapshot("ctx", registry=reg)
    assert merged["metrics"]["t_plain_total"]["series"][0]["labels"] \
        == {"host": "0"}


def test_concurrent_scrape_flush_no_torn_output(tmp_path):
    """Writers hammer the registry, the file exporter flushes, and
    scrapers read /metrics throughout: every exposition parses with
    monotone cumulative buckets, every snapshot-file line is valid
    JSON (the ISSUE 10 test-coverage satellite)."""
    reg = _registry()
    srv = telemetry.MetricsServer(port=0, registry=reg)
    writer = telemetry.MetricsFileWriter(str(tmp_path / "m.jsonl"),
                                         interval_s=0.01, registry=reg)
    stop = threading.Event()
    errors = []

    def hammer(seed):
        i = 0
        while not stop.is_set():
            reg.counter("t_counter_total").inc(kind="k%d" % (seed % 3))
            reg.histogram("t_hist_seconds").observe(
                0.001 * ((i % 50) + 1), who="w%d" % seed)
            reg.gauge("t_gauge").set(i)
            i += 1

    def scrape():
        base = "http://127.0.0.1:%d/metrics" % srv.port
        while not stop.is_set():
            try:
                with urllib.request.urlopen(base, timeout=5) as r:
                    text = r.read().decode()
            except OSError as e:            # noqa: PERF203
                errors.append("scrape: %s" % e)
                continue
            if not text.endswith("\n"):
                errors.append("torn exposition (no trailing newline)")
            cum = {}
            for line in text.splitlines():
                if line.startswith("#") or not line:
                    continue
                name_part, _, val = line.rpartition(" ")
                try:
                    v = float(val)
                except ValueError:
                    errors.append("unparseable sample: %r" % line)
                    continue
                if "_bucket{" in name_part:
                    key = name_part.rsplit(',le="', 1)[0]
                    if v < cum.get(key, 0.0):
                        errors.append("non-monotone buckets: %r" % line)
                    cum[key] = v

    threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
               for i in range(3)]
    threads.append(threading.Thread(target=scrape, daemon=True))
    threads.append(threading.Thread(target=scrape, daemon=True))
    for t in threads:
        t.start()
    time.sleep(1.2)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    srv.stop()
    writer.stop()
    assert errors == [], errors[:5]
    # every flushed line is intact JSON (atomic rewrite: never torn)
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert lines
    for ln in lines:
        snap = json.loads(ln)
        assert "metrics" in snap


def test_undeclared_metric_name_raises():
    """Every product metric must be table-declared — otherwise the docs
    drift lint is incomplete by construction."""
    reg = _registry()
    with pytest.raises(KeyError):
        reg.counter("t_not_declared_total")
    with pytest.raises(ValueError):
        reg.gauge("t_counter_total")     # declared, but wrong type


def test_metric_table_rows_equal_jax():
    """Every family the port declares is the JAX package's row of that
    name (type, labels, help, label-set bound), except the ledger rows
    named in LEDGER_ROWS, whose help may say what the port counts."""
    jt = jtelemetry.METRIC_TABLE
    for name, row in telemetry.METRIC_TABLE.items():
        assert name in jt, name
        assert row["type"] == jt[name]["type"], name
        assert tuple(row["labels"]) == tuple(jt[name]["labels"]), name
        assert row.get("max_label_sets") == jt[name].get("max_label_sets")
        if name in TRIMMED_HELP:
            assert jt[name]["help"].startswith(row["help"]), name
            assert dict(row, help=None) == dict(jt[name], help=None), name
        elif name not in LEDGER_ROWS:
            assert row == jt[name], name
    assert set(LEDGER_ROWS) <= set(telemetry.METRIC_TABLE)
    assert set(DATA_PLANE_ROWS) <= set(telemetry.METRIC_TABLE)
    # the one bucket layout
    assert telemetry.LATENCY_BUCKETS_S == jtelemetry.LATENCY_BUCKETS_S
    assert telemetry.OVERFLOW_LABEL == jtelemetry.OVERFLOW_LABEL
    assert telemetry.REGISTRY.max_label_sets == 64


def _train(rounds=4, **extra):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1500, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    params = dict(objective="binary", num_leaves=15, verbose=-1,
                  device_type="cpu", **extra)
    return lt.train(params, lt.Dataset(X, label=y), rounds,
                    verbose_eval=False)


def test_training_instruments_and_sync_audit_gauges():
    """Every Booster.update runs inside train_iteration: the iteration
    histogram and counter, the per-iteration sync gauges and the sync
    bridge's counters by label.  At pipeline_depth=0 each iteration pays
    1 blocking sync, the tree's fetch, on the critical path; at the
    default pipeline_depth=1 the critical-path gauge is 0 and the fetches
    are the assembler's pipeline_drain (the JAX package's pin)."""
    it_hist = telemetry.histogram("lgbm_train_iteration_seconds")
    it_cnt = telemetry.counter("lgbm_train_iterations_total")
    fetches = telemetry.counter("lgbm_host_syncs_total")
    h0, c0 = it_hist.state()["count"], it_cnt.total()
    f0 = fetches.value(label="tree_fetch")
    _train(rounds=5, pipeline_depth=0)
    assert it_cnt.total() == c0 + 5
    assert it_hist.state()["count"] == h0 + 5
    g = telemetry.gauge("lgbm_train_host_syncs_per_iter")
    assert g.value(path="total") == 1.0
    assert g.value(path="critical") == 1.0
    assert fetches.value(label="tree_fetch") == f0 + 5
    assert telemetry.counter("lgbm_host_syncs_critical_total").value(
        label="tree_fetch") >= 5
    d0 = telemetry.histogram("lgbm_pipeline_drain_seconds").state()["count"]
    p0 = fetches.value(label="pipeline_drain")
    _train(rounds=5)
    assert it_cnt.total() == c0 + 10
    assert g.value(path="critical") == 0.0
    assert fetches.value(label="pipeline_drain") == p0 + 5
    assert fetches.value(label="tree_fetch") == f0 + 5
    assert telemetry.histogram(
        "lgbm_pipeline_drain_seconds").state()["count"] == d0 + 5


def test_telemetry_disabled_training_still_works():
    prev = telemetry.set_enabled(False)
    try:
        c0 = telemetry.counter("lgbm_train_iterations_total").total()
        s0 = syncs.snapshot()
        bst = _train(rounds=2)
        assert bst.current_iteration() == 2
        assert telemetry.counter(
            "lgbm_train_iterations_total").total() == c0
        # the sync seam's own counters keep counting (the trees' fetches,
        # the assembler's at the default pipeline_depth=1)
        assert syncs.delta(s0)["by_label"]["pipeline_drain"] == 2
    finally:
        telemetry.set_enabled(prev)


def test_metrics_file_env_and_training(tmp_path, monkeypatch):
    """$LGBM_TPU_METRICS_FILE: one writer per process; a flush after
    training carries the iteration counter."""
    path = str(tmp_path / "m.jsonl")
    monkeypatch.setenv(telemetry.METRICS_FILE_ENV, path)
    monkeypatch.setenv(telemetry.METRICS_INTERVAL_ENV, "0")
    monkeypatch.setattr(telemetry, "_file_writer", None)
    w = telemetry.maybe_start_file_export("unit")
    assert w is telemetry.maybe_start_file_export("unit")
    _train(rounds=2)
    assert telemetry.write_snapshot_now("after") == path
    last = json.loads(open(path).read().splitlines()[-1])
    assert last["context"] == "after"
    assert last["metrics"]["lgbm_train_iterations_total"]["series"][0][
        "value"] >= 2
    monkeypatch.delenv(telemetry.METRICS_FILE_ENV)
    monkeypatch.setattr(telemetry, "_file_writer", None)
    assert telemetry.maybe_start_file_export() is None


def test_profiler_hook_wraps_n_ticks(tmp_path, monkeypatch):
    """LGBM_TPU_PROFILE=<dir>: the first N ticks land in ONE torch.profiler
    trace under <dir>/train (CPU activity off the card), closed at the end
    of the N-th tick's work; then the hook is done."""
    monkeypatch.setenv(telemetry.PROFILE_ENV, str(tmp_path))
    monkeypatch.setenv(telemetry.PROFILE_ITERS_ENV, "2")
    telemetry._reset_profile_hooks()
    try:
        hook = telemetry.profile_hook("train")
        assert hook.limit == 2 and not hook.done
        hook.tick(torch.device("cpu"))
        hook.tock()
        assert hook.active and not hook.done and not hook.cuda
        hook.tick(torch.device("cpu"))
        hook.tock()
        assert hook.done and not hook.active
        hook.tick()                        # one-shot: further ticks no-op
        files = glob.glob(str(tmp_path / "train" / "*.json"))
        assert files == [hook.path]
        assert json.load(open(hook.path))["traceEvents"]
    finally:
        telemetry._reset_profile_hooks()


def test_profiler_hook_in_training(tmp_path, monkeypatch):
    monkeypatch.setenv(telemetry.PROFILE_ENV, str(tmp_path))
    monkeypatch.setenv(telemetry.PROFILE_ITERS_ENV, "2")
    telemetry._reset_profile_hooks()
    try:
        a = _train(rounds=3)
        hook = telemetry.profile_hook("train")
        assert hook.done and hook.ticks == 2
        names = {e.get("name") for e in
                 json.load(open(hook.path))["traceEvents"]}
        assert any("index_add" in str(n) or "aten::" in str(n)
                   for n in names)
    finally:
        telemetry._reset_profile_hooks()
    monkeypatch.delenv(telemetry.PROFILE_ENV)
    assert a.model_to_string() == _train(rounds=3).model_to_string()


def test_profiler_failure_says_so_and_training_goes_on(tmp_path,
                                                       monkeypatch, capsys):
    """A profiler that cannot start disables the hook loudly (stderr and
    the log); training goes on, on the device it was on."""
    monkeypatch.setenv(telemetry.PROFILE_ENV, str(tmp_path))
    telemetry._reset_profile_hooks()
    import torch.profiler as tp

    def broken(*a, **k):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(tp, "profile", broken)
    try:
        bst = _train(rounds=2)
        hook = telemetry.profile_hook("train")
        assert hook.done and not hook.active
        assert bst.device.type == "cpu" and bst.current_iteration() == 2
        assert "profiler hook disabled" in capsys.readouterr().err
    finally:
        telemetry._reset_profile_hooks()


def test_serving_profile_hook_is_not_ported(monkeypatch, tmp_path):
    """The serve hook is ported with serving: one trace over the first
    $LGBM_TPU_PROFILE_BATCHES device-served batches; an unknown kind is
    refused."""
    monkeypatch.setenv(telemetry.PROFILE_ENV, str(tmp_path))
    monkeypatch.setenv(telemetry.PROFILE_BATCHES_ENV, "2")
    telemetry._reset_profile_hooks()
    try:
        hook = telemetry.profile_hook("serve")
        assert hook.kind == "serve" and hook.limit == 2
        assert telemetry.profile_hook("serve") is hook
        for _ in range(3):
            hook.tick()
            hook.tock()
        assert hook.done and not hook.active and hook.ticks == 2
        assert hook.path and hook.path.endswith(".json")
        with pytest.raises(ValueError, match="unknown profile hook"):
            telemetry.profile_hook("fleet")
    finally:
        telemetry._reset_profile_hooks()


def test_gather_refuses_several_processes(monkeypatch):
    """With several processes gather_host_snapshots no longer refuses: it
    gathers every rank's snapshot through the group's object all-gather
    (here a stand-in for the two-rank group of test_torch_launch.py)."""
    from lightgbm_tpu_torch.parallel import comm
    monkeypatch.setattr(telemetry, "mesh_process_count", lambda: 2)
    monkeypatch.setattr(comm, "all_gather_object",
                        lambda obj, group=None: [obj, {"peer": True}])
    hosts = telemetry.gather_host_snapshots()
    assert list(hosts) == ["0", "1"] and hosts["1"] == {"peer": True}
    monkeypatch.setattr(telemetry, "mesh_process_count", lambda: 1)
    assert list(telemetry.gather_host_snapshots()) == ["0"]
