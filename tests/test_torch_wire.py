"""The port's binary wire plane (lightgbm_tpu_torch/runtime/wire.py) on
the CPU (``device_type=cpu``), against the JAX package's
(lightgbm_tpu/runtime/wire.py and tests/test_serving.py's wire tests):
the JSON path's values byte for byte over TCP and the Unix socket, the
torn-frame classes, the backoff hints, the response scratch (the JAX
package's frames byte for byte, no allocation per response), the stale
and the live socket path, one frame in flight per connection, the frame
layouts against the JAX package's and the C header, and either
package's client against the other's server."""
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.runtime import wire as jwire
from lightgbm_tpu_torch.runtime import serving, wire
from lightgbm_tpu_torch.runtime.serving import (ServeRejected,
                                                ServingRuntime,
                                                ServingServer, retry_delay)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CPU = {"device_type": "cpu"}


def _synth_model(n_trees=16, num_leaves=15, n_feat=6, seed=1):
    from bench import synth_serving_model
    return synth_serving_model(n_trees, num_leaves, n_feat,
                               seed=seed).save_model_to_string()


def _booster(text):
    return lt.Booster(params=dict(CPU), model_str=text)


def _runtime(**kw):
    kw.setdefault("params", dict(CPU))
    kw.setdefault("batch_window_s", 0.0)
    return ServingRuntime(**kw)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _wire_pair(rt, tmp_path):
    srv = _serve(wire.WireTCPServer(rt, port=0))
    uds_path = str(tmp_path / "wire.sock")
    usrv = _serve(wire.WireUnixServer(rt, uds_path))
    return srv, usrv, uds_path


def _stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


def test_layouts_are_the_jax_packages():
    """The frame layouts are the contract: every constant and format is
    the JAX package's."""
    for name in ("HEADER_FIELDS", "HEADER_FMT", "HEADER_SIZE", "MAGIC",
                 "VERSION", "MSG_REQUEST", "MSG_RESPONSE", "MSG_REJECT",
                 "MSG_SHM_SETUP", "MSG_SHM_OK", "DTYPE_F32",
                 "RESP_META_FMT", "RESP_META_SIZE", "REJ_META_FMT",
                 "REJ_META_SIZE", "MAX_PAYLOAD", "MAX_COLS"):
        assert getattr(wire, name) == getattr(jwire, name), name
    assert wire.HEADER_SIZE == 40 and wire.RESP_META_SIZE == 32
    X = np.random.default_rng(3).standard_normal((3, 6))
    assert wire.pack_request(X, "m", priority=2) == \
        jwire.pack_request(X, "m", priority=2)
    assert wire.pack_reject("queue_full", True, 0.25, "m") == \
        jwire.pack_reject("queue_full", True, 0.25, "m")
    stages = {"queue_wait_s": 0.5, "batch_gather_s": 0.25,
              "device_s": 0.125, "drain_s": 0.0625}
    assert wire.pack_response(X[:, :2], 7, "m", "device", 0.75, stages,
                              True) == \
        jwire.pack_response(X[:, :2], 7, "m", "device", 0.75, stages, True)


def test_check_wire_abi_passes_on_the_port_modules():
    """helper/check_wire_abi.py, unedited, on the port's two module texts:
    their HEADER_FIELDS and RING_HEADER_FIELDS tuples agree with the C
    header's token lines and size macros."""
    sys.path.insert(0, os.path.join(REPO, "helper"))
    import check_wire_abi
    pkg = os.path.join(REPO, "lightgbm_tpu_torch", "runtime")
    with open(os.path.join(pkg, "wire.py")) as fh:
        wire_text = fh.read()
    with open(os.path.join(pkg, "shm_ring.py")) as fh:
        shm_text = fh.read()
    assert check_wire_abi.run(wire_text=wire_text, shm_text=shm_text,
                              build=False) == []


def test_wire_roundtrip_matches_json_path_byte_for_byte(tmp_path):
    """The same probe through the JSON front end and through both binary
    sockets yields the same float32 bytes, with the generation, the
    runtime's served_by stamp and the stage partition on every path."""
    text = _synth_model(seed=13)
    probe = np.random.default_rng(9).standard_normal((5, 6)).astype(
        np.float32)
    with _runtime(model_str=text, response_dtype="float32") as rt:
        jsrv = _serve(ServingServer(rt))
        srv, usrv, uds_path = _wire_pair(rt, tmp_path)
        try:
            with socket.create_connection(("127.0.0.1", jsrv.port),
                                          timeout=10) as s:
                f = s.makefile("rw")
                f.write(json.dumps({"features": probe.tolist()}) + "\n")
                f.flush()
                jresp = json.loads(f.readline())
            jvals = np.asarray(jresp["values"], np.float32)
            for address in (("127.0.0.1", srv.port), uds_path):
                with wire.WireClient(address) as c:
                    out = c.predict(probe)
                assert out["generation"] == jresp["generation"] == 0
                assert out["served_by"] == jresp["served_by"] == "device"
                assert set(out["stages"]) == {"queue_wait_s",
                                              "batch_gather_s",
                                              "device_s", "drain_s"}
                assert out["values"].dtype == np.float32
                got = out["values"].reshape(jvals.shape)
                assert np.array_equal(got, jvals), address
            assert rt.stats()["batches_host"] == 0
        finally:
            _stop(jsrv, srv, usrv)


def test_wire_torn_frames_reject_machine_readably(tmp_path):
    """Every malformed frame class yields a machine-readable rejection
    frame; only an intact-boundary CRC failure keeps the connection."""
    text = _synth_model(seed=14)
    with _runtime(model_str=text) as rt:
        srv, usrv, _ = _wire_pair(rt, tmp_path)

        def raw():
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=10)
            return s, s.makefile("rb")

        def read_reject(rf):
            frame = wire.read_frame(rf)
            assert frame is not None
            rej = wire.unpack_response(*frame)
            assert rej.get("error") == "rejected"
            return rej
        try:
            s, rf = raw()
            s.sendall(wire.pack_request(np.zeros((1, 6), np.float32))[:17])
            s.shutdown(socket.SHUT_WR)
            rej = read_reject(rf)
            assert rej["reason"] == "truncated_header"
            assert rej["retryable"] is True
            assert rf.read(1) == b""
            s.close()

            s, rf = raw()
            good = wire.pack_request(np.ones((2, 6), np.float32))
            s.sendall(good[:-8])
            s.shutdown(socket.SHUT_WR)
            assert read_reject(rf)["reason"] == "short_payload"
            assert rf.read(1) == b""
            s.close()

            s, rf = raw()
            bad = bytearray(wire.pack_request(np.ones((2, 6), np.float32)))
            bad[-1] ^= 0xFF
            s.sendall(bytes(bad))
            rej = read_reject(rf)
            assert rej["reason"] == "bad_crc" and rej["retryable"] is True
            s.sendall(good)
            out = wire.unpack_response(*wire.read_frame(rf))
            assert "values" in out and out["values"].shape == (2, 1)
            s.close()

            s, rf = raw()
            hdr = wire.pack_header(wire.MSG_REQUEST, "default",
                                   n_rows=2 ** 31, n_cols=6,
                                   payload=b"\0" * 24)
            s.sendall(hdr + b"\0" * 24)
            rej = read_reject(rf)
            assert rej["reason"] == "oversized" and rej["retryable"]
            assert rf.read(1) == b""
            s.close()

            s, rf = raw()
            s.sendall(b"GET / HTTP/1.1\r\n" + b"\0" * 64)
            assert read_reject(rf)["reason"] == "bad_magic"
            assert rf.read(1) == b""
            s.close()
        finally:
            _stop(srv, usrv)


def test_wire_reject_frames_carry_backoff_hints():
    frame = wire.pack_reject("queue_full", retryable=True,
                             retry_after_s=0.25)
    rej = wire.unpack_response(*wire.read_frame(io.BytesIO(frame)))
    assert rej == jwire.unpack_response(
        *jwire.read_frame(io.BytesIO(frame)))
    assert rej["reason"] == "queue_full" and rej["retryable"] is True
    assert rej["retry_after_s"] == pytest.approx(0.25)
    assert retry_delay(0.05, rej["retry_after_s"]) == pytest.approx(0.25)
    assert retry_delay(0.5, rej["retry_after_s"]) == pytest.approx(0.5)
    e = ServeRejected("queue_full", retryable=True, retry_after_s=0.05)
    assert e.to_dict()["retry_after_s"] == pytest.approx(0.05)


def test_a_second_frame_cannot_change_the_first_answer(tmp_path):
    """One frame in flight per connection: two frames of the same size
    sent back to back land in the same bucket buffer, and each answer
    is still its own rows' offline predict (the handler reads the second
    frame only after the first's response is written); an answer never
    aliases the buffer its request was read into."""
    text = _synth_model(seed=17)
    rng = np.random.default_rng(4)
    A = rng.standard_normal((8, 6)).astype(np.float32)
    B = rng.standard_normal((8, 6)).astype(np.float32)
    bst = _booster(text)
    ref = {k: bst.predict(v, device=True).astype(np.float32)
           for k, v in (("A", A), ("B", B))}
    with _runtime(model_str=text, response_dtype="float32") as rt:
        srv = _serve(wire.WireTCPServer(rt, port=0))
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10) as s:
                rf = s.makefile("rb")
                for _ in range(5):
                    s.sendall(wire.pack_request(A) + wire.pack_request(B))
                    a = wire.unpack_response(*wire.read_frame(rf))
                    b = wire.unpack_response(*wire.read_frame(rf))
                    assert np.array_equal(a["values"][:, 0], ref["A"])
                    assert np.array_equal(b["values"][:, 0], ref["B"])
            buf = bytearray(A.tobytes())
            X = np.frombuffer(buf, np.float32).reshape(A.shape)
            rec = rt.submit_view(X).wait(timeout=30)
            buf[:] = B.tobytes()
            assert np.array_equal(rec.values, ref["A"])
        finally:
            _stop(srv)


def test_response_flags_are_the_runtimes_stamps(monkeypatch):
    """served_by and compiled on the wire are the runtime's stamps on the
    result: a batch that captured a program at the predictor's site is
    `compiled`, and a batch the breaker re-served from the host says
    `host` (its values the host predictor's, as float32)."""
    text = _synth_model(seed=18)
    probe = np.random.default_rng(5).standard_normal((4, 6)).astype(
        np.float32)
    ref_host = _booster(text).predict(probe.astype(np.float64))
    monkeypatch.delenv("LGBM_TPU_FAULT", raising=False)
    with _runtime(model_str=text, breaker_cooldown_s=30.0) as rt:
        srv = _serve(wire.WireTCPServer(rt, port=0))
        try:
            with wire.WireClient(("127.0.0.1", srv.port)) as c:
                out = c.predict(probe)
                assert (out["served_by"], out["compiled"]) == \
                    ("device", False)
                real = serving.graph_obs.total_compiles
                ticks = iter(range(100))
                monkeypatch.setattr(serving.graph_obs, "total_compiles",
                                    lambda site=None: next(ticks))
                out = c.predict(probe)
                assert (out["served_by"], out["compiled"]) == \
                    ("device", True)
                monkeypatch.setattr(serving.graph_obs, "total_compiles",
                                    real)
                monkeypatch.setenv("LGBM_TPU_FAULT", "die_at_predict:1")
                out = c.predict(probe)
                monkeypatch.delenv("LGBM_TPU_FAULT")
                assert out["served_by"] == "host"
                assert np.array_equal(out["values"][:, 0],
                                      ref_host.astype(np.float32))
            assert rt.stats()["batches_host"] == 1
        finally:
            _stop(srv)


def test_wire_response_scratch_parity_and_zero_allocation():
    """`_ResponseScratch` emits the module-level frames (and the JAX
    package's) byte for byte and allocates nothing per response."""
    rng = np.random.default_rng(21)
    scratch = wire._ResponseScratch()
    stages = {"queue_wait_s": 0.001, "batch_gather_s": 0.0002,
              "device_s": 0.003, "drain_s": 0.0001}
    cases = [
        (rng.standard_normal((4, 1)).astype(np.float32), 3, "default",
         "device", True),
        (rng.standard_normal((4, 1)), 3, "default", "device", True),
        (rng.standard_normal((7, 3)), 12, "tenant-042", "host", False),
        (rng.standard_normal(5), 1, "default", "device", False),
        (rng.standard_normal((700, 4)), 2, "big", "device", True),
        (rng.standard_normal((2, 2)), 9, "default", "host", True),
    ]
    for vals, gen, mid, by, compiled in cases:
        want = wire.pack_response(vals, gen, mid, by, 0.0125, stages,
                                  compiled)
        assert want == jwire.pack_response(vals, gen, mid, by, 0.0125,
                                           stages, compiled)
        got = bytes(scratch.pack_response(vals, gen, mid, by, 0.0125,
                                          stages, compiled))
        assert got == want, (vals.shape, vals.dtype)
    buf = scratch._buf
    small = rng.standard_normal((8, 2))
    for _ in range(200):
        scratch.pack_response(small, 5, "default", "device", 0.001,
                              stages, True)
        assert scratch._buf is buf
    arenas = dict(scratch._f32)
    for _ in range(50):
        scratch.pack_response(small, 5, "default", "device", 0.001,
                              stages, True)
    assert dict(scratch._f32) == arenas
    for bucket, arr in scratch._f32.items():
        assert arenas[bucket] is arr
    f32 = np.ascontiguousarray(small, np.float32)
    assert scratch._as_f32(f32) is f32
    scratch.pack_response(rng.standard_normal((4096, 8)), 1, "default",
                          "device", 0.0, stages, True)
    grown = scratch._buf
    assert grown is not buf and len(grown) & (len(grown) - 1) == 0
    scratch.pack_response(rng.standard_normal((4096, 8)), 1, "default",
                          "device", 0.0, stages, True)
    assert scratch._buf is grown


def test_wire_server_success_path_allocates_no_response_frames(
        monkeypatch):
    """With module-level `pack_response` booby-trapped every successful
    response still arrives: the handler packs from its scratch."""
    text = _synth_model(seed=16)
    probe = np.random.default_rng(11).standard_normal((6, 6)).astype(
        np.float32)

    def _boom(*a, **k):
        raise AssertionError("module-level pack_response reached from "
                             "the server's success path")
    monkeypatch.setattr(wire, "pack_response", _boom)
    with _runtime(model_str=text, response_dtype="float32") as rt:
        ref = np.asarray(rt.predict(np.asarray(probe, np.float64)).values)
        srv = _serve(wire.WireTCPServer(rt, port=0))
        try:
            with wire.WireClient(("127.0.0.1", srv.port)) as c:
                for _ in range(8):
                    out = c.predict(probe)
                    assert np.array_equal(
                        out["values"].reshape(ref.shape), ref)
                rej = c.request_once(probe, model_id="no-such-tenant")
                assert rej.get("error") == "rejected"
        finally:
            _stop(srv)


_UDS_HOLDER = """
import socket, sys
s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
s.bind(sys.argv[1])
s.listen(8)
print("ready", flush=True)
import time; time.sleep(120)
"""


def test_wire_uds_rebinds_over_stale_path_after_kill(tmp_path):
    """A SIGKILLed server leaves its socket file; a new server probes,
    finds nobody listening, unlinks it and binds."""
    path = str(tmp_path / "replica.sock")
    proc = subprocess.Popen([sys.executable, "-c", _UDS_HOLDER, path],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert os.path.exists(path)
    text = _synth_model(seed=41)
    probe = np.random.default_rng(12).standard_normal((4, 6)).astype(
        np.float32)
    with _runtime(model_str=text, response_dtype="float32") as rt:
        usrv = _serve(wire.WireUnixServer(rt, path))
        try:
            ref = np.asarray(rt.predict(
                np.asarray(probe, np.float64)).values)
            with wire.WireClient(path) as c:
                out = c.predict(probe)
            assert np.array_equal(out["values"].reshape(ref.shape), ref)
        finally:
            _stop(usrv)


def test_wire_uds_refuses_to_unlink_live_server_path(tmp_path):
    path = str(tmp_path / "live.sock")
    text = _synth_model(seed=42)
    with _runtime(model_str=text) as rt:
        usrv = _serve(wire.WireUnixServer(rt, path))
        try:
            with pytest.raises(OSError, match="LIVE"):
                wire.WireUnixServer(rt, path)
            assert os.path.exists(path)
        finally:
            _stop(usrv)


# -- either package's client against the other's server -------------------

HEAD = ("generation", "model", "served_by", "compiled")


def _decoded(out):
    return {k: out[k] for k in HEAD}, np.array(out["values"], copy=True)


def test_jax_client_against_the_port_servers(tmp_path):
    """The JAX package's WireClient against the port's TCP and Unix
    servers: its decoded header fields and f32 values equal the port
    client's, and the values are the JAX package's offline predict
    within rtol 1e-5."""
    from lightgbm_tpu.basic import Booster as JBooster
    text = _synth_model(seed=43)
    probe = np.random.default_rng(13).standard_normal((9, 6)).astype(
        np.float32)
    jref = JBooster(model_str=text).predict(probe.astype(np.float64),
                                            device=True)
    with _runtime(model_str=text, response_dtype="float32") as rt:
        srv, usrv, uds_path = _wire_pair(rt, tmp_path)
        try:
            for address in (("127.0.0.1", srv.port), uds_path):
                with wire.WireClient(address) as c:
                    mine = _decoded(c.predict(probe))
                with jwire.WireClient(address) as c:
                    theirs = _decoded(c.predict(probe))
                assert mine[0] == theirs[0] == {
                    "generation": 0, "model": "default",
                    "served_by": "device", "compiled": mine[0]["compiled"]}
                assert np.array_equal(mine[1], theirs[1])
                np.testing.assert_allclose(theirs[1][:, 0], jref,
                                           rtol=1e-5, atol=1e-6)
        finally:
            _stop(srv, usrv)


def test_port_client_against_the_jax_server():
    """The port's WireClient against the JAX package's TCP server: what it
    decodes is what the JAX client decodes, and the values are the
    port's offline predict within rtol 1e-5."""
    from lightgbm_tpu.runtime.serving import ServingRuntime as JRuntime
    text = _synth_model(seed=44)
    probe = np.random.default_rng(14).standard_normal((9, 6)).astype(
        np.float32)
    ref = _booster(text).predict(probe, device=True)
    with JRuntime(model_str=text, batch_window_s=0.0,
                  response_dtype="float32") as jrt:
        jsrv = _serve(jwire.WireTCPServer(jrt, port=0))
        try:
            with wire.WireClient(("127.0.0.1", jsrv.port)) as c:
                mine = _decoded(c.predict(probe))
            with jwire.WireClient(("127.0.0.1", jsrv.port)) as c:
                theirs = _decoded(c.predict(probe))
            assert mine[0] == theirs[0]
            assert mine[0]["generation"] == 0
            assert np.array_equal(mine[1], theirs[1])
            np.testing.assert_allclose(mine[1][:, 0], ref, rtol=1e-5,
                                       atol=1e-6)
        finally:
            _stop(jsrv)


def test_frame_header_struct_is_forty_bytes():
    hdr = wire.pack_header(wire.MSG_REQUEST, "x" * 40, 1, 2, b"abcdefgh")
    assert len(hdr) == 40
    fields = struct.unpack(wire.HEADER_FMT, hdr)
    assert fields[5] == b"x" * 16 and fields[6:9] == (1, 2, 8)
