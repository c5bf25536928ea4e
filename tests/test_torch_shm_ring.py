"""The port's shared-memory ring transport
(lightgbm_tpu_torch/runtime/shm_ring.py) on the CPU (``device_type=cpu``),
mirroring the JAX package's tests/test_shm_ring.py: the ring plane's
values are the socket plane's byte for byte; wraparound across the
segment boundary; a full ring as a typed retryable reject; a corrupt CRC
rejected without desynchronizing the counters; a client killed by
``die_at_ring`` reclaimed with no leaked mapping while the server keeps
serving; the setup refused on TCP and on a lying config; the segment
header against the JAX package's.  Across the packages: the JAX
package's ShmClient against the port's Unix server.
"""
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.runtime import shm_ring as jshm
from lightgbm_tpu_torch.runtime import shm_ring, wire
from lightgbm_tpu_torch.runtime import serving as _serving

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def ServingRuntime(**kw):
    """The port's runtime on the CPU."""
    kw.setdefault("params", {"device_type": "cpu"})
    return _serving.ServingRuntime(**kw)


def _synth_model(n_trees=16, num_leaves=15, n_feat=6, seed=1):
    from bench import synth_serving_model
    return synth_serving_model(n_trees, num_leaves, n_feat,
                               seed=seed).save_model_to_string()


def _booster(text):
    return lt.Booster(params={"device_type": "cpu"}, model_str=text)


def _uds_server(rt, tmp_path, name="ring.sock"):
    path = str(tmp_path / name)
    usrv = wire.WireUnixServer(rt, path)
    threading.Thread(target=usrv.serve_forever, daemon=True).start()
    return usrv, path


def _stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


def _wait_session_end(before, deadline_s=20.0):
    """Block until the server counts one more session teardown than
    ``before`` did (closed/reclaimed/torn) — teardown runs on the
    handler thread after the client socket closes."""
    ended = lambda s: s["closed"] + s["reclaimed"] + s["torn"]  # noqa: E731
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if ended(shm_ring.stats_snapshot()) > ended(before):
            return shm_ring.stats_snapshot()
        time.sleep(0.02)
    raise AssertionError("shm session never tore down: %r vs %r"
                         % (shm_ring.stats_snapshot(), before))


def _maps_count() -> int:
    with open("/proc/self/maps") as fh:
        return fh.read().count("lgbm-shm-ring")


@pytest.fixture()
def clean_fault_env():
    old = os.environ.pop("LGBM_TPU_FAULT", None)
    yield
    if old is None:
        os.environ.pop("LGBM_TPU_FAULT", None)
    else:
        os.environ["LGBM_TPU_FAULT"] = old


# ---------------------------------------------------------------------------
# parity: the ring plane must be byte-identical to the socket plane
# ---------------------------------------------------------------------------

def test_shm_roundtrip_matches_socket_plane_byte_for_byte(tmp_path):
    text = _synth_model(seed=31)
    probe = np.random.default_rng(5).standard_normal((7, 6)).astype(
        np.float32)
    ref = np.asarray(_booster(text).predict(probe, device=True),
                     np.float32)
    with ServingRuntime(model_str=text, batch_window_s=0.0,
                        response_dtype="float32") as rt:
        usrv, uds_path = _uds_server(rt, tmp_path)
        try:
            with wire.WireClient(uds_path) as wc:
                sock_out = wc.predict(probe)
            with shm_ring.ShmClient(uds_path) as c:
                out = c.request_once(probe)
                assert "error" not in out, out
                assert out["generation"] == sock_out["generation"]
                assert out["served_by"] == sock_out["served_by"] == "device"
                assert set(out["stages"]) == {"queue_wait_s",
                                              "batch_gather_s",
                                              "device_s", "drain_s"}
                got = np.array(out["values"]).reshape(ref.shape)
                assert np.array_equal(got, ref)
                assert np.array_equal(
                    got, sock_out["values"].reshape(ref.shape))
        finally:
            _stop(usrv)


# ---------------------------------------------------------------------------
# wraparound: frames stay contiguous across the segment boundary
# ---------------------------------------------------------------------------

def test_shm_wraparound_on_small_rings_stays_byte_verified(tmp_path):
    """Minimum-capacity rings force both rings to wrap many times in a
    60-request run; every response must still be byte-identical and the
    wrap path must actually have been exercised (ring.wraps > 0)."""
    text = _synth_model(seed=32)
    rng = np.random.default_rng(6)
    with ServingRuntime(model_str=text, batch_window_s=0.0,
                        response_dtype="float32") as rt:
        usrv, uds_path = _uds_server(rt, tmp_path)
        bst = _booster(text)
        try:
            with shm_ring.ShmClient(
                    uds_path,
                    req_capacity=shm_ring.MIN_CAPACITY,
                    resp_capacity=shm_ring.MIN_CAPACITY) as c:
                for k in range(60):
                    X = rng.standard_normal((5, 6)).astype(np.float32)
                    ref = np.asarray(bst.predict(X, device=True),
                                     np.float32)
                    out = c.request_once(X)
                    assert "error" not in out, (k, out)
                    assert np.array_equal(
                        np.array(out["values"]).reshape(ref.shape), ref), k
                # 60 x ~160B frames through a 4KiB ring: the producer
                # must have hit the boundary and written wrap markers
                assert c.req.wraps > 0
        finally:
            _stop(usrv)


# ---------------------------------------------------------------------------
# backpressure: a full request ring is a typed retryable reject
# ---------------------------------------------------------------------------

def test_shm_full_ring_rejects_machine_readably_then_recovers(tmp_path):
    """Frames sized at ~95% of the ring: the second unread submit must
    come back as the machine-readable retryable ``ring_full`` dict
    BEFORE any byte moves, and the session must recover to byte-exact
    service once the ring drains."""
    text = _synth_model(seed=33)
    X = np.random.default_rng(7).standard_normal((160, 6)).astype(
        np.float32)                     # frame = 40 + 3840 of 4096
    ref = np.asarray(_booster(text).predict(X, device=True), np.float32)
    with ServingRuntime(model_str=text, batch_window_s=0.0,
                        response_dtype="float32") as rt:
        usrv, uds_path = _uds_server(rt, tmp_path)
        try:
            with shm_ring.ShmClient(
                    uds_path,
                    req_capacity=shm_ring.MIN_CAPACITY) as c:
                rej, accepted = None, 0
                for _ in range(50):
                    out = c.submit_nowait(X)
                    if out is None:
                        accepted += 1
                        continue
                    rej = out
                    break
                assert rej is not None, "ring never filled"
                assert accepted >= 1
                assert rej == {"error": "rejected", "reason": "ring_full",
                               "retryable": True, "retry_after_s": 0.002}
                # the reject moved no bytes: in-flight count unchanged
                assert c.inflight == accepted
                for _ in range(accepted):
                    out = c.read_response()
                    assert "error" not in out, out
                    assert np.array_equal(
                        np.array(out["values"]).reshape(ref.shape), ref)
                # drained: the same frame that was rejected now fits
                out = c.request_once(X)
                assert "error" not in out, out
                assert np.array_equal(
                    np.array(out["values"]).reshape(ref.shape), ref)
        finally:
            _stop(usrv)


# ---------------------------------------------------------------------------
# CRC corruption: reject the frame, keep the counters
# ---------------------------------------------------------------------------

def test_shm_crc_corrupt_frame_rejected_without_desync(tmp_path):
    """A frame whose boundary is intact but whose CRC lies gets the
    socket plane's non-fatal bad_crc reject IN ORDER, and the very next
    frame through the same rings is byte-verified — the sequence
    counters never desynchronized."""
    text = _synth_model(seed=34)
    X = np.random.default_rng(8).standard_normal((4, 6)).astype(
        np.float32)
    ref = np.asarray(_booster(text).predict(X, device=True), np.float32)
    with ServingRuntime(model_str=text, batch_window_s=0.0,
                        response_dtype="float32") as rt:
        usrv, uds_path = _uds_server(rt, tmp_path)
        before = shm_ring.stats_snapshot()
        try:
            with shm_ring.ShmClient(uds_path) as c:
                payload = X.tobytes()
                bad_crc = (zlib.crc32(payload) ^ 0xDEADBEEF) & 0xFFFFFFFF
                need = wire.HEADER_SIZE + len(payload)
                off, pad, tail = c.req.reserve(need)
                c._mm[off + wire.HEADER_SIZE:off + need] = payload
                struct.pack_into(
                    wire.HEADER_FMT, c._mm, off, wire.MAGIC,
                    wire.VERSION, wire.MSG_REQUEST, wire.DTYPE_F32, 0,
                    wire._pad_model_id("default"), X.shape[0],
                    X.shape[1], len(payload), bad_crc)
                c.req.publish(tail, pad, need)
                c.inflight += 1
                c.bell.ring_peer(c.req, c.efd_req, c.doorbells)
                out = c.read_response()
                assert out.get("error") == "rejected", out
                assert out["reason"] == "bad_crc"
                assert out["retryable"] is True
                # counters intact: the next frame completes byte-exact
                out = c.request_once(X)
                assert "error" not in out, out
                assert np.array_equal(
                    np.array(out["values"]).reshape(ref.shape), ref)
            after = _wait_session_end(before)
            # corrupt BYTES are not a torn RING: the session closed
            # cleanly, nothing was counted as torn
            assert after["torn"] == before["torn"]
        finally:
            _stop(usrv)


# ---------------------------------------------------------------------------
# crashed-client reclamation: die_at_ring leaves nothing behind
# ---------------------------------------------------------------------------

_DIE_CLIENT = """
import sys
sys.path.insert(0, %r)
import numpy as np
from lightgbm_tpu_torch.runtime import shm_ring
c = shm_ring.ShmClient(sys.argv[1], resp_capacity=shm_ring.MIN_CAPACITY)
X = np.ones((160, 6), np.float32)
for _ in range(8):
    out = c.submit_nowait(X)
    assert out is None, out
print("fault never fired", file=sys.stderr)
sys.exit(3)
"""


def test_shm_die_at_ring_reclaims_with_zero_leaked_mappings(
        tmp_path, clean_fault_env):
    """The worst reclamation case, armed by the ``die_at_ring:6`` fault:
    a client killed the instant its 6th frame is published, with a
    response ring too small for the unread responses — so the server is
    mid-_reserve_resp with live admissions aliasing the mapped segment
    when the peer dies.  It must drain, unmap with zero leaked
    mappings, count the reclamation, and keep a second live client
    byte-verified."""
    text = _synth_model(seed=35)
    probe = np.random.default_rng(9).standard_normal((6, 6)).astype(
        np.float32)
    ref = np.asarray(_booster(text).predict(probe, device=True),
                     np.float32)
    with ServingRuntime(model_str=text, batch_window_s=0.0,
                        response_dtype="float32") as rt:
        usrv, uds_path = _uds_server(rt, tmp_path)
        try:
            before = shm_ring.stats_snapshot()
            maps_before = _maps_count()
            env = dict(os.environ, LGBM_TPU_FAULT="die_at_ring:6")
            proc = subprocess.run(
                [sys.executable, "-c", _DIE_CLIENT % REPO, uds_path],
                env=env, capture_output=True, text=True, timeout=120)
            assert proc.returncode == 137, (proc.returncode, proc.stderr)
            assert "FAULT die_at_ring" in proc.stderr
            after = _wait_session_end(before)
            assert after["sessions"] == before["sessions"] + 1
            assert after["reclaimed"] == before["reclaimed"] + 1, after
            assert after["torn"] == before["torn"]
            # zero leaked mappings: the dead client's segment is gone
            deadline = time.monotonic() + 10.0
            while _maps_count() > maps_before and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert _maps_count() == maps_before
            # the blast radius was one session: a fresh client on the
            # same server is still byte-verified
            with shm_ring.ShmClient(uds_path) as c:
                out = c.request_once(probe)
                assert "error" not in out, out
                assert np.array_equal(
                    np.array(out["values"]).reshape(ref.shape), ref)
        finally:
            _stop(usrv)


# ---------------------------------------------------------------------------
# plane boundary: setup needs AF_UNIX, and a lying setup frame rejects
# ---------------------------------------------------------------------------

def test_shm_setup_rejected_on_tcp_and_on_bad_config(tmp_path):
    text = _synth_model(seed=36)
    with ServingRuntime(model_str=text, batch_window_s=0.0,
                        response_dtype="float32") as rt:
        srv = wire.WireTCPServer(rt, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        usrv, uds_path = _uds_server(rt, tmp_path)
        cfg = shm_ring.pack_ring_config()
        setup = wire.pack_header(wire.MSG_SHM_SETUP, "shm", 0, 0,
                                 cfg) + cfg
        try:
            # TCP cannot pass fds: non-retryable, fall back, don't retry
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10) as s:
                s.sendall(setup)
                hdr, payload = wire.read_frame(s.makefile("rb"))
                out = wire.unpack_response(hdr, bytes(payload))
            assert out == {"error": "rejected",
                           "reason": "shm_requires_uds",
                           "retryable": False, "retry_after_s": 0.0}
            # a config with impossible offsets rejects on the UDS plane
            bad = bytearray(cfg)
            bad[8:16] = struct.pack("<Q", 123)       # seg_size field
            frame = wire.pack_header(wire.MSG_SHM_SETUP, "shm", 0, 0,
                                     bytes(bad)) + bytes(bad)
            with socket.socket(socket.AF_UNIX,
                               socket.SOCK_STREAM) as s:
                s.settimeout(10)
                s.connect(uds_path)
                s.sendall(frame)
                hdr, payload = wire.read_frame(s.makefile("rb"))
                out = wire.unpack_response(hdr, bytes(payload))
            assert out["error"] == "rejected"
            assert out["reason"].startswith("shm_bad_setup")
            assert out["retryable"] is False
        finally:
            _stop(srv, usrv)


# ---------------------------------------------------------------------------
# the pinned layout helpers
# ---------------------------------------------------------------------------

def test_ring_config_roundtrip_and_validation():
    cfg = shm_ring.unpack_ring_config(shm_ring.pack_ring_config())
    assert cfg["req_ctrl"] == 64 and cfg["resp_ctrl"] == 256
    assert cfg["req_offset"] == 448
    assert cfg["seg_size"] == (448 + cfg["req_capacity"]
                               + cfg["resp_capacity"])
    assert shm_ring.RING_HEADER_SIZE == 40
    with pytest.raises(shm_ring.ShmError):
        shm_ring.unpack_ring_config(b"XXXX" + b"\0" * 36)
    with pytest.raises(shm_ring.ShmError):        # 1000 not a power of 2
        shm_ring.unpack_ring_config(shm_ring._RING_HEADER.pack(
            shm_ring.RING_MAGIC, shm_ring.RING_VERSION, 0, 0,
            448 + 1000 + 4096, 64, 448, 1000, 256, 448 + 1000, 4096))
    assert shm_ring.RING_HEADER_FIELDS == jshm.RING_HEADER_FIELDS
    assert shm_ring.pack_ring_config(1 << 14, 1 << 13) == \
        jshm.pack_ring_config(1 << 14, 1 << 13)
    for name in ("RING_MAGIC", "RING_VERSION", "REQ_CTRL_OFF",
                 "RESP_CTRL_OFF", "DATA_OFF", "WRAP_MARK", "MIN_CAPACITY",
                 "MAX_CAPACITY"):
        assert getattr(shm_ring, name) == getattr(jshm, name), name


def test_jax_shm_client_against_the_port_server(tmp_path):
    """The JAX package's ShmClient on the port's Unix server: what it
    decodes is what the port's ShmClient decodes (header fields and f32
    values), and the values are the JAX package's offline predict within
    rtol 1e-5."""
    from lightgbm_tpu.basic import Booster as JBooster
    text = _synth_model(seed=37)
    probe = np.random.default_rng(15).standard_normal((7, 6)).astype(
        np.float32)
    jref = JBooster(model_str=text).predict(probe.astype(np.float64),
                                            device=True)
    head = ("generation", "model", "served_by", "compiled")
    with ServingRuntime(model_str=text, batch_window_s=0.0,
                        response_dtype="float32") as rt:
        usrv, uds_path = _uds_server(rt, tmp_path)
        try:
            got = []
            for cls in (shm_ring.ShmClient, jshm.ShmClient):
                with cls(uds_path) as c:
                    out = c.request_once(probe)
                    assert "error" not in out, out
                    got.append(({k: out[k] for k in head},
                                np.array(out["values"])))
            (mine, mv), (theirs, tv) = got
            assert mine == theirs
            assert mine["served_by"] == "device"
            assert np.array_equal(mv, tv)
            np.testing.assert_allclose(tv[:, 0], jref, rtol=1e-5,
                                       atol=1e-6)
            assert rt.stats()["batches_host"] == 0
        finally:
            _stop(usrv)
