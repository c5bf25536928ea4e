"""Binary serving data plane (counterpart of lightgbm_tpu/runtime/wire.py).

The JSON-lines front end (`serving.ServingServer`) parses one JSON
object per request; at serving rates the JSON decode, the per-request
float64 copy and the response re-encode cost more than the predict.
This module is the wire-speed path beside it, frame for frame the JAX
package's, so a client of either package talks to a server of either:

* **Length-prefixed binary frames.**  A fixed 40-byte little-endian
  header (magic, version, msg type, dtype, flags, NUL-padded model id,
  row/col counts, payload length, CRC32) followed by a float32
  row-major feature payload.  The layout is mirrored field for field by
  ``cpp/lightgbm_tpu_c_api.h`` (``WIRE_FRAME_FIELDS`` /
  ``LGBMWireFrameHeader``); ``helper/check_wire_abi.py`` lints the two
  against each other token for token.
* **Zero-copy request path.**  Each connection owns a small pool of
  preallocated per-bucket receive buffers; the payload is read with
  ``readinto`` straight into the bucket buffer and submitted as a numpy
  view of those bytes (`ServingRuntime.submit_view`): no per-request
  allocation, no float64 conversion.  The batcher gathers a batch of
  several views into its own per-bucket arena, and the device predictor
  copies its rows into its pinned staging slot on the host before the
  asynchronous host-to-device copy (`DevicePredictor._run_card`), so the
  receive buffer is read only on the host and only before the predict
  returns.  One frame is in flight per connection: the handler reads the
  next frame into the same bucket buffer only after the response is
  written, which comes after the predictor's output was fetched from
  the card, so a later frame can never change an earlier answer.
* **Response and rejection frames with JSON parity.**  Responses carry
  the generation, ``served_by``, the ``compiled`` flag and the
  ``stages`` partition (queue_wait / batch_gather / device / drain) as a
  fixed meta block before the float32 values.  ``served_by`` and
  ``compiled`` are the runtime's own stamps on each result: the
  executor's device answer or the breaker's host answer, and whether
  the batch captured a program at the predictor's site.  Rejections are
  machine-readable frames carrying the reason, the retryable bit and a
  Retry-After backoff hint in seconds.
* **Torn-frame robustness.**  Truncated header, short payload, bad
  magic / version / dtype, bad CRC and oversized row counts each produce
  a machine-readable retryable rejection frame, never a hung connection
  and never an unbounded read (the declared payload length is bounded
  before any payload byte is read).  Only a CRC failure keeps the
  connection open (the frame boundary is still trustworthy); every
  other torn class closes it after the rejection is written.

Served over TCP (`WireTCPServer`) and a Unix-domain socket
(`WireUnixServer`, `task=serve serve_wire_uds=...`), with the same
runtime and the same bounded admission queue as the JSON path.  A
MSG_SHM_SETUP frame on the Unix socket upgrades its connection to a
shared-memory ring session (`shm_ring`).
"""
from __future__ import annotations

import os
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import telemetry

__all__ = ["HEADER_FIELDS", "HEADER_FMT", "HEADER_SIZE", "MAGIC",
           "VERSION", "MSG_REQUEST", "MSG_RESPONSE", "MSG_REJECT",
           "MSG_SHM_SETUP", "MSG_SHM_OK", "DTYPE_F32", "pack_request",
           "pack_response", "pack_reject", "read_frame",
           "WireFrameError", "WireTCPServer", "WireUnixServer",
           "WireClient"]

#: the canonical header layout: ``helper/check_wire_abi.py`` pins this
#: tuple token for token against the ``WIRE_FRAME_FIELDS`` comment in
#: ``cpp/lightgbm_tpu_c_api.h``; edit both together or the lint fails
HEADER_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("magic", "4s"),
    ("version", "B"),
    ("msg_type", "B"),
    ("dtype", "B"),
    ("flags", "B"),
    ("model_id", "16s"),
    ("n_rows", "I"),
    ("n_cols", "I"),
    ("payload_len", "I"),
    ("crc32", "I"),
)
HEADER_FMT = "<" + "".join(fmt for _name, fmt in HEADER_FIELDS)
HEADER_SIZE = struct.calcsize(HEADER_FMT)          # 40 bytes
_HEADER = struct.Struct(HEADER_FMT)

MAGIC = b"LGBW"
VERSION = 1
MSG_REQUEST, MSG_RESPONSE, MSG_REJECT = 1, 2, 3
#: shared-memory ring negotiation: a client on the UDS plane sends
#: MSG_SHM_SETUP carrying the packed ring config; the server acks with
#: MSG_SHM_OK (twice: config accepted, then segment mapped) and the
#: socket becomes the session's control channel (runtime/shm_ring.py)
MSG_SHM_SETUP, MSG_SHM_OK = 4, 5
DTYPE_F32 = 0                                      # the only wire dtype

#: response meta block, written BEFORE the float32 values payload:
#: generation (i64), latency_s, queue_wait_s, batch_gather_s, device_s,
#: drain_s (f32: the stage partition, on the clock of the latency),
#: served_by (0=host 1=device), compiled (0/1), 2 pad bytes
RESP_META_FMT = "<qfffffBBxx"
RESP_META_SIZE = struct.calcsize(RESP_META_FMT)    # 32 bytes
_RESP_META = struct.Struct(RESP_META_FMT)

#: rejection meta block: retry_after_s (f32 backoff hint, 0 = none),
#: retryable (0/1), reserved, reason_len (u16), then reason utf-8 bytes
REJ_META_FMT = "<fBBH"
REJ_META_SIZE = struct.calcsize(REJ_META_FMT)      # 8 bytes
_REJ_META = struct.Struct(REJ_META_FMT)

#: hard bound on a frame's DECLARED payload before any payload byte is
#: read — the "never an unbounded read" contract.  Row counts are
#: additionally bounded by the server's max_rows_per_frame.
MAX_PAYLOAD = 1 << 26                              # 64 MiB
MAX_COLS = 1 << 16


class WireFrameError(RuntimeError):
    """A frame the server (or client) refused to parse.  `reason` is the
    machine-readable torn-frame class; `fatal` frames desynchronize the
    byte stream and close the connection after the rejection frame."""

    def __init__(self, reason: str, detail: str = "", fatal: bool = True,
                 retry_after_s: float = 0.0):
        super().__init__("%s%s" % (reason, ": " + detail if detail else ""))
        self.reason = reason
        self.fatal = fatal
        self.retry_after_s = retry_after_s


def _pad_model_id(model_id: str) -> bytes:
    raw = model_id.encode("utf-8")[:16]
    return raw + b"\x00" * (16 - len(raw))


def _unpad_model_id(raw: bytes) -> str:
    return raw.rstrip(b"\x00").decode("utf-8", "replace") or "default"


def pack_header(msg_type: int, model_id: str, n_rows: int, n_cols: int,
                payload: bytes, flags: int = 0) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, msg_type, DTYPE_F32, flags,
                        _pad_model_id(model_id), n_rows, n_cols,
                        len(payload), zlib.crc32(payload) & 0xFFFFFFFF)


def pack_request(X: np.ndarray, model_id: str = "default",
                 priority: int = 0) -> bytes:
    """One request frame from a [B, F] float32 matrix (cast if needed).

    `priority` rides the header's flags byte (low nibble, 0 = highest):
    the server feeds it to the same per-class admission reservations as
    the JSON path (the load generator's classed traffic uses the binary
    plane).  0 is the highest class."""
    X = np.ascontiguousarray(np.atleast_2d(X), np.float32)
    payload = X.tobytes()
    return pack_header(MSG_REQUEST, model_id, X.shape[0], X.shape[1],
                       payload, flags=int(priority) & 0x0F) + payload


def pack_response(values: np.ndarray, generation: int, model_id: str,
                  served_by: str, latency_s: float,
                  stages: Dict[str, float], compiled: bool) -> bytes:
    """One response frame: RESP_META + float32 values.  n_rows/n_cols
    describe the VALUES matrix; payload_len additionally covers the meta
    block, so framing never depends on interpreting the payload."""
    vals = np.ascontiguousarray(np.atleast_2d(values), np.float32)
    meta = _RESP_META.pack(
        int(generation), float(latency_s),
        float(stages.get("queue_wait_s", 0.0)),
        float(stages.get("batch_gather_s", 0.0)),
        float(stages.get("device_s", 0.0)),
        float(stages.get("drain_s", 0.0)),
        1 if served_by == "device" else 0, 1 if compiled else 0)
    payload = meta + vals.tobytes()
    return pack_header(MSG_RESPONSE, model_id, vals.shape[0],
                       vals.shape[1], payload) + payload


def pack_reject(reason: str, retryable: bool = True,
                retry_after_s: float = 0.0,
                model_id: str = "default") -> bytes:
    """One machine-readable rejection frame (the binary twin of
    `ServeRejected.to_dict()`), carrying the Retry-After backoff hint."""
    rb = reason.encode("utf-8")[:1024]
    payload = _REJ_META.pack(max(float(retry_after_s), 0.0),
                             1 if retryable else 0, 0, len(rb)) + rb
    return pack_header(MSG_REJECT, model_id, 0, 0, payload) + payload


def unpack_response(header: Tuple, payload: bytes) -> Dict[str, Any]:
    """Decode a response/reject payload into the JSON-path dict shape —
    the parity surface the verification harnesses compare on."""
    (_magic, _ver, msg_type, _dtype, _flags, model_raw, n_rows, n_cols,
     _plen, _crc) = header
    if msg_type == MSG_REJECT:
        retry_after, retryable, _resv, rlen = _REJ_META.unpack_from(payload)
        reason = payload[REJ_META_SIZE:REJ_META_SIZE + rlen].decode(
            "utf-8", "replace")
        return {"error": "rejected", "reason": reason,
                "retryable": bool(retryable),
                "retry_after_s": round(float(retry_after), 6)}
    if msg_type != MSG_RESPONSE:
        raise WireFrameError("unexpected_msg_type", str(msg_type))
    (gen, latency, qw, bg, dv, dr, served_dev, compiled) = \
        _RESP_META.unpack_from(payload)
    vals = np.frombuffer(payload, np.float32, count=n_rows * n_cols,
                         offset=RESP_META_SIZE).reshape(n_rows, n_cols)
    return {"values": vals, "generation": int(gen),
            "model": _unpad_model_id(model_raw),
            "served_by": "device" if served_dev else "host",
            "latency_s": float(latency), "compiled": bool(compiled),
            "stages": {"queue_wait_s": float(qw),
                       "batch_gather_s": float(bg),
                       "device_s": float(dv), "drain_s": float(dr)}}


# ---------------------------------------------------------------------------
# frame reader (shared by server handler and client)
# ---------------------------------------------------------------------------

def _read_exact_into(rfile, view: memoryview) -> int:
    """Fill `view` from the buffered reader; returns bytes actually read
    (short only at EOF).  Bounded by len(view) — never an unbounded
    read."""
    got = 0
    while got < len(view):
        n = rfile.readinto(view[got:])
        if not n:
            break
        got += n
    return got


def read_frame(rfile, buffers: Optional["_BucketBuffers"] = None,
               max_rows: int = 1 << 20,
               expect=None):
    """Read one frame: (header tuple, payload).  With `buffers`, the
    payload lands in a preallocated per-bucket buffer and `payload` is a
    memoryview of it (zero-copy); otherwise a fresh bytes object.

    Returns None at clean EOF (no bytes).  Raises `WireFrameError` for
    every torn-frame class; the DECLARED payload length is validated
    against the header's own row/col counts and the hard bounds BEFORE
    any payload byte is read."""
    head = bytearray(HEADER_SIZE)
    got = _read_exact_into(rfile, memoryview(head))
    if got == 0:
        return None
    if got < HEADER_SIZE:
        raise WireFrameError("truncated_header",
                             "%d of %d header bytes" % (got, HEADER_SIZE))
    hdr = _HEADER.unpack(bytes(head))
    (magic, version, msg_type, dtype, _flags, _model, n_rows, n_cols,
     payload_len, crc) = hdr
    if magic != MAGIC:
        raise WireFrameError("bad_magic", repr(bytes(magic)))
    if version != VERSION:
        raise WireFrameError("bad_version", str(version))
    if dtype != DTYPE_F32:
        raise WireFrameError("bad_dtype", str(dtype))
    if expect is not None and msg_type != expect and not (
            isinstance(expect, tuple) and msg_type in expect):
        raise WireFrameError("unexpected_msg_type", str(msg_type))
    if payload_len > MAX_PAYLOAD or n_cols > MAX_COLS:
        raise WireFrameError("oversized",
                             "payload_len=%d n_cols=%d" % (payload_len,
                                                           n_cols))
    if msg_type == MSG_REQUEST:
        if n_rows > max_rows:
            raise WireFrameError(
                "oversized", "n_rows=%d > max_rows_per_frame=%d"
                % (n_rows, max_rows), retry_after_s=0.0)
        if n_rows < 1 or n_cols < 1 or payload_len != n_rows * n_cols * 4:
            raise WireFrameError(
                "bad_frame", "payload_len=%d does not match %dx%d float32"
                % (payload_len, n_rows, n_cols))
    if buffers is not None:
        buf = buffers.get(payload_len)
        view = memoryview(buf)[:payload_len]
        got = _read_exact_into(rfile, view)
    else:
        raw = bytearray(payload_len)
        view = memoryview(raw)
        got = _read_exact_into(rfile, view)
    if got < payload_len:
        raise WireFrameError("short_payload",
                             "%d of %d payload bytes" % (got, payload_len))
    if zlib.crc32(view) & 0xFFFFFFFF != crc:
        # the frame BOUNDARY is intact (payload_len was honored), so the
        # stream can keep going — the only retry-in-place torn class
        raise WireFrameError("bad_crc", fatal=False)
    return hdr, view if buffers is not None else bytes(raw)


class _BucketBuffers:
    """Per-connection pool of preallocated receive buffers, keyed by the
    power-of-two byte bucket — repeated frames of similar size reuse ONE
    allocation, and the numpy view handed to the runtime aliases it."""

    __slots__ = ("_bufs",)

    _MIN = 1 << 10

    def __init__(self):
        self._bufs: Dict[int, bytearray] = {}

    def get(self, nbytes: int) -> bytearray:
        bucket = max(self._MIN, 1 << max(int(nbytes) - 1, 1).bit_length())
        buf = self._bufs.get(bucket)
        if buf is None:
            buf = self._bufs[bucket] = bytearray(bucket)
        return buf


class _ResponseScratch:
    """Per-connection reusable response buffer.

    `pack_response` builds three fresh bytes objects per response (meta
    block, meta+values payload, header+payload frame).  This scratch
    packs the header and meta block into one preallocated bytearray with
    `Struct.pack_into`, copies the float32 values right behind them, and
    hands the socket a memoryview of the result: no per-response buffer
    allocation (tests/test_torch_wire.py).  The buffer
    grows by power-of-two bucket when a response outgrows it (amortized,
    never per-response); values that arrive as float64 (the legacy
    response surface) cast into a reusable per-bucket float32 arena.
    Model-id padding is memoized per id.

    Single-threaded by construction: one scratch per connection handler,
    one frame in flight per socket."""

    __slots__ = ("_buf", "_mids", "_f32")

    def __init__(self):
        self._buf = bytearray(HEADER_SIZE + RESP_META_SIZE + (1 << 12))
        self._mids: Dict[str, bytes] = {}
        self._f32: Dict[int, np.ndarray] = {}

    def _model(self, model_id: str) -> bytes:
        mid = self._mids.get(model_id)
        if mid is None:
            if len(self._mids) > 256:      # hostile id churn: stay bounded
                self._mids.clear()
            mid = self._mids[model_id] = _pad_model_id(model_id)
        return mid

    def _as_f32(self, values: np.ndarray) -> np.ndarray:
        """`values` as a C-contiguous float32 matrix — returned AS IS
        when it already is one (the response_dtype="float32" runtime),
        else cast into a reusable per-bucket conversion arena."""
        if values.dtype == np.float32 and values.flags["C_CONTIGUOUS"]:
            return values
        n = int(values.size)
        bucket = max(1 << max(n - 1, 1).bit_length(), 1 << 8)
        arena = self._f32.get(bucket)
        if arena is None:
            arena = self._f32[bucket] = np.empty(bucket, np.float32)
        dst = arena[:n].reshape(values.shape)
        np.copyto(dst, values, casting="same_kind")
        return dst

    def pack_response_into(self, buf, off: int, values: np.ndarray,
                           generation: int, model_id: str,
                           served_by: str, latency_s: float,
                           stages: Dict[str, float],
                           compiled: bool) -> int:
        """Pack one response frame at `buf[off:]` (any writable buffer —
        the SHM response ring hands its mmap here so the frame lands
        directly in the shared segment, no intermediate copy).  Returns
        the frame's total bytes.  The caller guarantees the room."""
        vals = self._as_f32(np.atleast_2d(values))
        nbytes = vals.size * 4
        total = HEADER_SIZE + RESP_META_SIZE + nbytes
        _RESP_META.pack_into(
            buf, off + HEADER_SIZE, int(generation), float(latency_s),
            float(stages.get("queue_wait_s", 0.0)),
            float(stages.get("batch_gather_s", 0.0)),
            float(stages.get("device_s", 0.0)),
            float(stages.get("drain_s", 0.0)),
            1 if served_by == "device" else 0, 1 if compiled else 0)
        mv = memoryview(buf)
        try:
            mv[off + HEADER_SIZE + RESP_META_SIZE:off + total] = \
                memoryview(vals).cast("B")
            crc = zlib.crc32(mv[off + HEADER_SIZE:off + total]) \
                & 0xFFFFFFFF
        finally:
            mv.release()
        _HEADER.pack_into(buf, off, MAGIC, VERSION, MSG_RESPONSE,
                          DTYPE_F32, 0, self._model(model_id),
                          vals.shape[0], vals.shape[1],
                          RESP_META_SIZE + nbytes, crc)
        return total

    def pack_response(self, values: np.ndarray, generation: int,
                      model_id: str, served_by: str, latency_s: float,
                      stages: Dict[str, float],
                      compiled: bool) -> memoryview:
        """Same frame bytes as module-level `pack_response` (parity is
        test-pinned), valid until the next call on this scratch."""
        vals = self._as_f32(np.atleast_2d(values))
        total = HEADER_SIZE + RESP_META_SIZE + vals.size * 4
        if len(self._buf) < total:
            self._buf = bytearray(1 << max(total - 1, 1).bit_length())
        total = self.pack_response_into(self._buf, 0, vals, generation,
                                        model_id, served_by, latency_s,
                                        stages, compiled)
        return memoryview(self._buf)[:total]


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------

class _WireHandler(socketserver.StreamRequestHandler):
    """One thread per connection, strict request/response (one frame in
    flight per socket): the zero-copy receive buffer is safe to reuse
    once the response is on the wire."""

    def handle(self) -> None:
        server = self.server                      # type: ignore[assignment]
        rt = server.runtime
        path = server.wire_path_label
        bytes_total = telemetry.counter("lgbm_serve_bytes_total")
        frames_total = telemetry.counter("lgbm_serve_frames_total")
        buffers = _BucketBuffers()
        scratch = _ResponseScratch()
        from .serving import ServeRejected
        while True:
            try:
                frame = read_frame(self.rfile, buffers,
                                   max_rows=server.max_rows_per_frame,
                                   expect=(MSG_REQUEST, MSG_SHM_SETUP))
            except WireFrameError as e:
                frames_total.inc(outcome=e.reason)
                out = pack_reject(e.reason, retryable=True,
                                  retry_after_s=e.retry_after_s)
                self._send(out, bytes_total, path)
                if e.fatal:
                    return                        # stream desynchronized
                continue
            except OSError:
                return
            if frame is None:
                return                            # clean EOF
            hdr, payload = frame
            (_m, _v, msg_type, _d, flags, model_raw, n_rows, n_cols,
             plen, _crc) = hdr
            bytes_total.inc(HEADER_SIZE + plen, path=path, dir="rx")
            if msg_type == MSG_SHM_SETUP:
                # the shared-memory upgrade: fd passing needs AF_UNIX,
                # so the TCP plane refuses (non-retryable — the client
                # should fall back, not retry)
                if not getattr(server, "supports_shm", False):
                    frames_total.inc(outcome="shm_requires_uds")
                    self._send(pack_reject("shm_requires_uds",
                                           retryable=False),
                               bytes_total, path)
                    return
                from . import shm_ring
                shm_ring.serve_handler(self, bytes(payload))
                return                # the socket was the control channel
            model_id = _unpad_model_id(model_raw)
            # the zero-copy hand-off: a float32 VIEW of the receive
            # buffer rides the queue; no per-request numpy allocation
            X = np.frombuffer(payload, np.float32,
                              count=n_rows * n_cols).reshape(n_rows,
                                                             n_cols)
            try:
                rec = rt.submit_view(X, model_id=model_id,
                                     priority=flags & 0x0F).wait(
                    timeout=rt.wire_wait_timeout_s)
                # response values are always [n_rows, n_outputs] on the
                # wire (a squeezed 1-class vector reshapes, multiclass
                # passes through); the frame packs into the connection's
                # reusable scratch — zero per-response allocations
                vals = np.asarray(rec.values)
                out = scratch.pack_response(vals.reshape(n_rows, -1),
                                            rec.generation, model_id,
                                            rec.served_by, rec.latency_s,
                                            rec.stages, rec.compiled)
                frames_total.inc(outcome="completed")
            except ServeRejected as e:
                out = pack_reject(e.reason, retryable=e.retryable,
                                  retry_after_s=e.retry_after_s or 0.0,
                                  model_id=model_id)
                frames_total.inc(outcome="rejected")
            except Exception as e:                # noqa: BLE001 — wire error
                out = pack_reject("bad_request", retryable=False,
                                  model_id=model_id)
                rt.log.warning("wire: request failed: %s: %s",
                               type(e).__name__, e)
                frames_total.inc(outcome="rejected")
            if not self._send(out, bytes_total, path):
                return

    def _send(self, out, bytes_total, path: str) -> bool:
        try:
            self.wfile.write(out)
            self.wfile.flush()
        except OSError:
            return False                          # client went away
        bytes_total.inc(len(out), path=path, dir="tx")
        return True


class WireTCPServer(socketserver.ThreadingTCPServer):
    """Binary-frame TCP front end over a `ServingRuntime` — the same
    bounded admission queue as the JSON `ServingServer`, so admission
    control stays global across both planes."""

    daemon_threads = True
    allow_reuse_address = True
    wire_path_label = "tcp"
    supports_shm = False          # SCM_RIGHTS fd passing needs AF_UNIX

    def __init__(self, runtime, host: str = "127.0.0.1", port: int = 0,
                 max_rows_per_frame: Optional[int] = None):
        self.runtime = runtime
        self.max_rows_per_frame = int(max_rows_per_frame
                                      or runtime.max_batch_rows)
        super().__init__((host, port), _WireHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]


class WireUnixServer(socketserver.ThreadingUnixStreamServer):
    """Binary-frame Unix-domain-socket front end: same frames as TCP,
    minus the TCP/loopback stack: the lowest-latency local data plane.
    Also the SHM ring transport's
    handshake plane: a MSG_SHM_SETUP frame on any connection upgrades
    it to a shared-memory session (`enable_shm=False` turns that off)."""

    daemon_threads = True
    allow_reuse_address = True
    wire_path_label = "uds"

    def __init__(self, runtime, path: str,
                 max_rows_per_frame: Optional[int] = None,
                 enable_shm: bool = True):
        self.runtime = runtime
        self.uds_path = path
        self.supports_shm = bool(enable_shm)
        self.max_rows_per_frame = int(max_rows_per_frame
                                      or runtime.max_batch_rows)
        self._reap_stale_path(path)
        super().__init__(path, _WireHandler)

    @staticmethod
    def _reap_stale_path(path: str) -> None:
        """A replica SIGKILLed mid-serve leaves its socket FILE behind,
        and the relaunch's bind() hits EADDRINUSE.  Probe-connect first:
        refused means nobody is listening (stale inode — unlink it),
        success means a LIVE server owns the path (bind and fail loudly
        rather than yank a working server's socket out from under it)."""
        if not os.path.exists(path):
            return
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.settimeout(0.5)
        try:
            probe.connect(path)
        except (ConnectionRefusedError, socket.timeout, OSError):
            try:
                os.unlink(path)       # stale: no listener behind it
            except FileNotFoundError:
                pass                  # raced another relaunch — fine
        else:
            raise OSError(
                "wire UDS path %r is owned by a LIVE server "
                "(probe-connect succeeded); refusing to unlink" % path)
        finally:
            probe.close()

    def server_close(self) -> None:
        super().server_close()
        try:
            os.unlink(self.uds_path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class WireClient:
    """Blocking binary-protocol client (one frame in flight).  `predict`
    retries retryable rejections with the server's Retry-After hint —
    the binary twin of `ServingRuntime.predict`'s backoff contract."""

    def __init__(self, address, timeout: float = 30.0):
        """`address`: ("host", port) for TCP or "/path/to.sock" for a
        Unix-domain socket."""
        if isinstance(address, (tuple, list)):
            self._sock = socket.create_connection(tuple(address),
                                                  timeout=timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        else:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(timeout)
            self._sock.connect(address)
        self._rfile = self._sock.makefile("rb")
        self._buffers = _BucketBuffers()

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "WireClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def request_once(self, X: np.ndarray, model_id: str = "default",
                     priority: int = 0) -> Dict[str, Any]:
        """One round trip; returns the decoded response dict (values as
        a float32 view valid until the NEXT call on this client)."""
        self._sock.sendall(pack_request(X, model_id, priority=priority))
        frame = read_frame(self._rfile, self._buffers)
        if frame is None:
            raise WireFrameError("connection_closed")
        hdr, payload = frame
        return unpack_response(hdr, bytes(payload))

    def predict(self, X: np.ndarray, model_id: str = "default",
                attempts: int = 3, priority: int = 0) -> Dict[str, Any]:
        last: Optional[Dict[str, Any]] = None
        for a in range(max(attempts, 1)):
            out = self.request_once(X, model_id, priority=priority)
            if "error" not in out:
                return out
            last = out
            if not out.get("retryable"):
                break
            if a + 1 < max(attempts, 1):
                # honor the server's Retry-After hint, floor 10 ms
                time.sleep(max(float(out.get("retry_after_s") or 0.0),
                               0.01))
        assert last is not None
        raise WireFrameError("rejected", last.get("reason", ""),
                             fatal=False)
