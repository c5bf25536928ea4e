"""Shared-memory ring transport (counterpart of
lightgbm_tpu/runtime/shm_ring.py): serving without a data syscall.

The binary wire plane (`wire`) costs a 40-byte header, a CRC and two
socket syscalls per request.  On a same-host deployment (the fleet's
replicas, any sidecar) those syscalls and the kernel's socket-buffer
copy are what is left.  This module removes them: a per-client
shared-memory segment holding a pair of single-producer /
single-consumer byte rings; requests are written by the client straight
into the mapped region in the wire frame format and admitted as a numpy
view of the segment (`ServingRuntime.submit_view`: no recv, no copy, no
allocation); responses are packed by the session's `_ResponseScratch`
straight into the response ring.  Layouts, handshake and doorbells are
the JAX package's, byte for byte, so either package's client talks to
either package's server.

**Where the card's copies happen.**  The rings are host memory.  A
request's rows leave the segment once, when the device predictor copies
them into its pinned staging slot before the asynchronous host-to-device
copy (`DevicePredictor._run_card`; a batch of several requests is first
gathered into the batcher's arena, as on the socket path).  The response
values are the predictor's device-to-host output (its pinned output slot
copied into the result array), and `_ResponseScratch.pack_response_into`
writes them into the response ring: the one copy the socket path makes
into its response scratch, with the socket send left out.  So the ring
adds no copy per request beyond the socket path's.

**Handshake rides the Unix socket.**  The client connects to the
ordinary `WireUnixServer` and sends one `MSG_SHM_SETUP` frame whose
payload is the packed segment header (`RING_HEADER_FIELDS`, pinned
field for field against the `WIRE_RING_FIELDS` token line and
`LGBMWireRingHeader` struct in ``cpp/lightgbm_tpu_c_api.h`` by
``helper/check_wire_abi.py``).  The server acks, the client passes the
segment fd and two eventfd doorbells over the socket with
``SCM_RIGHTS``, the server maps and validates, acks again, and the
socket stays open as the session's control channel: peer death is an
EOF / HUP the server's doorbell poll sees at once.

**Segment layout** (little-endian; offsets carried in the header so
both sides agree by construction)::

    [0,  40)  segment header  (RING_HEADER_FIELDS, 40 bytes)
    [64, 256) request-ring control   -- 3 cache lines:
              tail u64 @ +0 | head u64 @ +64 | waiter u32 @ +128
    [256,448) response-ring control  -- same 3-line shape
    [448, 448+req_capacity)      request ring data   (client -> server)
    [.., .. + resp_capacity)     response ring data  (server -> client)

Head and tail are free-running u64 sequence counters on their own cache
lines; position = counter & (capacity-1).  Frames are always
contiguous: a producer that cannot fit a frame before the segment
boundary writes a 4-byte wrap marker (0xFFFFFFFF, never a valid frame
magic) and skips to the ring start, so the consumer can hand the
runtime a contiguous zero-copy view.  Capacities are powers of two, at
least twice the largest frame.

**Doorbell protocol** (adaptive spin, then eventfd): a consumer spins a
bounded wall-clock budget on the tail counter, then publishes a
``waiter`` flag, re-checks the ring (the lost-wakeup guard), and blocks
in ``poll([eventfd, control_socket])``.  A producer that sees
``waiter`` set clears it and writes the eventfd: one syscall per sleep
/ wake episode, none while both sides stay hot.  Every syscall the ring
path makes is counted (``lgbm_shm_doorbell_syscalls_total``).

**Contract edges** (tests/test_torch_shm_ring.py): wraparound across
the segment boundary; a full ring as a typed retryable reject
(``ring_full`` on the client before any byte moves, ``resp_ring_full``
on the server, never a blocked server thread); a CRC-corrupted in-ring
frame rejected without desynchronizing the counters (the socket
plane's bad_crc semantics); and crashed-client reclamation: peer death
on the control socket drains the in-flight admissions, unmaps the
segment, closes every fd and counts the event
(``lgbm_shm_sessions_total{event="reclaimed"}``); the `die_at_ring:K`
fault arms it.
"""
from __future__ import annotations

import gc
import mmap
import os
import select
import socket
import struct
import time
import zlib
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import telemetry
from .wire import (HEADER_FMT, HEADER_SIZE, MAGIC, VERSION, MSG_REQUEST,
                   MSG_SHM_OK, MSG_SHM_SETUP, DTYPE_F32, RESP_META_SIZE,
                   MAX_PAYLOAD, MAX_COLS, WireFrameError, pack_header,
                   pack_reject, read_frame, unpack_response,
                   _ResponseScratch, _unpad_model_id, _pad_model_id)

__all__ = ["RING_HEADER_FIELDS", "RING_HEADER_FMT", "RING_HEADER_SIZE",
           "RING_MAGIC", "RING_VERSION", "ShmClient", "ShmError",
           "serve_handler", "stats_snapshot"]

#: the canonical segment-header layout: ``helper/check_wire_abi.py``
#: pins this tuple token for token against the ``WIRE_RING_FIELDS``
#: comment + ``LGBMWireRingHeader`` struct in cpp/lightgbm_tpu_c_api.h;
#: edit both together or the lint fails
RING_HEADER_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("magic", "4s"),
    ("version", "B"),
    ("flags", "B"),
    ("reserved", "H"),
    ("seg_size", "Q"),
    ("req_ctrl", "I"),
    ("req_offset", "I"),
    ("req_capacity", "I"),
    ("resp_ctrl", "I"),
    ("resp_offset", "I"),
    ("resp_capacity", "I"),
)
RING_HEADER_FMT = "<" + "".join(f for _n, f in RING_HEADER_FIELDS)
RING_HEADER_SIZE = struct.calcsize(RING_HEADER_FMT)     # 40 bytes
_RING_HEADER = struct.Struct(RING_HEADER_FMT)

RING_MAGIC = b"LGBR"
RING_VERSION = 1

CACHE_LINE = 64
CTRL_SIZE = 3 * CACHE_LINE       # tail line + head line + waiter line
CTRL_TAIL, CTRL_HEAD, CTRL_WAITER = 0, CACHE_LINE, 2 * CACHE_LINE
REQ_CTRL_OFF = CACHE_LINE        # header is padded out to one line
RESP_CTRL_OFF = REQ_CTRL_OFF + CTRL_SIZE
DATA_OFF = RESP_CTRL_OFF + CTRL_SIZE

WRAP_MARK = 0xFFFFFFFF           # never a valid frame magic ("LGBW")
MIN_CAPACITY = 1 << 12
MAX_CAPACITY = 1 << 28
DEFAULT_REQ_CAPACITY = 1 << 20
DEFAULT_RESP_CAPACITY = 1 << 20

_HEADER = struct.Struct(HEADER_FMT)
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_ONE = (1).to_bytes(8, "little")

#: spin budget (seconds of wall clock) a consumer burns on the counters
#: before arming the doorbell and sleeping.  Small by default (an idle
#: session must cost nothing); LGBM_TPU_SHM_SPIN_S raises it.
SPIN_S_DEFAULT = 0.002


def _spin_budget_s() -> float:
    try:
        return float(os.environ.get("LGBM_TPU_SHM_SPIN_S",
                                    SPIN_S_DEFAULT))
    except ValueError:
        return SPIN_S_DEFAULT


class ShmError(RuntimeError):
    """A ring-protocol violation (torn setup, impossible offsets, a
    frame header that lies).  Fatal to the SESSION, never the server."""


def pack_ring_config(req_capacity: int = DEFAULT_REQ_CAPACITY,
                     resp_capacity: int = DEFAULT_RESP_CAPACITY) -> bytes:
    """The 40-byte segment header both sides agree on."""
    req_capacity, resp_capacity = int(req_capacity), int(resp_capacity)
    seg_size = DATA_OFF + req_capacity + resp_capacity
    return _RING_HEADER.pack(
        RING_MAGIC, RING_VERSION, 0, 0, seg_size,
        REQ_CTRL_OFF, DATA_OFF, req_capacity,
        RESP_CTRL_OFF, DATA_OFF + req_capacity, resp_capacity)


def unpack_ring_config(raw: bytes) -> Dict[str, int]:
    if len(raw) < RING_HEADER_SIZE:
        raise ShmError("short ring config: %d bytes" % len(raw))
    (magic, version, _flags, _resv, seg_size, req_ctrl, req_off, req_cap,
     resp_ctrl, resp_off, resp_cap) = _RING_HEADER.unpack_from(raw)
    if magic != RING_MAGIC:
        raise ShmError("bad ring magic %r" % magic)
    if version != RING_VERSION:
        raise ShmError("bad ring version %d" % version)
    for cap in (req_cap, resp_cap):
        if cap < MIN_CAPACITY or cap > MAX_CAPACITY or cap & (cap - 1):
            raise ShmError("ring capacity %d not a power of two in "
                           "[%d, %d]" % (cap, MIN_CAPACITY, MAX_CAPACITY))
    if (req_ctrl != REQ_CTRL_OFF or resp_ctrl != RESP_CTRL_OFF
            or req_off != DATA_OFF or resp_off != DATA_OFF + req_cap
            or seg_size != DATA_OFF + req_cap + resp_cap):
        raise ShmError("ring offsets disagree with the v%d layout"
                       % RING_VERSION)
    return {"seg_size": seg_size, "req_ctrl": req_ctrl,
            "req_offset": req_off, "req_capacity": req_cap,
            "resp_ctrl": resp_ctrl, "resp_offset": resp_off,
            "resp_capacity": resp_cap}


# ---------------------------------------------------------------------------
# the SPSC byte ring (one side of it)
# ---------------------------------------------------------------------------

class _Ring:
    """One direction's view of an SPSC byte ring in the mapped segment.
    The same object serves as producer (reserve/publish) on one side of
    the session and consumer (try_pop/advance) on the other — each
    process only ever uses one role per ring.

    Counter stores are single aligned 8-byte writes through the mmap;
    under CPython the interpreter serializes them and x86-TSO keeps the
    data-then-counter publish order — the compiled client uses explicit
    ``__atomic`` builtins for the same contract."""

    __slots__ = ("mm", "ctrl", "data", "cap", "mask", "wraps", "pending")

    def __init__(self, mm: mmap.mmap, ctrl_off: int, data_off: int,
                 cap: int):
        self.mm = mm
        self.ctrl = ctrl_off
        self.data = data_off
        self.cap = cap
        self.mask = cap - 1
        self.wraps = 0
        #: consumer-local peek cursor: bytes POPPED but not yet
        #: `advance`d (the shared head only moves when the frame's bytes
        #: are truly dead, so the producer can't reuse them while a
        #: zero-copy view is still in flight)
        self.pending = 0

    # counter plumbing ------------------------------------------------------
    def load_tail(self) -> int:
        return _U64.unpack_from(self.mm, self.ctrl + CTRL_TAIL)[0]

    def store_tail(self, v: int) -> None:
        _U64.pack_into(self.mm, self.ctrl + CTRL_TAIL, v)

    def load_head(self) -> int:
        return _U64.unpack_from(self.mm, self.ctrl + CTRL_HEAD)[0]

    def store_head(self, v: int) -> None:
        _U64.pack_into(self.mm, self.ctrl + CTRL_HEAD, v)

    def load_waiter(self) -> int:
        return _U32.unpack_from(self.mm, self.ctrl + CTRL_WAITER)[0]

    def store_waiter(self, v: int) -> None:
        _U32.pack_into(self.mm, self.ctrl + CTRL_WAITER, v)

    # producer --------------------------------------------------------------
    def reserve(self, need: int) -> Optional[Tuple[int, int, int]]:
        """Contiguous space for `need` bytes: (byte offset into the
        segment, pad consumed by the wrap, tail) — or None when the
        ring is full (the typed-backpressure seam)."""
        tail = self.load_tail()
        head = self.load_head()
        pos = tail & self.mask
        room = self.cap - pos
        pad = 0
        if need > room:
            pad = room
            pos = 0
        if need + pad > self.cap - (tail - head):
            return None
        return self.data + pos, pad, tail

    def publish(self, tail: int, pad: int, need: int) -> None:
        """Make the frame visible: write the wrap marker (if any), then
        ONE tail store covering pad+frame."""
        if pad >= 4:
            _U32.pack_into(self.mm, self.data + (tail & self.mask),
                           WRAP_MARK)
        if pad:
            self.wraps += 1
        self.store_tail(tail + pad + need)

    # consumer --------------------------------------------------------------
    def has_data(self) -> bool:
        return self.load_tail() != self.load_head() + self.pending

    def try_pop(self) -> Optional[Tuple[Tuple, int, int]]:
        """One frame if available: (header tuple, payload byte offset
        into the segment, span to advance by).  Validates only the
        FRAMING here (wrap marker, header bounds); the caller owns the
        protocol checks and the CRC."""
        head = self.load_head() + self.pending
        avail = self.load_tail() - head
        if avail == 0:
            return None
        pos = head & self.mask
        room = self.cap - pos
        skip = 0
        if room < HEADER_SIZE or (
                _U32.unpack_from(self.mm, self.data + pos)[0] == WRAP_MARK):
            skip = room
            pos = 0
            avail -= skip
            if avail <= 0:
                raise ShmError("wrap marker with no frame behind it")
            self.wraps += 1
        if avail < HEADER_SIZE:
            raise ShmError("torn frame header: %d of %d bytes published"
                           % (avail, HEADER_SIZE))
        hdr = _HEADER.unpack_from(self.mm, self.data + pos)
        payload_len = hdr[8]
        if payload_len > self.cap - HEADER_SIZE - skip \
                or payload_len > MAX_PAYLOAD:
            raise ShmError("frame payload_len %d cannot fit the ring"
                           % payload_len)
        total = HEADER_SIZE + payload_len
        if avail < total:
            raise ShmError("torn frame: %d of %d bytes published"
                           % (avail, total))
        self.pending += skip + total
        return hdr, self.data + pos + HEADER_SIZE, skip + total

    def advance(self, span: int) -> None:
        self.pending -= span
        self.store_head(self.load_head() + span)


# ---------------------------------------------------------------------------
# doorbell (adaptive spin -> eventfd)
# ---------------------------------------------------------------------------

class _Doorbell:
    """Consumer-side sleep/wake for one ring + the session's control
    socket.  Counts every syscall it makes."""

    __slots__ = ("ring", "efd", "sock", "poller", "spin_s", "syscalls",
                 "label")

    def __init__(self, ring: _Ring, efd: int, sock: socket.socket,
                 label: str):
        self.ring = ring
        self.efd = efd
        self.sock = sock
        self.label = label
        self.poller = select.poll()
        self.poller.register(efd, select.POLLIN)
        if sock is not None:
            self.poller.register(sock.fileno(),
                                 select.POLLIN | select.POLLHUP)
        self.spin_s = _spin_budget_s()
        self.syscalls = 0

    def ring_peer(self, producer_ring: _Ring, peer_efd: int,
                  counter) -> None:
        """Producer side: wake the peer iff it published a waiter flag
        (cleared here so a burst costs ONE wakeup syscall)."""
        if producer_ring.load_waiter():
            producer_ring.store_waiter(0)
            try:
                os.write(peer_efd, _ONE)
            except (BlockingIOError, OSError):
                pass
            self.syscalls += 1
            counter.inc(op="ring")

    def wait(self, counter, timeout_s: Optional[float] = None) -> bool:
        """Block until the ring has data or the control socket trips.
        Returns True when data arrived, False on timeout; raises
        ShmError("peer_closed") when the peer hung up."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        spin_until = time.monotonic() + self.spin_s
        n = 0
        while True:
            if self.ring.has_data():
                return True
            n += 1
            if n & 0xFF == 0 and time.monotonic() > spin_until:
                break
        while True:
            self.ring.store_waiter(1)
            if self.ring.has_data():
                self.ring.store_waiter(0)
                return True
            self.syscalls += 1
            counter.inc(op="wait")
            events = self.poller.poll(250)
            self.ring.store_waiter(0)
            for fd, ev in events:
                if self.sock is not None and fd == self.sock.fileno():
                    raise ShmError("peer_closed")
                if fd == self.efd:
                    try:
                        os.read(self.efd, 8)
                        self.syscalls += 1
                        counter.inc(op="drain")
                    except (BlockingIOError, OSError):
                        pass
            if self.ring.has_data():
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False


# ---------------------------------------------------------------------------
# frame helpers shared by both sides
# ---------------------------------------------------------------------------

def _write_request(ring: _Ring, X: np.ndarray, model_id: str,
                   priority: int) -> Optional[int]:
    """Pack one request frame straight into the ring.  Returns the
    frame's total bytes, or None when the ring is full."""
    X = np.ascontiguousarray(np.atleast_2d(X), np.float32)
    n_rows, n_cols = X.shape
    payload_len = n_rows * n_cols * 4
    need = HEADER_SIZE + payload_len
    r = ring.reserve(need)
    if r is None:
        return None
    off, pad, tail = r
    mv = memoryview(ring.mm)
    try:
        mv[off + HEADER_SIZE:off + need] = memoryview(X).cast("B")
        crc = zlib.crc32(mv[off + HEADER_SIZE:off + need]) & 0xFFFFFFFF
    finally:
        mv.release()
    _HEADER.pack_into(ring.mm, off, MAGIC, VERSION, MSG_REQUEST,
                      DTYPE_F32, int(priority) & 0x0F,
                      _pad_model_id(model_id), n_rows, n_cols,
                      payload_len, crc)
    ring.publish(tail, pad, need)
    return need


def _write_reject(ring: _Ring, reason: str, retryable: bool,
                  retry_after_s: float, model_id: str,
                  wait_space_s: float = 5.0) -> bool:
    """Copy a (small) rejection frame into the ring, waiting briefly
    for space — rejects are the backpressure signal itself, so they get
    a bounded grace the data frames never do."""
    frame = pack_reject(reason, retryable=retryable,
                        retry_after_s=retry_after_s, model_id=model_id)
    deadline = time.monotonic() + wait_space_s
    while True:
        r = ring.reserve(len(frame))
        if r is not None:
            off, pad, tail = r
            ring.mm[off:off + len(frame)] = frame
            ring.publish(tail, pad, len(frame))
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.0005)


# ---------------------------------------------------------------------------
# server side: one session per MSG_SHM_SETUP frame on the UDS plane
# ---------------------------------------------------------------------------

#: process-wide session ledger the tests read directly (telemetry
#: counters carry the same events for scrapes)
_STATS = {"sessions": 0, "reclaimed": 0, "closed": 0, "torn": 0,
          "rx_buffer_allocs": 0, "tx_buffer_allocs": 0}


def stats_snapshot() -> Dict[str, int]:
    return dict(_STATS)


class _Teardown(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _Session:
    """The server half of one client's ring pair: pop requests from the
    request ring, admit them as zero-copy views, pack responses (in
    request order — the rings are FIFO) straight into the response
    ring.  Runs on the connection handler's thread; one session per
    client, so a stalled client only ever blocks itself."""

    MAX_INFLIGHT = 64

    def __init__(self, sock: socket.socket, runtime, mm: mmap.mmap,
                 cfg: Dict[str, int], efd_req: int, efd_resp: int,
                 max_rows: int):
        self.sock = sock
        self.rt = runtime
        self.mm = mm
        self.cfg = cfg
        self.efd_req = efd_req
        self.efd_resp = efd_resp
        self.max_rows = max_rows
        self.req = _Ring(mm, cfg["req_ctrl"], cfg["req_offset"],
                         cfg["req_capacity"])
        self.resp = _Ring(mm, cfg["resp_ctrl"], cfg["resp_offset"],
                          cfg["resp_capacity"])
        self.bell = _Doorbell(self.req, efd_req, sock, "server")
        self.scratch = _ResponseScratch()
        self.inflight: deque = deque()
        self.frames = telemetry.counter("lgbm_shm_frames_total")
        self.bytes_total = telemetry.counter("lgbm_serve_bytes_total")
        self.doorbells = telemetry.counter(
            "lgbm_shm_doorbell_syscalls_total")
        self._scratch_allocs = 0

    # -- admission ----------------------------------------------------------
    def _admit_available(self) -> None:
        while len(self.inflight) < self.MAX_INFLIGHT:
            item = self.req.try_pop()          # raises ShmError on torn
            if item is None:
                return
            hdr, payload_off, span = item
            (magic, version, msg_type, dtype, flags, model_raw, n_rows,
             n_cols, payload_len, crc) = hdr
            model_id = _unpad_model_id(model_raw)
            if magic != MAGIC or version != VERSION:
                raise _Teardown("bad_frame")
            if msg_type != MSG_REQUEST or dtype != DTYPE_F32:
                raise _Teardown("bad_frame")
            if n_cols > MAX_COLS or n_rows > self.max_rows \
                    or n_rows < 1 or n_cols < 1 \
                    or payload_len != n_rows * n_cols * 4:
                raise _Teardown("bad_frame")
            self.bytes_total.inc(HEADER_SIZE + payload_len, path="shm",
                                 dir="rx")
            mv = memoryview(self.mm)
            crc_ok = zlib.crc32(
                mv[payload_off:payload_off + payload_len]) \
                & 0xFFFFFFFF == crc
            mv.release()
            if not crc_ok:
                # intact boundary, corrupt bytes: reject THIS frame,
                # keep the counters in sync (the socket plane's
                # non-fatal bad_crc class)
                self.frames.inc(outcome="bad_crc")
                self.inflight.append((None, span, "bad_crc", True, 0.0,
                                      model_id, n_rows))
                continue
            from .serving import ServeRejected
            try:
                # the zero-copy hand-off: a float32 view of the MAPPED
                # SEGMENT rides the admission queue; nothing was read,
                # copied or allocated on the way in
                X = np.frombuffer(self.mm, np.float32,
                                  count=n_rows * n_cols,
                                  offset=payload_off).reshape(n_rows,
                                                              n_cols)
                fut = self.rt.submit_view(X, model_id=model_id,
                                          priority=flags & 0x0F)
                self.inflight.append((fut, span, "", False, 0.0,
                                      model_id, n_rows))
            except ServeRejected as e:
                self.frames.inc(outcome="rejected")
                self.inflight.append((None, span, e.reason, e.retryable,
                                      e.retry_after_s or 0.0, model_id,
                                      n_rows))

    # -- completion ---------------------------------------------------------
    def _reserve_resp(self, need: int) -> Tuple[int, int, int]:
        r = self.resp.reserve(need)
        if r is not None:
            return r
        # response ring full: the client owns the drain.  Bounded
        # grace, watching the control socket — never an unbounded
        # block, never a server thread parked on a dead peer.
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if self.sock is not None:
                ev = self.bell.poller.poll(0)
                for fd, _e in ev:
                    if fd == self.sock.fileno():
                        raise _Teardown("peer_closed")
            time.sleep(0.0005)
            r = self.resp.reserve(need)
            if r is not None:
                return r
        raise _Teardown("resp_ring_stalled")

    def _respond_reject(self, reason: str, retryable: bool,
                        retry_after_s: float, model_id: str) -> None:
        if not _write_reject(self.resp, reason, retryable, retry_after_s,
                             model_id):
            raise _Teardown("resp_ring_stalled")
        self.frames.inc(outcome="rejected")

    def _complete_oldest(self) -> None:
        from .serving import ServeRejected
        fut, span, reason, retryable, retry_after, model_id, n_rows = \
            self.inflight[0]
        if fut is None:
            self._respond_reject(reason, retryable, retry_after, model_id)
        else:
            try:
                rec = fut.wait(timeout=self.rt.wire_wait_timeout_s)
                vals = np.asarray(rec.values).reshape(n_rows, -1)
                need = HEADER_SIZE + RESP_META_SIZE + vals.size * 4
                if need > self.resp.cap - CACHE_LINE:
                    self._respond_reject("resp_too_large", False, 0.0,
                                         model_id)
                else:
                    before = len(self.scratch._f32)
                    off, pad, tail = self._reserve_resp(need)
                    total = self.scratch.pack_response_into(
                        self.mm, off, vals, rec.generation, model_id,
                        rec.served_by, rec.latency_s, rec.stages,
                        rec.compiled)
                    self.resp.publish(tail, pad, total)
                    if len(self.scratch._f32) > before:
                        self._scratch_allocs += 1
                        _STATS["tx_buffer_allocs"] += 1
                    self.frames.inc(outcome="completed")
                    self.bytes_total.inc(total, path="shm", dir="tx")
            except ServeRejected as e:
                self._respond_reject(e.reason, e.retryable,
                                     e.retry_after_s or 0.0, model_id)
            except _Teardown:
                raise
            except Exception as e:      # noqa: BLE001 — wire error class
                self.rt.log.warning("shm: request failed: %s: %s",
                                    type(e).__name__, e)
                self._respond_reject("bad_request", False, 0.0, model_id)
        self.bell.ring_peer(self.resp, self.efd_resp, self.doorbells)
        self.inflight.popleft()
        # the request frame's bytes are dead only now that its response
        # is in the ring — free them in completion order
        self.req.advance(span)

    # -- the loop -----------------------------------------------------------
    def run(self) -> str:
        try:
            while True:
                self._admit_available()
                if self.inflight:
                    self._complete_oldest()
                    continue
                self.bell.wait(self.doorbells)   # raises on peer death
        except _Teardown as e:
            return e.reason
        except ShmError as e:
            return "peer_closed" if str(e) == "peer_closed" else "torn"
        except (OSError, ValueError):
            return "torn"

    def drain_inflight(self) -> int:
        """Resolve every admitted future before the segment goes away —
        the runtime may still be gathering views of the mapped bytes."""
        pending = 0
        while self.inflight:
            fut = self.inflight.popleft()[0]
            pending += 1
            if fut is None:
                continue
            try:
                fut.wait(timeout=self.rt.wire_wait_timeout_s)
            except Exception:           # noqa: BLE001 — result discarded
                pass
        return pending


def _recv_fds(sock: socket.socket, n: int,
              timeout_s: float = 15.0) -> Tuple[bytes, list]:
    old = sock.gettimeout()
    sock.settimeout(timeout_s)
    try:
        msg, fds, _flags, _addr = socket.recv_fds(sock, 16, n)
        return msg, list(fds)
    finally:
        sock.settimeout(old)


def serve_handler(handler, setup_payload: bytes) -> None:
    """Run one SHM session on a `_WireHandler`'s thread.  Called by the
    UDS wire server when a MSG_SHM_SETUP frame arrives; the handler's
    socket becomes the session's control channel and the function only
    returns when the session is over (the socket then closes)."""
    sessions = telemetry.counter("lgbm_shm_sessions_total")
    rt = handler.server.runtime
    sock = handler.connection
    mm = None
    fds: list = []
    try:
        cfg = unpack_ring_config(setup_payload)
    except ShmError as e:
        sessions.inc(event="rejected_setup")
        handler._send(pack_reject("shm_bad_setup: %s" % e,
                                  retryable=False),
                      telemetry.counter("lgbm_serve_bytes_total"), "shm")
        return
    reason = "torn"
    try:
        # ack #1: config accepted, send the fds now
        ack = pack_header(MSG_SHM_OK, "shm", 0, 0, setup_payload) \
            + setup_payload
        handler.wfile.write(ack)
        handler.wfile.flush()
        _msg, fds = _recv_fds(sock, 3)
        if len(fds) != 3:
            raise ShmError("expected 3 fds (segment, doorbell x2), "
                           "got %d" % len(fds))
        seg_fd, efd_req, efd_resp = fds
        if os.fstat(seg_fd).st_size != cfg["seg_size"]:
            raise ShmError("segment size disagrees with the config")
        mm = mmap.mmap(seg_fd, cfg["seg_size"])
        os.close(seg_fd)
        fds = [efd_req, efd_resp]
        if bytes(mm[:RING_HEADER_SIZE]) != setup_payload[
                :RING_HEADER_SIZE]:
            raise ShmError("segment header disagrees with the setup "
                           "frame")
        # ack #2: mapped and validated — the rings are live
        handler.wfile.write(ack)
        handler.wfile.flush()
        _STATS["sessions"] += 1
        sessions.inc(event="ready")
        sess = _Session(sock, rt, mm, cfg, efd_req, efd_resp,
                        handler.server.max_rows_per_frame)
        reason = sess.run()
        pending = sess.drain_inflight()
        if reason == "peer_closed":
            reason = "reclaimed" if pending else "closed"
        del sess
    except (ShmError, OSError, ValueError) as e:
        rt.log.warning("shm: session setup failed: %s", e)
        reason = "torn"
    finally:
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass
        leaked = False
        if mm is not None:
            # the runtime must hold no view of the segment when it is
            # unmapped; admissions were drained above, stragglers are
            # swept by the collector
            for _ in range(100):
                try:
                    mm.close()
                    break
                except BufferError:
                    gc.collect()
                    time.sleep(0.05)
            else:
                leaked = True
                rt.log.warning("shm: segment still referenced at "
                               "teardown — mapping leaked")
        _STATS[reason if reason in _STATS else "torn"] = \
            _STATS.get(reason if reason in _STATS else "torn", 0) + 1
        sessions.inc(event="leaked" if leaked else reason)


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class ShmClient:
    """Ring-transport client with the `WireClient` surface: connect to
    a UDS wire server, negotiate a segment, then `request_once` /
    pipelined `submit_nowait`+`read_response` without a single data
    syscall.  A full request ring surfaces as the machine-readable
    retryable reject ``{"error": "rejected", "reason": "ring_full"}``
    before any byte moves — backpressure is the caller's signal, not a
    blocked thread."""

    def __init__(self, uds_path: str,
                 req_capacity: int = DEFAULT_REQ_CAPACITY,
                 resp_capacity: int = DEFAULT_RESP_CAPACITY,
                 timeout: float = 30.0):
        if not hasattr(os, "memfd_create") or not hasattr(os, "eventfd"):
            raise ShmError("shm transport needs Linux + Python >= 3.10")
        self.timeout = float(timeout)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(uds_path)
        self._rfile = self._sock.makefile("rb")
        self.inflight = 0
        self._mm = None
        self._fds = []
        cfg_bytes = pack_ring_config(req_capacity, resp_capacity)
        cfg = unpack_ring_config(cfg_bytes)
        try:
            self._sock.sendall(
                pack_header(MSG_SHM_SETUP, "shm", 0, 0, cfg_bytes)
                + cfg_bytes)
            self._expect_ok()
            seg_fd = os.memfd_create("lgbm-shm-ring")
            self._fds = [seg_fd]
            os.ftruncate(seg_fd, cfg["seg_size"])
            self._mm = mmap.mmap(seg_fd, cfg["seg_size"])
            self._mm[:RING_HEADER_SIZE] = cfg_bytes
            efd_req = os.eventfd(0, os.EFD_NONBLOCK)
            efd_resp = os.eventfd(0, os.EFD_NONBLOCK)
            self._fds += [efd_req, efd_resp]
            socket.send_fds(self._sock, [b"F"],
                            [seg_fd, efd_req, efd_resp])
            self._expect_ok()
            os.close(seg_fd)
            self._fds = [efd_req, efd_resp]
            self.efd_req, self.efd_resp = efd_req, efd_resp
            self.req = _Ring(self._mm, cfg["req_ctrl"],
                             cfg["req_offset"], cfg["req_capacity"])
            self.resp = _Ring(self._mm, cfg["resp_ctrl"],
                              cfg["resp_offset"], cfg["resp_capacity"])
            self.bell = _Doorbell(self.resp, efd_resp, self._sock,
                                  "client")
            self.doorbells = telemetry.counter(
                "lgbm_shm_doorbell_syscalls_total")
        except Exception:
            self.close()
            raise

    def _expect_ok(self) -> None:
        frame = read_frame(self._rfile)
        if frame is None:
            raise ShmError("server closed during shm handshake")
        hdr, payload = frame
        if hdr[2] != MSG_SHM_OK:
            out = unpack_response(hdr, bytes(payload))
            raise ShmError("shm setup rejected: %s"
                           % out.get("reason", hdr[2]))

    # -- producing ----------------------------------------------------------
    def submit_nowait(self, X: np.ndarray, model_id: str = "default",
                      priority: int = 0) -> Optional[Dict[str, Any]]:
        """Write one request frame; returns None on success or the
        typed retryable reject dict when the ring is full."""
        need = _write_request(self.req, X, model_id, priority)
        if need is None:
            return {"error": "rejected", "reason": "ring_full",
                    "retryable": True, "retry_after_s": 0.002}
        self.inflight += 1
        self.bell.ring_peer(self.req, self.efd_req, self.doorbells)
        from . import resilience
        resilience.maybe_die_at_ring(self.inflight)
        return None

    # -- consuming ----------------------------------------------------------
    def read_response(self,
                      timeout: Optional[float] = None) -> Dict[str, Any]:
        """Pop the next response frame (FIFO with the requests).  The
        returned values are copied out of the ring, so the frame's
        bytes are freed before this returns."""
        if not self.bell.wait(self.doorbells,
                              timeout if timeout is not None
                              else self.timeout):
            raise WireFrameError("shm_timeout", "no response in ring")
        item = self.resp.try_pop()
        if item is None:                # spurious wake
            return self.read_response(timeout)
        hdr, payload_off, span = item
        payload_len = hdr[8]
        payload = bytes(self._mm[payload_off:payload_off + payload_len])
        if zlib.crc32(payload) & 0xFFFFFFFF != hdr[9]:
            self.resp.advance(span)
            self.inflight -= 1
            raise WireFrameError("bad_crc", fatal=False)
        out = unpack_response(hdr, payload)
        self.resp.advance(span)
        self.inflight -= 1
        return out

    def request_once(self, X: np.ndarray, model_id: str = "default",
                     priority: int = 0) -> Dict[str, Any]:
        rej = self.submit_nowait(X, model_id, priority)
        if rej is not None:
            return rej
        return self.read_response()

    def predict(self, X: np.ndarray, model_id: str = "default",
                attempts: int = 3, priority: int = 0) -> Dict[str, Any]:
        """Retryable-reject backoff loop — `WireClient.predict` parity."""
        last: Optional[Dict[str, Any]] = None
        for a in range(max(attempts, 1)):
            out = self.request_once(X, model_id, priority=priority)
            if "error" not in out:
                return out
            last = out
            if not out.get("retryable"):
                break
            if a + 1 < max(attempts, 1):
                time.sleep(max(float(out.get("retry_after_s") or 0.0),
                               0.01))
        assert last is not None
        raise WireFrameError("rejected", last.get("reason", ""),
                             fatal=False)

    def close(self) -> None:
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for fd in self._fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds = []
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None

    def __enter__(self) -> "ShmClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
