"""Event-loop S3 front door: accept/parse/keep-alive for 10k+ sockets
on a handful of loop threads, with request EXECUTION handed to a worker
pool so every handler in ``s3/server.py`` (and the storage/erasure/
kernel layers below) stays synchronous and semantically unchanged.

The thread-per-connection front end (``ThreadingHTTPServer``) costs one
OS stack per socket — idle keep-alive connections are exactly as
expensive as active ones, which caps realistic concurrency in the low
thousands.  This module replaces only L1: the listener, HTTP/1.1
framing, and body/response streaming live on asyncio event loops; the
moment a request head is parsed the connection hands an ``_AsyncTxn``
to the shared request core (``S3Server._serve_one``), which runs on a
bounded ``ThreadPoolExecutor`` exactly like a handler thread used to.

Key boundaries (why each piece looks the way it does):

- **BodyBridge** (async→sync): request bodies stream from the socket
  into the erasure pipeline through a bounded chunk queue.  The loop
  feeds chunks as they arrive and pauses the transport past the high
  water mark, so backpressure propagates to the client socket instead
  of buffering the object in memory; the worker blocks on a condition
  variable with the same 120s stall deadline the threaded server's
  socket timeout enforced.  Chunks pass through as the ``bytes``
  objects asyncio delivered (split via memoryview) — no re-buffering.

- **Expect: 100-continue**: a request carrying it dispatches BEFORE the
  body exists; the interim 100 goes out lazily on the bridge's first
  read.  QoS admission (``route_qos``) therefore runs — and can shed —
  before the client uploads a byte.

- **Slot release is tied to connection teardown**: ``connection_lost``
  abandons the bridge (a worker blocked mid-body wakes with
  ``ConnectionResetError``, unwinds through the core's finally, and
  releases its admission slot) and fails the response-drain waiters
  (a detached streaming response runs its finish callback).  An
  aborted client can never leak a slot.

- **Streaming responses park a connection, not a thread**: when a
  handler returns an iterator body, the worker detaches and the
  connection's loop pulls each chunk via ``run_in_executor`` under the
  request's copied contextvars (deadline/lane/span parent survive the
  hop); between chunks a slow reader holds only the connection and its
  bounded write buffer.

- **Keep-alive hygiene after an early response** (shed, burnt
  deadline, auth failure): the connection is left in a READABLE state
  per Content-Length — small unread remainders are discarded by the
  loop before the next request parses; large ones answer with
  ``Connection: close``; an Expect body that was never solicited
  closes too (the only framing-safe option once the client may or may
  not send it).  Nothing desyncs the next pipelined request.

Tuning knobs (env):
- ``MINIO_FRONT_DOOR``          async (default) | threaded
- ``MINIO_FRONT_DOOR_WORKERS``  request-execution threads (default 64)
- ``MINIO_LOOP_THREADS``        event-loop threads (default 1)
- ``MINIO_SHUTDOWN_DRAIN``      SIGTERM drain seconds (default 10)

The port's own copy of ``minio_tpu/s3/asyncserver.py``, with no change in
behaviour.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from email.utils import formatdate
from http.client import responses as _REASONS

# Bridge flow control: pause the transport past HIGH, resume at LOW.
BRIDGE_HIGH_WATER = 512 * 1024
BRIDGE_LOW_WATER = 128 * 1024
# Pipelined bytes buffered while a request executes, before the
# transport pauses (the next request's head + change).
PIPELINE_BUF_MAX = 1 * 1024 * 1024
# A request head larger than this is an attack or a bug.
MAX_HEAD_BYTES = 64 * 1024
# Chunked requests that are NOT streamed object PUTs (sub-resource
# writes, POSTs) buffer to completion like their Content-Length twins;
# with no declared length this cap is what bounds them.
CHUNKED_BUF_MAX = 64 * 1024 * 1024
# Same stall deadline the threaded server's socket timeout enforced.
STALL_TIMEOUT_S = 120.0
# Idle keep-alive reaper period (sweep granularity, not precision).
SWEEP_PERIOD_S = 15.0
# Lingering-close window: how long a half-closed connection keeps
# discarding an abandoned body before the socket is cut.
LINGER_S = 3.0

_ALLOWED_METHODS = ("GET", "PUT", "POST", "DELETE", "HEAD", "OPTIONS")


def _metrics():
    from ..obs.metrics2 import METRICS2
    return METRICS2


class BodyBridge:
    """Bounded async→sync reader: the loop feeds socket chunks, the
    worker consumes them with ``read(n)`` (the repo's ``Reader``
    contract: up to n bytes, ``b""`` at EOF).  Implements the lazy
    100-continue and the backpressure handshake."""

    def __init__(self, conn: "_HttpConn", length: int,
                 expect_continue: bool):
        """length < 0 means UNKNOWN (chunked Transfer-Encoding): EOF is
        decoder-driven via finish() instead of a byte countdown."""
        self._conn = conn
        self.length = length
        self.expect = expect_continue
        self._chunks: collections.deque = collections.deque()
        self._buffered = 0
        self.received = 0     # wire bytes fed by the loop
        self._consumed = 0    # bytes handed to the worker
        self._cv = threading.Condition()
        self._eof = length == 0
        self._error: BaseException | None = None
        self._pause_hint = False
        self.continue_requested = False
        self.started = False  # any body byte arrived

    # -- loop side -----------------------------------------------------

    def feed(self, data) -> bool:
        """Append a chunk; returns True when the transport should
        pause (buffered past the high water mark)."""
        with self._cv:
            self.started = True
            self._chunks.append(data)
            self._buffered += len(data)
            self.received += len(data)
            if 0 <= self.length <= self.received:
                self._eof = True
            pause = self._buffered >= BRIDGE_HIGH_WATER
            if pause:
                self._pause_hint = True
            self._cv.notify_all()
            return pause

    def fail(self, exc: BaseException) -> None:
        """Abandon (connection teardown): wake readers with the error."""
        with self._cv:
            if self._error is None:
                self._error = exc
            self._cv.notify_all()

    # -- worker side ---------------------------------------------------

    @property
    def touched(self) -> bool:
        """A body byte arrived, or we solicited one with a 100."""
        return self.started or self.continue_requested

    def finish(self) -> None:
        """Chunked bodies: the loop-side decoder saw the terminal
        chunk — every wire byte of this body has been fed (the
        length countdown in feed() cannot apply when length < 0)."""
        with self._cv:
            self._eof = True
            self._cv.notify_all()

    def unread(self) -> int:
        """Body bytes the worker has not consumed (buffered or still
        on the wire)."""
        if self.length < 0:
            # Chunked: either the wire framing completed (reuse-safe —
            # a buffered-but-unconsumed remainder dies with the bridge,
            # the socket stream itself is clean) or the remainder is
            # unknowable and the connection must close.
            with self._cv:
                return 0 if self._eof else (1 << 30)
        return max(0, self.length - self._consumed)

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        want_continue = False
        with self._cv:
            if self.expect and not self.started \
                    and not self.continue_requested:
                self.continue_requested = True
                want_continue = True
        if want_continue:
            # Lazy 100: admission/shed already happened (or the caller
            # is the handler proper) — only now solicit the body.
            self._conn.send_continue_threadsafe()
        deadline = time.monotonic() + STALL_TIMEOUT_S
        with self._cv:
            while True:
                # Buffered data and a completed body are served even
                # after teardown (a drain of an already-received tail
                # must not fail); the error only gates WAITING.
                if self._chunks:
                    chunk = self._chunks.popleft()
                    if len(chunk) > n:
                        mv = memoryview(chunk)
                        self._chunks.appendleft(mv[n:])
                        chunk = mv[:n]
                    self._buffered -= len(chunk)
                    self._consumed += len(chunk)
                    resume = (self._pause_hint
                              and self._buffered <= BRIDGE_LOW_WATER)
                    if resume:
                        self._pause_hint = False
                    out = chunk if isinstance(chunk, bytes) \
                        else bytes(chunk)
                    if resume:
                        self._conn.resume_rx_threadsafe()
                    return out
                if self._eof:
                    return b""
                if self._error is not None:
                    err = self._error
                    raise ConnectionResetError(
                        f"client body aborted: {err}") from err
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        "client stopped sending the request body")
                self._cv.wait(min(left, 5.0))


class _ChunkedTooLarge(ValueError):
    """Decoded chunked body exceeded the caller's cap."""


class _ChunkedTEParser:
    """Incremental HTTP/1.1 chunked Transfer-Encoding decoder (loop
    side): feed() takes wire bytes and returns zero-copy memoryview
    slices of the DECODED payload (the views alias the fed ``bytes``
    object, so no copy happens until a consumer materializes one).

    Raises ValueError on framing violations and _ChunkedTooLarge when
    the decoded size passes ``max_decoded`` — an unbounded chunked
    upload must not get unbounded buffering just because it never
    declared a Content-Length."""

    MAX_LINE = 8192          # size-line bytes (hex size + extensions)
    MAX_TRAILER = 16 * 1024  # total trailer-section bytes

    def __init__(self, max_decoded: int):
        self._max = max_decoded
        self._line = bytearray()   # partial size/trailer line
        self._state = "size"       # size | data | data_end | trailer
        self._left = 0             # payload bytes still owed this chunk
        self._end_cr = False       # saw the CR of a chunk's CRLF tail
        self._trailer_len = 0
        self.decoded = 0
        self.done = False

    def feed(self, data: bytes) -> tuple[list, bytes]:
        """-> (decoded_slices, leftover): leftover is the wire tail
        past the terminal CRLF (the next pipelined request's bytes),
        always b"" until ``done``."""
        out: list = []
        mv = memoryview(data)
        i, n = 0, len(data)
        while i < n and not self.done:
            if self._state == "size":
                nl = data.find(b"\n", i)
                if nl < 0:
                    self._line += data[i:]
                    if len(self._line) > self.MAX_LINE:
                        raise ValueError("chunk size line too long")
                    return out, b""
                self._line += data[i:nl]
                i = nl + 1
                line = bytes(self._line).strip()
                self._line.clear()
                if len(line) > self.MAX_LINE:
                    raise ValueError("chunk size line too long")
                size_s = line.split(b";", 1)[0].strip()
                if not size_s:
                    raise ValueError("empty chunk size")
                size = int(size_s, 16)  # ValueError on junk
                if size == 0:
                    self._state = "trailer"
                else:
                    if self.decoded + size > self._max:
                        raise _ChunkedTooLarge(
                            "chunked body exceeds cap")
                    self._left = size
                    self._state = "data"
            elif self._state == "data":
                take = min(self._left, n - i)
                out.append(mv[i:i + take])
                self.decoded += take
                self._left -= take
                i += take
                if self._left == 0:
                    self._state = "data_end"
            elif self._state == "data_end":
                c = data[i]
                i += 1
                if c == 0x0A:
                    self._end_cr = False
                    self._state = "size"
                elif c == 0x0D and not self._end_cr:
                    self._end_cr = True
                else:
                    raise ValueError("bad chunk data terminator")
            else:  # trailer
                nl = data.find(b"\n", i)
                if nl < 0:
                    self._line += data[i:]
                    self._bound_trailer(n - i)
                    return out, b""
                line = bytes(self._line) + data[i:nl]
                self._bound_trailer(nl + 1 - i)
                self._line.clear()
                i = nl + 1
                if not line.strip():
                    self.done = True
        return out, bytes(data[i:]) if self.done else b""

    def _bound_trailer(self, grew: int) -> None:
        self._trailer_len += grew
        if self._trailer_len > self.MAX_TRAILER:
            raise ValueError("chunked trailer too large")


class _AsyncTxn:
    """The transport adapter ``S3Server._serve_one`` drives for one
    request on an async connection.  Writes are threadsafe enqueues to
    the loop; backpressure blocks the worker (with the stall deadline)
    via the protocol's pause/resume_writing callbacks."""

    DRAIN_MAX = 1 * 1024 * 1024

    def __init__(self, conn: "_HttpConn", command: str, raw_path: str,
                 query: str, headers: dict, body: bytes,
                 body_stream: BodyBridge | None, content_length: int):
        self.conn = conn
        self.command = command
        self.raw_path = raw_path
        self.query = query
        self.headers = headers
        self.body = body
        self.body_stream = body_stream
        self.content_length = content_length  # -1 = chunked (unknown)
        self.rx_length = max(content_length, 0)
        self.client_ip = conn.client_ip
        self.close_after = False
        self.detached = False
        self._pending_head: bytes | None = None

    # -- body hygiene --------------------------------------------------

    def prepare_body_cleanup(self) -> bool:
        """Decide how the unconsumed body tail keeps the connection
        framed; returns True when the response must carry
        ``Connection: close``.  The actual discard (when safe) happens
        on the loop after the response completes."""
        br = self.body_stream
        if br is None:
            return False
        left = br.unread()
        if left <= 0:
            return False
        if br.expect and not br.touched:
            # We never sent 100 and no byte arrived: the client MAY
            # still send the body (RFC 7231 allows it), so the only
            # framing-safe reuse answer is no reuse at all.
            self.close_after = True
            return True
        if left > self.DRAIN_MAX:
            self.close_after = True
            return True
        # Small tail: the loop discards it before parsing the next
        # request (conn.request_complete).
        return False

    def set_close(self) -> None:
        self.close_after = True

    # -- response plumbing ---------------------------------------------

    def send_head(self, status: int, headers: list) -> None:
        reason = _REASONS.get(status, "Unknown")
        out = [f"HTTP/1.1 {status} {reason}\r\n"
               f"Date: {formatdate(usegmt=True)}\r\n"]
        for k, v in headers:
            out.append(f"{k}: {v}\r\n")
        out.append("\r\n")
        # Held back until the first body write (or request end): head
        # + buffered body leave as ONE loop enqueue and one TCP
        # segment — at 10k connections the cross-thread wakeups are a
        # real cost.
        self._pending_head = "".join(out).encode("latin-1", "replace")

    def flush_head(self) -> None:
        head, self._pending_head = self._pending_head, None
        if head is not None:
            self.conn.send_from_worker(head)

    # Small buffered responses coalesce into the COMPLETION enqueue
    # (one cross-thread signal per request instead of two — futex
    # wakeups are expensive on this class of virtualised kernel).
    COALESCE_MAX = 256 * 1024

    def write(self, data) -> None:
        if not data:
            return
        head, self._pending_head = self._pending_head, None
        if head is not None:
            data = head + (data if isinstance(data, bytes)
                           else bytes(data))
            if len(data) <= self.COALESCE_MAX:
                self._pending_head = data  # ride the completion
                return
        self.conn.send_from_worker(data)

    def stream_response(self, resp, raw_path: str, finish_fn,
                        root_span) -> bool:
        """Hand the iterator body to the connection's loop: the loop
        pulls chunks through the worker pool under the request's
        copied context, so a slow reader parks this connection — not
        the worker thread that built the response.  Returns True
        (detached); the drain task owns finish_fn from here."""
        self.flush_head()
        ctx = contextvars.copy_context()
        # This pooled worker thread is about to return to the pool:
        # clear the root span's contextvar token HERE (same thread
        # that set it) so the span context cannot leak into the next
        # request this thread serves; the copied `ctx` above still
        # carries the span for the chunk pulls.
        if root_span is not None:
            root_span.detach_context()
        self.detached = True
        self.conn.start_drain_threadsafe(resp.body, raw_path, finish_fn,
                                         ctx, self.close_after)
        return True


def _next_chunk(it):
    """One producer step, run on the worker pool under the request's
    copied context; None marks exhaustion (StopIteration must not
    cross the executor boundary)."""
    try:
        return next(it)
    except StopIteration:
        return None


class _HttpConn(asyncio.Protocol):
    """One keep-alive client connection: HTTP/1.1 head parsing, body
    framing (buffered / bridged), response sequencing, pipelining
    buffer, and teardown-tied cleanup."""

    def __init__(self, front: "AsyncFrontDoor", loop):
        self.front = front
        self._loop = loop
        self.transport = None
        self.client_ip = "?"
        self._buf = bytearray()
        self._state = "head"          # head | body | stream | wait
        self._head: tuple | None = None  # (method, path, query, headers)
        self._need = 0                # buffered-body bytes still wanted
        self._bridge: BodyBridge | None = None
        self._body_left = 0           # wire bytes of the current body
        self._chunked: _ChunkedTEParser | None = None
        self._chunk_acc: bytearray | None = None  # buffered-mode body
        self._discard_left = 0        # post-response tail to discard
        self._continue_sent = False
        self._closed = False
        self._draining = False        # close after the current response
        self._rx_paused = False
        self._writable = threading.Event()
        self._writable.set()
        self._paused = False
        self._drain_waiters: list = []
        self._in_flight = False
        self._finish_cb = None        # teardown safety for detached fns
        self._peer_eof = False        # half-closed with a response owed
        self.last_activity = time.monotonic()

    # ---- asyncio.Protocol callbacks (loop thread) --------------------

    def connection_made(self, transport) -> None:
        self.transport = transport
        peer = transport.get_extra_info("peername")
        if peer:
            self.client_ip = peer[0]
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                1)
            except OSError:
                pass
        transport.set_write_buffer_limits(high=1 << 20, low=1 << 18)
        self.front.conn_opened(self)

    def connection_lost(self, exc) -> None:
        self._closed = True
        self._writable.set()  # unblock any worker mid-write
        if self._bridge is not None:
            self._bridge.fail(exc or ConnectionResetError(
                "connection closed"))
        for fut in self._drain_waiters:
            if not fut.done():
                fut.set_exception(ConnectionResetError(
                    "connection closed"))
        self._drain_waiters.clear()
        self._paused = False
        # Teardown safety net: a DETACHED streaming response whose
        # drain task already died (or never ran) must still account
        # its request and release its admission slot.
        cb, self._finish_cb = self._finish_cb, None
        if cb is not None:
            # mtpu-lint: disable=R1 -- request context died with the connection; finish_fn only accounts and releases
            self.front.stream_pool.submit(_safe_call, cb)
        self.front.conn_closed(self)

    def pause_writing(self) -> None:
        self._paused = True
        self._writable.clear()

    def resume_writing(self) -> None:
        self._paused = False
        self._writable.set()
        waiters, self._drain_waiters = self._drain_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    def data_received(self, data: bytes) -> None:
        self.last_activity = time.monotonic()
        if self._state == "linger":
            return  # closing: the tail is discarded wholesale
        if self._discard_left > 0:
            if len(data) <= self._discard_left:
                self._discard_left -= len(data)
                return
            data = data[self._discard_left:]
            self._discard_left = 0
        if self._chunked is not None:
            self._feed_chunked(data)
            return
        if self._body_left > 0 and self._bridge is not None:
            if len(data) <= self._body_left:
                self._body_left -= len(data)
                if self._bridge.feed(data) and not self._rx_paused:
                    self._rx_paused = True
                    self.transport.pause_reading()
                return
            head, rest = data[:self._body_left], data[self._body_left:]
            self._body_left = 0
            self._bridge.feed(head)
            data = rest
        self._buf += data
        if self._state in ("head", "body"):
            self._process_buf()
        elif len(self._buf) > PIPELINE_BUF_MAX and not self._rx_paused:
            # Pipelined bytes beyond the cap: make the client wait for
            # the current response instead of buffering its backlog.
            self._rx_paused = True
            self.transport.pause_reading()

    def eof_received(self):
        if self._chunked is not None:
            # Torn mid-chunk: a streamed PUT's reader gets the error
            # (its worker answers and releases the slot); a buffered
            # chunked request never dispatched — just close.
            self._chunked = None
            self._chunk_acc = None
            if self._bridge is not None:
                self._bridge.fail(ConnectionResetError(
                    "client half-closed mid-body"))
            return False
        if self._bridge is not None and self._body_left > 0:
            self._bridge.fail(ConnectionResetError(
                "client half-closed mid-body"))
            return False
        if self._in_flight or self._buf:
            # Half-close AFTER a complete request (shutdown(SHUT_WR)
            # then read — Go clients' CloseWrite): the response is
            # still owed; keep the transport open and close once the
            # request completes.
            self._peer_eof = True
            return True
        return False  # idle half-close: just close

    # ---- parsing (loop thread) ---------------------------------------

    def _process_buf(self) -> None:
        while True:
            if self._state == "head":
                idx = self._buf.find(b"\r\n\r\n")
                if idx < 0:
                    if len(self._buf) > MAX_HEAD_BYTES:
                        self._reject(431, "request head too large")
                    elif self._buf[:1] and not self._buf[:1].isalpha():
                        self._reject(400, "malformed request line")
                    return
                head = bytes(self._buf[:idx])
                del self._buf[:idx + 4]
                if not self._parse_head(head):
                    return
                if self._state != "body":
                    return  # dispatched (stream or empty body)
            if self._state == "body":
                if len(self._buf) < self._need:
                    return
                body = bytes(self._buf[:self._need])
                del self._buf[:self._need]
                self._need = 0
                method, path, query, headers, cl = self._head
                self._dispatch(method, path, query, headers, body,
                               None, cl)
                return

    def _parse_head(self, head: bytes) -> bool:
        """Parse one request head from `head`; returns False when the
        connection was rejected."""
        try:
            text = head.decode("latin-1")
            lines = text.split("\r\n")
            method, target, version = lines[0].split(" ", 2)
        except (ValueError, IndexError):
            self._reject(400, "malformed request line")
            return False
        if not version.startswith("HTTP/1."):
            self._reject(505, "unsupported HTTP version")
            return False
        if method not in _ALLOWED_METHODS:
            self._reject(501, f"method {method} not implemented")
            return False
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            k, sep, v = line.partition(":")
            if not sep:
                self._reject(400, "malformed header line")
                return False
            headers[k.strip().lower()] = v.strip()
        raw_path, _, query = target.partition("?")
        try:
            cl = int(headers.get("content-length", 0) or 0)
            if cl < 0:
                raise ValueError
        except ValueError:
            self._reject(400, "bad Content-Length")
            return False
        te = headers.get("transfer-encoding", "").strip().lower()
        chunked = te == "chunked"
        if te and not chunked:
            # Only the terminal "chunked" coding is implemented (what
            # real SDKs send; gzip'd request bodies are not a thing S3
            # clients do).
            self._reject(501, f"transfer encoding {te} unsupported")
            return False
        if chunked and "content-length" in headers:
            # RFC 7230 §3.3.3: a message with both is a smuggling
            # vector — never guess, reject.
            self._reject(400, "both Content-Length and "
                              "Transfer-Encoding")
            return False
        if chunked and version == "HTTP/1.0":
            self._reject(400, "chunked framing requires HTTP/1.1")
            return False
        if version == "HTTP/1.0" and \
                headers.get("connection", "").lower() != "keep-alive":
            self._draining = True
        if headers.get("connection", "").lower() == "close":
            self._draining = True
        expect = "100-continue" in headers.get("expect", "").lower()
        server = self.front.server
        is_s3 = not raw_path.startswith("/minio-tpu/")
        if chunked:
            return self._begin_chunked(method, raw_path, query,
                                       headers, expect, is_s3)
        # Bridge (stream) only object PUTs: large ones like the
        # threaded path, plus ANY carrying Expect (admission must run
        # before the upload). Everything else — STS POSTs, multipart
        # completes, sub-resource writes — buffers exactly like the
        # threaded front end, so handlers that read req.body before
        # route()'s drain point keep their semantics.
        want_stream = (is_s3 and cl > 0 and method == "PUT"
                       and "/" in raw_path.lstrip("/")
                       and (expect
                            or cl >= server.stream_threshold))
        if want_stream:
            self._bridge = BodyBridge(self, cl, expect)
            self._body_left = cl
            self._continue_sent = False
            # Bytes already buffered (client didn't wait) feed through.
            if self._buf:
                take = min(len(self._buf), self._body_left)
                self._body_left -= take
                self._bridge.feed(bytes(self._buf[:take]))
                del self._buf[:take]
            self._dispatch(method, raw_path, query, headers, b"",
                           self._bridge, cl)
            return True
        if cl > 0:
            if expect:
                # Buffered mode still honors the handshake — solicit
                # the body now, before waiting for it.
                self._send_continue()
            self._head = (method, raw_path, query, headers, cl)
            self._need = cl
            self._state = "body"
            return True
        self._dispatch(method, raw_path, query, headers, b"", None, 0)
        return True

    def _begin_chunked(self, method: str, raw_path: str, query: str,
                       headers: dict, expect: bool, is_s3: bool) -> bool:
        """Set up chunked-body decode. Object PUTs stream through the
        BodyBridge with length -1 (the decoder drives EOF) straight
        into the erasure pipeline — the zero-copy path real SDKs'
        streaming-SigV4 uploads take. Everything else buffers the
        decoded body to completion (capped) and dispatches exactly
        like a Content-Length request."""
        stream = (is_s3 and method == "PUT"
                  and "/" in raw_path.lstrip("/"))
        if stream:
            from .server import MAX_OBJECT_SIZE
            self._chunked = _ChunkedTEParser(MAX_OBJECT_SIZE + 1)
            self._chunk_acc = None
            self._bridge = BodyBridge(self, -1, expect)
            self._continue_sent = False
            self._dispatch(method, raw_path, query, headers, b"",
                           self._bridge, -1)
        else:
            if expect:
                self._send_continue()
            self._chunked = _ChunkedTEParser(CHUNKED_BUF_MAX)
            self._chunk_acc = bytearray()
            self._head = (method, raw_path, query, headers, -1)
            self._state = "chunk"
        if self._buf:
            # Bytes the client sent behind the head feed through.
            data0 = bytes(self._buf)
            self._buf.clear()
            self._feed_chunked(data0)
        return True

    def _feed_chunked(self, data: bytes) -> None:
        """Run wire bytes through the chunked decoder (loop thread)."""
        parser = self._chunked
        try:
            slices, leftover = parser.feed(data)
        except ValueError as e:
            self._chunked = None
            if self._chunk_acc is not None or self._bridge is None:
                # Nothing dispatched yet: protocol-level reject.
                self._chunk_acc = None
                status = 413 if isinstance(e, _ChunkedTooLarge) else 400
                self._reject(status, f"bad chunked framing: {e}")
            else:
                # A streamed PUT is mid-flight: fail its body reader
                # (the worker answers the error and releases its slot)
                # and stop trusting this connection's framing.
                self._bridge.fail(e)
                self._draining = True
            return
        if self._chunk_acc is not None:
            for piece in slices:
                self._chunk_acc += piece
        elif self._bridge is not None:
            pause = False
            for piece in slices:
                # memoryview slices of `data`: the bridge consumer
                # materializes exactly once, on read.
                if self._bridge.feed(piece):
                    pause = True
            if pause and not self._rx_paused:
                self._rx_paused = True
                self.transport.pause_reading()
        if parser.done:
            self._chunked = None
            if leftover:
                self._buf += leftover  # next pipelined request
            if self._chunk_acc is not None:
                body = bytes(self._chunk_acc)
                self._chunk_acc = None
                method, raw_path, query, headers, _cl = self._head
                self._dispatch(method, raw_path, query, headers, body,
                               None, len(body))
            elif self._bridge is not None:
                self._bridge.finish()

    def _reject(self, status: int, why: str) -> None:
        """Protocol-level error: answer (when possible) and close."""
        _metrics().inc("minio_tpu_v2_conn_parse_errors_total")
        reason = _REASONS.get(status, "Bad Request")
        body = f"{why}\n".encode()
        try:
            self.transport.write(
                (f"HTTP/1.1 {status} {reason}\r\n"
                 f"Content-Length: {len(body)}\r\n"
                 "Connection: close\r\n\r\n").encode() + body)
            self.transport.close()
        except Exception:  # noqa: BLE001 - already tearing down
            pass
        self._state = "closed"

    # ---- dispatch to the worker pool (loop thread) -------------------

    def _dispatch(self, method, raw_path, query, headers, body,
                  bridge, cl) -> None:
        self._state = "wait"
        self._in_flight = True
        txn = _AsyncTxn(self, method, raw_path, query, headers, body,
                        bridge, cl)
        pool = (self.front.rpc_pool
                if raw_path.startswith("/minio-tpu/rpc/")
                else self.front.pool)
        try:
            # mtpu-lint: disable=R1 -- front-door boundary: a FRESH request context is opened inside _serve_one, there is none to carry
            pool.submit(self.front.run_request, self, txn)
        except RuntimeError:  # pool shut down mid-accept
            self._in_flight = False
            self._reject(503, "server shutting down")

    # ---- worker-facing plumbing (worker thread) ----------------------

    # One enqueue never exceeds this: a multi-MiB buffered body (hot
    # cache hit) written in one transport.write() would land in the
    # write buffer WHOLE before pause_writing can matter — at 10k
    # connections a fleet of slow readers would pin conns x body-size
    # of RSS. Chunking with a writability wait between chunks bounds
    # each connection near the transport's high-water mark (the
    # threaded path got the same bound from blocking socket writes).
    WRITE_CHUNK = 256 * 1024

    def send_from_worker(self, data) -> None:
        if len(data) <= self.WRITE_CHUNK:
            self._send_one(data)
            return
        mv = memoryview(data)
        for off in range(0, len(mv), self.WRITE_CHUNK):
            self._send_one(bytes(mv[off:off + self.WRITE_CHUNK]))

    def _send_one(self, data) -> None:
        if not self._writable.wait(STALL_TIMEOUT_S):
            raise ConnectionResetError("client stopped reading "
                                       "(write stalled)")
        if self._closed:
            raise ConnectionResetError("connection closed")
        try:
            self._loop.call_soon_threadsafe(self._tx, data)
        except RuntimeError:
            raise ConnectionResetError("event loop stopped")

    def send_continue_threadsafe(self) -> None:
        try:
            self._loop.call_soon_threadsafe(self._send_continue)
        except RuntimeError:
            pass

    def resume_rx_threadsafe(self) -> None:
        try:
            self._loop.call_soon_threadsafe(self._maybe_resume)
        except RuntimeError:
            pass

    def complete_from_worker(self, close: bool,
                             tail: bytes | None = None) -> None:
        try:
            self._loop.call_soon_threadsafe(
                self._finish_and_complete, close, tail)
        except RuntimeError:
            pass

    def _finish_and_complete(self, close: bool,
                             tail: bytes | None) -> None:
        if tail:
            self._tx(tail)
        self.request_complete(close)

    def start_drain_threadsafe(self, body_iter, raw_path, finish_fn,
                               ctx, close_after) -> None:
        self._finish_cb = finish_fn
        try:
            self._loop.call_soon_threadsafe(
                self._spawn_drain, body_iter, raw_path, finish_fn, ctx,
                close_after)
        except RuntimeError:
            # Loop gone: account the request here; connection is dead.
            self._finish_cb = None
            _safe_call(getattr(body_iter, "close", lambda: None))
            _safe_call(finish_fn)

    # ---- loop-side helpers -------------------------------------------

    def _tx(self, data) -> None:
        if not self._closed and self.transport is not None:
            self.transport.write(data)

    def _send_continue(self) -> None:
        if not self._continue_sent and not self._closed:
            self._continue_sent = True
            if self._bridge is not None:
                self._bridge.started = True
            self.transport.write(b"HTTP/1.1 100 Continue\r\n\r\n")

    def _maybe_resume(self) -> None:
        if self._rx_paused and not self._closed:
            self._rx_paused = False
            self.transport.resume_reading()

    def _force_close(self) -> None:
        if not self._closed:
            try:
                self.transport.abort()
            except Exception:  # noqa: BLE001
                pass

    def request_complete(self, close: bool) -> None:
        """The response for the in-flight request is fully queued:
        restore framing (discard any small body tail), then either
        close or go parse the next pipelined request."""
        self._in_flight = False
        self._finish_cb = None
        if self._closed:
            return
        tail = 0
        if self._bridge is not None:
            # Wire bytes still owed for this body; anything the loop
            # already fed the bridge left the socket stream, so only
            # the un-received remainder threatens the framing.
            tail = self._body_left
            if self._bridge.length < 0 and self._bridge.unread() > 0:
                # Chunked body not fully framed: the remainder is
                # unknowable, so the only safe exit is the lingering
                # close below (prepare_body_cleanup already forced
                # Connection: close for this case).
                tail = max(tail, 1)
            self._bridge = None
        self._chunked = None
        self._chunk_acc = None
        self._body_left = 0
        if self._peer_eof and (tail > 0 or not self._buf):
            # The peer already half-closed and nothing of use remains:
            # finish the write side and be done. (With a complete
            # PIPELINED request still buffered — sendall(A+B) then
            # CloseWrite — fall through and answer it first; a body
            # tail, by contrast, can never complete after EOF.)
            self.transport.close()
            self._state = "closed"
            return
        if close or self._draining:
            if tail > 0:
                # Lingering close: the client may still be sending the
                # body — an immediate close() would turn its unread
                # bytes into a TCP RST that can destroy the queued
                # response. Half-close (FIN after the response
                # flushes), discard whatever still arrives, and cut
                # the cord shortly after.
                self._state = "linger"
                try:
                    if self.transport.can_write_eof():
                        self.transport.write_eof()
                except (OSError, RuntimeError):
                    pass
                self._maybe_resume()
                self._loop.call_later(LINGER_S, self._force_close)
                return
            self.transport.close()
            self._state = "closed"
            return
        if tail > 0:
            self._discard_left = tail
        self._continue_sent = False
        self._state = "head"
        self.last_activity = time.monotonic()
        self._maybe_resume()
        if self._buf:
            self._process_buf()

    def _spawn_drain(self, body_iter, raw_path, finish_fn, ctx,
                     close_after) -> None:
        task = self._loop.create_task(self._drain_response(
            body_iter, raw_path, finish_fn, ctx, close_after))
        self.front.track_task(task)

    async def _drain_response(self, body_iter, raw_path, finish_fn,
                              ctx, close_after) -> None:
        # `finish_fn` ownership: this task and connection_lost's
        # safety net both run on THIS loop, so whoever still finds
        # self._finish_cb set owns the accounting call — exactly one
        # of them submits it (a double finish would double-release
        # the admission slot).
        """Pump a streaming response body to the socket: each chunk is
        produced on the worker pool under the request's copied context
        (shard-read spans still attach, deadline/lane semantics hold),
        written, then awaited against the transport's flow control —
        a slow reader parks here, holding no thread."""
        loop = self._loop
        ok = True
        pending = None
        try:
            while True:
                pending = loop.run_in_executor(
                    self.front.stream_pool, ctx.run, _next_chunk,
                    body_iter)
                chunk = await pending
                pending = None
                if chunk is None:
                    break
                if not chunk:
                    continue
                if self._closed:
                    raise ConnectionResetError("connection closed")
                self.transport.write(chunk)
                await self._wait_writable()
        except (BrokenPipeError, ConnectionResetError):
            ok = False
        except asyncio.CancelledError:
            ok = False
        except Exception as e:  # noqa: BLE001
            # Mid-stream decode/auth failure AFTER the 200 went out:
            # abort the connection so the client sees a short body,
            # never a clean success (same policy as the threaded path).
            ok = False
            from ..logger import Logger
            Logger.get().log_once(
                f"streaming GET {raw_path} aborted mid-body: "
                f"{type(e).__name__}: {e}", "s3-stream-abort")
        finally:
            owns_finish = self._finish_cb is not None
            self._finish_cb = None
            # Producer cleanup + request accounting run OFF the loop:
            # generator close walks engine finally blocks (disk I/O,
            # pipeline teardown) and finish_fn records slowlog/trace.
            # mtpu-lint: disable=R1 -- cleanup of a finished request; its context is carried inside the closure via ctx
            self.front.stream_pool.submit(
                _close_and_finish, pending, body_iter,
                finish_fn if owns_finish else None)
            if ok:
                self.request_complete(close_after)
            elif not self._closed:
                # abort(), not close(): a peer that stopped READING is
                # the usual reason we are here, and close() waits for
                # the unflushable write buffer — the connection would
                # sit in the census forever (reap skips in-flight).
                self.transport.abort()
                self._state = "closed"

    async def _wait_writable(self) -> None:
        if not self._paused or self._closed:
            return
        fut = self._loop.create_future()
        self._drain_waiters.append(fut)
        await asyncio.wait_for(fut, STALL_TIMEOUT_S)

    # ---- sweep hooks (loop thread) -----------------------------------

    def idle_for(self, now: float) -> float:
        return now - self.last_activity

    def reap_if_idle(self, now: float, timeout: float) -> None:
        """Close connections with nothing in flight that have been
        silent past the keep-alive timeout (the threaded server's
        idle reaper, amortized into a periodic sweep)."""
        if self._closed or self._in_flight:
            return
        if self.idle_for(now) > timeout:
            try:
                self.transport.close()
            except Exception:  # noqa: BLE001
                pass


def raise_nofile_limit(cap: int = 65536) -> int:
    """Best-effort RLIMIT_NOFILE soft→hard raise: a 10k-connection
    front door (or loadgen fleet) dies at the default 1024 soft limit
    otherwise. Returns the effective soft limit (0 = unknown)."""
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = cap if hard == resource.RLIM_INFINITY else min(cap, hard)
        if want > soft:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
            soft = want
        return soft
    except (ImportError, ValueError, OSError):
        return 0


def _safe_call(fn) -> None:
    try:
        fn()
    except Exception:  # noqa: BLE001 - teardown best effort
        pass


def _close_and_finish(pending, body_iter, finish_fn) -> None:
    """Off-loop cleanup for a detached streaming response: wait out a
    producer step still running (a generator cannot be closed while
    executing), close it, then run the request-finish accounting
    (None when connection teardown already owns that call)."""
    if pending is not None:
        try:
            pending.result(timeout=STALL_TIMEOUT_S)
        except Exception:  # noqa: BLE001 - producer died; close anyway
            pass
    close = getattr(body_iter, "close", None)
    if close is not None:
        _safe_call(close)
    if finish_fn is not None:
        _safe_call(finish_fn)


class AsyncFrontDoor:
    """Owns the listen socket, the loop threads, the worker pool, and
    the connection census; ``S3Server.start`` boots one of these unless
    ``MINIO_FRONT_DOOR=threaded``."""

    def __init__(self, server, cert_manager=None, workers: int = 0,
                 loop_threads: int = 0, keepalive_timeout: float = 120.0):
        import os
        self.server = server
        self.cert_manager = cert_manager
        self.keepalive_timeout = keepalive_timeout
        workers = workers or int(os.environ.get(
            "MINIO_FRONT_DOOR_WORKERS", "0") or 0) or 64
        loop_threads = loop_threads or int(os.environ.get(
            "MINIO_LOOP_THREADS", "0") or 0) or 1
        self.pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="s3-worker")
        # Peer RPC (storage reads, locks, control plane) rides the
        # same port but NOT the same executor: the RPC client's
        # self-tuning timeout shrinks toward 1s against fast local
        # peers, so a storage RPC queued behind a burst of S3 work
        # would time out, trip the peer health gate, and fast-fail a
        # whole node's shards for the retry window — a distributed
        # GET's parity fallback must never starve behind front-door
        # load.
        self.rpc_pool = ThreadPoolExecutor(
            max_workers=max(8, workers // 4),
            thread_name_prefix="s3-rpc")
        # Detached streaming-response chunk pulls get their own small
        # pool too: under a read burst every `pool` worker can be
        # parked in a QoS admission WAIT — if the chunk pulls queued
        # behind them, the streaming GETs HOLDING the contended slots
        # could not progress to release them (priority inversion; the
        # waiters would burn their deadlines and shed).
        self.stream_pool = ThreadPoolExecutor(
            max_workers=max(8, workers // 4),
            thread_name_prefix="s3-stream")
        self._n_loops = max(1, loop_threads)
        self._loops: list = []
        self._threads: list[threading.Thread] = []
        self._tasks: list = []
        self._lsock: socket.socket | None = None
        self._lsocks: list[socket.socket] = []  # SO_REUSEPORT, per loop
        self.reuseport = False
        self._mu = threading.Lock()
        self._conns: set[_HttpConn] = set()
        self._accept_pending = 0
        self._accepted_total = 0
        self._next_loop = 0
        self._running = False

    # -- lifecycle ------------------------------------------------------

    def start(self, host: str, port: int) -> int:
        import os
        raise_nofile_limit()
        # Multi-loop accept via SO_REUSEPORT: each loop thread owns
        # its OWN listen socket bound to the same port, so the KERNEL
        # load-spreads incoming connections across loops — no accept
        # handoff, no cross-loop self-pipe wakeup per connection.
        # Falls back to the single-socket round-robin accept loop when
        # the option is unavailable (or MINIO_REUSEPORT=off).
        want_reuseport = (
            hasattr(socket, "SO_REUSEPORT")
            and os.environ.get("MINIO_REUSEPORT", "on").strip().lower()
            not in ("off", "0", "no"))
        if want_reuseport:
            try:
                bind_port = port
                for _ in range(self._n_loops):
                    s = socket.socket(socket.AF_INET,
                                      socket.SOCK_STREAM)
                    try:
                        s.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
                        s.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEPORT, 1)
                        s.bind((host, bind_port))
                        s.listen(1024)
                        s.setblocking(False)
                    except OSError:
                        s.close()
                        raise
                    self._lsocks.append(s)
                    # port 0: later sockets join the resolved port.
                    bind_port = self._lsocks[0].getsockname()[1]
            except OSError:
                for s in self._lsocks:
                    try:
                        s.close()
                    except OSError:
                        pass
                self._lsocks = []
        self.reuseport = bool(self._lsocks)
        if not self._lsocks:
            self._lsock = socket.socket(socket.AF_INET,
                                        socket.SOCK_STREAM)
            self._lsock.setsockopt(socket.SOL_SOCKET,
                                   socket.SO_REUSEADDR, 1)
            self._lsock.bind((host, port))
            self._lsock.listen(1024)
            self._lsock.setblocking(False)
        bound = (self._lsocks[0] if self._lsocks
                 else self._lsock).getsockname()[1]
        self._running = True
        ready = threading.Barrier(self._n_loops + 1)
        for i in range(self._n_loops):
            loop = asyncio.new_event_loop()
            self._loops.append(loop)
            # mtpu-lint: disable=R1 -- long-lived event-loop thread; request context is opened per request on the worker pool
            t = threading.Thread(target=self._run_loop,
                                 args=(loop, ready), daemon=True,
                                 name=f"s3-loop-{i}")
            t.start()
            self._threads.append(t)
        ready.wait(timeout=10)
        if self._lsocks:
            # Every loop accepts from its own socket into itself.
            for i in range(self._n_loops):
                self._call_on(i, self._start_accept_on, i)
        else:
            # Loop 0 owns accept; connections spread round-robin.
            self._call_on(0, self._start_accept)
        for i in range(self._n_loops):
            self._call_on(i, self._start_sweep, self._loops[i])
        # Health plane: every front-door loop heartbeats under loopmon
        # (obs/loopmon.py) — scheduling lag, census, stall captures.
        from ..obs.loopmon import LOOPMON
        for i in range(self._n_loops):
            LOOPMON.register(f"s3-{i}", self._loops[i])
        return bound

    def _run_loop(self, loop, ready) -> None:
        asyncio.set_event_loop(loop)
        try:
            ready.wait(timeout=10)
        except threading.BrokenBarrierError:
            pass
        loop.run_forever()
        # Drain callbacks scheduled during shutdown, then close.
        try:
            loop.run_until_complete(asyncio.sleep(0))
        except Exception:  # noqa: BLE001
            pass
        loop.close()

    def _call_on(self, idx: int, fn, *args) -> None:
        self._loops[idx].call_soon_threadsafe(fn, *args)

    def _start_accept(self) -> None:
        loop = self._loops[0]
        self.track_task(loop.create_task(
            self._accept_loop(loop, self._lsock, pinned=False)))

    def _start_accept_on(self, idx: int) -> None:
        loop = self._loops[idx]
        self.track_task(loop.create_task(
            self._accept_loop(loop, self._lsocks[idx], pinned=True)))

    def _start_sweep(self, loop) -> None:
        self.track_task(loop.create_task(self._sweep_loop(loop)))

    async def _accept_loop(self, loop, lsock, pinned: bool) -> None:
        """`pinned`: SO_REUSEPORT mode — this loop owns `lsock` and
        every connection it accepts; otherwise the single listener
        round-robins accepted sockets across all loops."""
        while self._running:
            try:
                sock, _addr = await loop.sock_accept(lsock)
            except asyncio.CancelledError:
                break
            except OSError as e:
                if not self._running:
                    break
                # Transient accept errors (EMFILE under a connection
                # burst, ECONNABORTED from a racing RST) must not kill
                # the front door — log, breathe, retry. Only a closed
                # listener (shutdown) exits.
                import errno
                if e.errno in (errno.EBADF, errno.ENOTSOCK):
                    break
                from ..logger import Logger
                Logger.get().log_once(
                    f"front door: accept failed: {e}", "fd-accept")
                await asyncio.sleep(0.05)
                continue
            with self._mu:
                self._accept_pending += 1
                self._accepted_total += 1
            _metrics().inc("minio_tpu_v2_connections_accepted_total")
            self._publish_gauges()
            if pinned:
                # The kernel already picked this loop: establish
                # in-place, zero handoff.  track_task keeps a strong
                # reference — the loop holds tasks only weakly, and an
                # untracked _establish could be garbage-collected
                # mid-handshake with its exception never observed.
                self.track_task(loop.create_task(
                    self._establish(sock, loop)))
                continue
            target = self._loops[self._next_loop % self._n_loops]
            self._next_loop += 1
            if target is loop:
                # Same loop (the 1-loop default): a direct task skips
                # the threadsafe self-pipe round trip per accept.
                self.track_task(loop.create_task(
                    self._establish(sock, target)))
            else:
                self.track_task(asyncio.run_coroutine_threadsafe(
                    self._establish(sock, target), target))

    async def _establish(self, sock, loop) -> None:
        """Runs on the connection's OWN loop: TLS handshake (when
        configured) + protocol hookup.  The ssl context is read at
        accept time so certificate hot-reload keeps working."""
        try:
            ssl_ctx = (self.cert_manager.context
                       if self.cert_manager is not None else None)
            await loop.connect_accepted_socket(
                lambda: _HttpConn(self, loop), sock, ssl=ssl_ctx,
                ssl_handshake_timeout=10.0 if ssl_ctx else None)
        except Exception:  # noqa: BLE001 - bad handshake/racing close
            _metrics().inc("minio_tpu_v2_conn_parse_errors_total")
            try:
                sock.close()
            except OSError:
                pass
        finally:
            with self._mu:
                self._accept_pending -= 1
            self._publish_gauges()

    async def _sweep_loop(self, loop) -> None:
        while self._running:
            await asyncio.sleep(SWEEP_PERIOD_S)
            now = time.monotonic()
            with self._mu:
                mine = [c for c in self._conns if c._loop is loop]
            for conn in mine:
                conn.reap_if_idle(now, self.keepalive_timeout)
            # Pool gauges go stale without connection churn (they only
            # publish on open/close); the sweep keeps them honest on
            # an idle server (rate-limiter dedupes across loops).
            self._publish_gauges()

    # -- request execution (worker pool) -------------------------------

    def run_request(self, conn: _HttpConn, txn: _AsyncTxn) -> None:
        try:
            self.server._serve_one(txn)
        except Exception as e:  # noqa: BLE001 - never kill the worker
            from ..logger import Logger
            Logger.get().log_once(
                f"front door: request crashed: "
                f"{type(e).__name__}: {e}", "front-door")
            txn.close_after = True
        finally:
            if not txn.detached:
                # Anything still held back (coalesced small response,
                # HEAD-only head) rides the completion enqueue: one
                # cross-thread signal finishes the request.
                tail, txn._pending_head = txn._pending_head, None
                conn.complete_from_worker(txn.close_after, tail)

    # -- census ---------------------------------------------------------

    def conn_opened(self, conn: _HttpConn) -> None:
        with self._mu:
            self._conns.add(conn)
        self._publish_gauges()

    def conn_closed(self, conn: _HttpConn) -> None:
        with self._mu:
            self._conns.discard(conn)
        self._publish_gauges()

    def open_connections(self) -> int:
        with self._mu:
            return len(self._conns)

    # Gauge publishing is rate-limited: at connection-churn rates the
    # two registry writes per open/close event are measurable, and a
    # gauge only needs to be right when somebody reads it.
    GAUGE_PUBLISH_S = 0.1

    def _publish_gauges(self, force: bool = False) -> None:
        now = time.monotonic()
        schedule_flush = False
        with self._mu:
            limited = (not force
                       and now - getattr(self, "_gauges_at", 0.0)
                       < self.GAUGE_PUBLISH_S)
            if limited:
                # Trailing flush so the LAST event of a churn burst
                # still lands (a gauge stuck on a pre-close value
                # would read as leaked connections).
                if not getattr(self, "_flush_scheduled", False):
                    self._flush_scheduled = True
                    schedule_flush = True
            else:
                self._gauges_at = now
                n, pend = len(self._conns), self._accept_pending
        if limited:
            if schedule_flush:
                try:
                    self._loops[0].call_soon_threadsafe(
                        self._loops[0].call_later,
                        self.GAUGE_PUBLISH_S * 1.2, self._flush_gauges)
                except (RuntimeError, IndexError):
                    with self._mu:
                        self._flush_scheduled = False
            return
        m = _metrics()
        m.set_gauge("minio_tpu_v2_open_connections", None, n)
        m.set_gauge("minio_tpu_v2_accept_queue_depth", None, pend)
        # Per-pool thread census: splits the timeline's flat thread
        # count so a stalled loop and an exhausted pool read
        # differently in mtpu_top.  Busy = spawned threads minus the
        # executor's idle semaphore (CPython internals, guarded — a
        # missing attribute reads as an all-idle pool, never a crash).
        for pname, pool in (("worker", self.pool),
                            ("rpc", self.rpc_pool),
                            ("stream", self.stream_pool)):
            threads = len(getattr(pool, "_threads", ()) or ())
            sem = getattr(pool, "_idle_semaphore", None)
            idle = getattr(sem, "_value", threads)
            m.set_gauge("minio_tpu_v2_pool_threads",
                        {"pool": pname}, threads)
            m.set_gauge("minio_tpu_v2_pool_threads_busy",
                        {"pool": pname},
                        max(0, threads - min(idle, threads)))

    def _flush_gauges(self) -> None:
        with self._mu:
            self._flush_scheduled = False
        self._publish_gauges(force=True)

    def track_task(self, task) -> None:
        with self._mu:
            self._tasks = [t for t in self._tasks if not t.done()]
            self._tasks.append(task)

    # -- shutdown -------------------------------------------------------

    def stop(self, drain_s: float = 10.0) -> None:
        """Graceful drain: stop accepting, let in-flight requests
        finish within ``drain_s``, then abort stragglers and stop the
        loops."""
        self._running = False
        # Heartbeats first: a loopmon task still pending when a loop
        # closes would log "Task was destroyed but it is pending!".
        from ..obs.loopmon import LOOPMON
        for i in range(len(self._loops)):
            LOOPMON.unregister(f"s3-{i}")
        for s in [*self._lsocks, self._lsock]:
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass
        self._lsocks = []
        # Close idle connections now; flag busy ones to close on
        # response completion.
        with self._mu:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn._loop.call_soon_threadsafe(self._drain_conn, conn)
            except RuntimeError:
                pass
        deadline = time.monotonic() + max(0.0, drain_s)
        while time.monotonic() < deadline:
            with self._mu:
                busy = any(c._in_flight for c in self._conns)
            if not busy:
                break
            time.sleep(0.05)
        with self._mu:
            leftovers = list(self._conns)
        for conn in leftovers:
            try:
                conn._loop.call_soon_threadsafe(self._abort_conn, conn)
            except RuntimeError:
                pass
        for loop in self._loops:
            try:
                loop.call_soon_threadsafe(self._shutdown_loop, loop)
            except RuntimeError:
                pass
        for t in self._threads:
            t.join(timeout=5)
        self.pool.shutdown(wait=False, cancel_futures=True)
        self.rpc_pool.shutdown(wait=False, cancel_futures=True)
        self.stream_pool.shutdown(wait=False, cancel_futures=True)
        self._publish_gauges()

    @staticmethod
    def _drain_conn(conn: _HttpConn) -> None:
        conn._draining = True
        if not conn._in_flight and not conn._closed:
            try:
                conn.transport.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _abort_conn(conn: _HttpConn) -> None:
        if not conn._closed:
            try:
                conn.transport.abort()
            except Exception:  # noqa: BLE001
                pass

    def _shutdown_loop(self, loop) -> None:
        with self._mu:
            mine = [t for t in self._tasks
                    if getattr(t, "get_loop", lambda: None)() is loop]
        for task in mine:
            task.cancel()
        loop.stop()
