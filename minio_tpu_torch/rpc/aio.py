"""Async peer-RPC fabric: every internal hop on ONE event loop.

The async front door put client serving on an event loop, but each
in-flight peer call still parked a thread inside the pooled
``http.client`` transport — a k+m shard fan-out on a 16-node cluster
cost a fleet of blocked threads exactly where the distributed layer
must scale. This module moves the CLIENT side of the RPC plane onto
asyncio:

- one process-wide daemon event-loop thread (``RPC_LOOP``) owns every
  outbound peer connection; sync call sites bridge onto it with
  ``run_coroutine_threadsafe`` and block on a future — the calling
  thread waits, but no NEW thread exists per in-flight call;
- ``call_async`` replicates ``RPCClient.call`` semantics exactly
  (offline gate + jittered reconnect probe, fault injection, deadline
  fast-fail/capping, self-tuning timeout bookkeeping, the single-shot
  stale-pool retry, control-plane overrides, trace-span grafting) so
  behaviour cannot drift between the fabrics;
- ``fanout``/``fanout_nowait`` run N-peer pushes as N coroutines on
  the one loop (``rpc/peer.py`` previously spawned a thread per peer);
- ``Pipeline`` issues HTTP/1.1 pipelined requests on one dedicated
  connection — ``RemoteStorage.create_file`` streams chunk frames
  without a per-chunk round-trip stall.

The legacy threaded transport stays fully functional behind
``MINIO_RPC_FABRIC=threaded`` (the paired-bench / escape-hatch knob,
mirroring ``MINIO_FRONT_DOOR``).

Thread-model invariant: the per-client async connection pool is only
ever touched FROM the RPC loop thread, so it needs no lock. Cross-
thread entry points (``bridge_call``, ``fanout``, ``Pipeline``,
``close_client``) submit coroutines; they never touch pool state
directly.

The port's own copy of ``minio_tpu/rpc/aio.py``, with no change in
behaviour.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time

from ..qos.deadline import (H_DEADLINE, DeadlineExceeded, current_deadline,
                            record_expiry)
from ..storage import errors as serr
from .transport import RPC_PREFIX, RPCClient, frame, sign, unframe, \
    wire_to_error

# Pooled keep-alive connections kept per peer (matches the sync pool).
POOL_SIZE = 8
# In-flight pipelined requests per Pipeline before send() blocks on
# the oldest response (bounds peer-side queueing and sender memory).
PIPELINE_WINDOW = 4


def fabric_async() -> bool:
    """Env knob: MINIO_RPC_FABRIC=threaded keeps the legacy pooled
    http.client transport (paired benches; emergency escape hatch)."""
    import os
    return os.environ.get("MINIO_RPC_FABRIC",
                          "async").strip().lower() != "threaded"


# ---------------------------------------------------------------------------
# The loop thread


class _LoopThread:
    """Lazily-started process-wide event loop on one daemon thread."""

    def __init__(self, name: str = "mtpu-rpc-loop"):
        self._name = name
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._mu = threading.Lock()

    def loop(self) -> asyncio.AbstractEventLoop:
        with self._mu:
            if (self._loop is None or self._loop.is_closed()
                    or self._thread is None or not self._thread.is_alive()):
                loop = asyncio.new_event_loop()
                # mtpu-lint: disable=R1 -- the loop thread itself, not request work; every coroutine scheduled onto it carries its deadline/span EXPLICITLY (contextvars don't cross run_coroutine_threadsafe)
                t = threading.Thread(target=loop.run_forever,
                                     name=self._name, daemon=True)
                t.start()
                self._loop, self._thread = loop, t
                # Health plane: the shared RPC loop carries EVERY peer
                # call — a blocked callback here stalls the whole
                # fabric, so it heartbeats under loopmon like the
                # front-door loops (best-effort: obs must never gate
                # the fabric).
                try:
                    from ..obs.loopmon import LOOPMON
                    LOOPMON.register("rpc", loop)
                except Exception:  # noqa: BLE001 - obs is optional here
                    pass
            return self._loop

    def submit(self, coro):
        """Schedule a coroutine; returns a concurrent.futures.Future.
        QoS context does NOT cross this hop — callers bake the deadline
        and span into the coroutine's arguments (see call_async)."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop())

    def run(self, coro):
        """Run a coroutine to completion from a sync thread."""
        if threading.current_thread() is self._thread:
            # A sync bridge FROM the loop thread would deadlock the
            # loop on its own future; nothing in-tree does this.
            coro.close()
            raise RuntimeError("sync RPC bridge called from the RPC "
                               "loop thread")
        # mtpu-lint: disable=R1 -- deadline/span ride inside the coroutine's own arguments; a contextvar copy would be ignored across the loop hop anyway
        return self.submit(coro).result()


RPC_LOOP = _LoopThread()


# ---------------------------------------------------------------------------
# In-flight census (satellite: the zero-thread claim must be measurable)


class _Census:
    """Counts in-flight peer RPCs across BOTH fabrics; publishes the
    ``minio_tpu_v2_rpc_inflight`` gauge on every transition (an RPC is
    a multi-ms wire round-trip — one gauge write is noise next to it)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._n = 0

    def enter(self) -> None:
        with self._mu:
            self._n += 1
            n = self._n
        self._publish(n)

    def exit(self) -> None:
        with self._mu:
            self._n -= 1
            n = self._n
        self._publish(n)

    def current(self) -> int:
        with self._mu:
            return self._n

    @staticmethod
    def _publish(n: int) -> None:
        from ..obs.metrics2 import METRICS2
        METRICS2.set_gauge("minio_tpu_v2_rpc_inflight", {}, n)


CENSUS = _Census()


def census() -> dict:
    """Timeline/top sample: in-flight internal RPCs vs process thread
    count — the pair that makes "zero threads per in-flight call" a
    measured number instead of a code-reading exercise."""
    return {"rpcInflight": CENSUS.current(),
            "threads": threading.active_count()}


# ---------------------------------------------------------------------------
# Per-client async connection pool (RPC-loop thread only — no lock)


class _AConn:
    __slots__ = ("reader", "writer", "gen")

    def __init__(self, reader, writer, gen):
        self.reader = reader
        self.writer = writer
        self.gen = gen


class _AioState:
    __slots__ = ("pool", "gen")

    def __init__(self):
        self.pool: list[_AConn] = []
        self.gen = 0


def _aio_state(client) -> _AioState:
    st = getattr(client, "_aio_state", None)
    if st is None:
        st = client._aio_state = _AioState()
    return st


def _kill(conn: _AConn) -> None:
    try:
        conn.writer.close()
    except OSError:
        pass


async def _open_aconn(client, timeout: float) -> _AConn:
    kw = {}
    if client.tls is not None:
        kw = {"ssl": client.tls, "server_hostname": client.host}
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(client.host, client.port, **kw), timeout)
    return _AConn(reader, writer, _aio_state(client).gen)


async def _get_aconn(client, timeout: float) -> tuple[_AConn, bool]:
    """(connection, reused) — same contract as the sync pool: callers
    retry once on a FRESH socket when a reused one fails before any
    response byte (a peer restart leaves pooled keep-alives stale)."""
    st = _aio_state(client)
    while st.pool:
        c = st.pool.pop()
        if c.gen == st.gen and not c.reader.at_eof():
            return c, True
        _kill(c)
    return await _open_aconn(client, timeout), False


async def _connect_mapped(client, eff_timeout: float, ddl, override,
                          service: str, method: str):
    """``_get_aconn`` with the threaded transport's failure mapping.

    The sync pool hands back an UNCONNECTED ``http.client`` object —
    the TCP connect happens lazily inside the request try-block, so
    its error mapping covers it for free.  ``asyncio.open_connection``
    connects eagerly, so a refused/timed-out connect here must get the
    identical treatment (offline mark, dyn-timeout tuning on genuine
    ceiling hits only, deadline attribution) or it leaks a raw
    ``OSError`` past the offline gate.
    """
    try:
        return await _get_aconn(client, eff_timeout)
    except (OSError, asyncio.TimeoutError) as e:
        if ddl is not None and ddl.expired():
            # The request DEADLINE elapsed, not the peer: say nothing
            # about peer health.
            record_expiry("rpc-client")
            raise DeadlineExceeded(
                f"{service}/{method} to {client.endpoint()}: deadline "
                f"expired mid-call: {e}")
        # Only genuine ceiling hits tune the timeout up — an instant
        # connection-refused says nothing about slowness.
        if not override and isinstance(e, (TimeoutError,
                                           asyncio.TimeoutError)):
            client.dyn_timeout.log_failure()
        if not override:
            client._mark_offline()
        raise serr.DiskNotFound(
            f"{client.endpoint()} unreachable: {e}")


def _put_aconn(client, conn: _AConn) -> None:
    st = _aio_state(client)
    if conn.gen == st.gen and len(st.pool) < POOL_SIZE:
        st.pool.append(conn)
        return
    _kill(conn)


def _drop_aio_pool(client) -> None:
    """Invalidate every pooled connection (stale after peer restart)."""
    st = _aio_state(client)
    st.gen += 1
    pool, st.pool = st.pool, []
    for c in pool:
        _kill(c)


def close_client(client) -> None:
    """Cross-thread pool teardown (RPCClient.close)."""
    if getattr(client, "_aio_state", None) is None:
        return
    loop = RPC_LOOP.loop()
    loop.call_soon_threadsafe(_drop_aio_pool, client)


# ---------------------------------------------------------------------------
# Wire helpers


def _request_bytes(client, service: str, method: str, args: dict,
                   payload: bytes, ddl, span) -> bytes:
    args_json = json.dumps(args, sort_keys=True)
    ts = str(int(time.time()))
    body = frame(args_json.encode(), payload)
    lines = [
        f"POST {RPC_PREFIX}/{service}/{method} HTTP/1.1",
        f"Host: {client.host}:{client.port}",
        f"x-mtpu-ts: {ts}",
        "x-mtpu-auth: " + sign(client.cluster_key,
                               f"{service}/{method}", ts, args_json,
                               payload),
        f"Content-Length: {len(body)}",
    ]
    if ddl is not None:
        lines.append(f"{H_DEADLINE}: {round(ddl.remaining_ms(), 3)}")
    if span is not None:
        lines.append(f"x-mtpu-trace: {span.trace_id}:{span.span_id}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


async def _read_response(reader, got_resp: list | None = None,
                         ) -> tuple[int, bytes, bool]:
    """Minimal HTTP/1.1 response read: (status, body, keep_alive).
    The peer's RPC responses always carry Content-Length."""
    line = await reader.readline()
    if not line:
        raise ConnectionResetError("peer closed connection before "
                                   "response")
    if got_resp is not None:
        got_resp[0] = True
    parts = line.split(None, 2)
    if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
        raise ValueError(f"bad rpc status line: {line[:80]!r}")
    status = int(parts[1])
    clen = 0
    keep = True
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise ConnectionResetError("peer closed connection "
                                       "mid-headers")
        k, _, v = h.partition(b":")
        k = k.strip().lower()
        v = v.strip()
        if k == b"content-length":
            clen = int(v)
        elif k == b"connection" and v.lower() == b"close":
            keep = False
    body = await reader.readexactly(clen) if clen else b""
    return status, body, keep


async def _roundtrip(conn: _AConn, req: bytes, got_resp: list,
                     ) -> tuple[int, bytes, bool]:
    conn.writer.write(req)
    await conn.writer.drain()
    return await _read_response(conn.reader, got_resp)


def _graft_spans(result, span) -> None:
    """Pop the peer's server-side span subtree out of the result and
    graft it under the caller's span (same prune bounds as the sync
    transport — peer-supplied subtrees are untrusted input)."""
    if not isinstance(result, dict):
        return
    remote_spans = result.pop("_trace_spans", None)
    if remote_spans and span is not None and isinstance(remote_spans,
                                                        list):
        from ..obs.span import sanitize_remote
        for s in remote_spans[:8]:
            sc = sanitize_remote(s)
            if sc is not None:
                span.add_child(sc)


# ---------------------------------------------------------------------------
# The async call — a faithful port of RPCClient.call


async def call_async(client, service: str, method: str, args: dict,
                     payload: bytes = b"",
                     timeout: float | None = None,
                     ddl=None, span=None) -> tuple[dict, bytes]:
    """Async twin of ``RPCClient.call`` with identical semantics.

    ``ddl``/``span`` are passed EXPLICITLY (captured at the sync
    boundary by ``bridge_call``): contextvars do not reliably cross
    ``run_coroutine_threadsafe``, and making the budget an argument
    keeps the coroutine honest about whose deadline it spends.
    """
    if not client.is_online():
        raise serr.DiskNotFound(f"{client.endpoint()} offline")
    from ..faultinject import FAULTS
    if FAULTS.enabled:
        _lat, _part = FAULTS.peer(client.endpoint())
        if _lat:
            await asyncio.sleep(_lat)
        if _part:
            client._mark_offline()
            raise serr.DiskNotFound(
                f"{client.endpoint()} unreachable: injected partition")
    eff_timeout = timeout if timeout is not None else client.timeout
    if ddl is not None:
        rem_s = ddl.remaining()
        if rem_s <= 0:
            record_expiry("rpc-client")
            raise DeadlineExceeded(
                f"{service}/{method} to {client.endpoint()}: request "
                "deadline exhausted before dispatch")
        base = timeout if timeout is not None else client.timeout
        eff_timeout = max(0.05, min(base, rem_s))
    override = timeout is not None
    req = _request_bytes(client, service, method, args, payload, ddl,
                         span)
    CENSUS.enter()
    try:
        conn, reused = await _connect_mapped(client, eff_timeout, ddl,
                                             override, service, method)
        # mtpu-lint: disable=R6 -- single-shot retry, not a loop: the continue requires reused=True and a fresh socket comes back reused=False, so it fires at most once; no backoff by design (a stale pool is instant-fail, the peer is healthy)
        while True:
            t0 = time.monotonic()
            logged = override
            got_resp = [False]
            try:
                status, rbody, keep = await asyncio.wait_for(
                    _roundtrip(conn, req, got_resp), eff_timeout)
                if not override:
                    client.dyn_timeout.log_success(
                        time.monotonic() - t0)
                logged = True
                if status != 200:
                    if keep:
                        _put_aconn(client, conn)
                    else:
                        _kill(conn)
                    raise wire_to_error(status, rbody)
                result_json, data = unframe(rbody)
                if keep:
                    _put_aconn(client, conn)
                else:
                    _kill(conn)
                result = json.loads(result_json or b"{}")
                _graft_spans(result, span)
                return result, data
            except (OSError, EOFError, ValueError,
                    asyncio.TimeoutError) as e:
                _kill(conn)
                if (reused and not got_resp[0] and isinstance(
                        e, (ConnectionResetError, BrokenPipeError,
                            asyncio.IncompleteReadError))):
                    # Stale pooled socket (peer restarted): the error
                    # arrived BEFORE any response byte, on a reused
                    # keep-alive — the signature of a dead pool, not a
                    # dead peer. Retry ONCE on a fresh socket; errors
                    # after a response began (or on a fresh socket)
                    # never retry, so an RPC the peer may have
                    # executed is never re-sent.
                    _drop_aio_pool(client)
                    conn, reused = await _connect_mapped(
                        client, eff_timeout, ddl, override, service,
                        method)
                    continue
                if ddl is not None and ddl.expired():
                    # The request DEADLINE elapsed, not the peer: say
                    # nothing about peer health.
                    record_expiry("rpc-client")
                    raise DeadlineExceeded(
                        f"{service}/{method} to {client.endpoint()}: "
                        f"deadline expired mid-call: {e}")
                if not logged and isinstance(e, (TimeoutError,
                                                 asyncio.TimeoutError)):
                    client.dyn_timeout.log_failure()
                if not override:
                    client._mark_offline()
                raise serr.DiskNotFound(
                    f"{client.endpoint()} unreachable: {e}")
    finally:
        CENSUS.exit()


def bridge_call(client, service: str, method: str, args: dict,
                payload: bytes = b"",
                timeout: float | None = None) -> tuple[dict, bytes]:
    """Sync bridge: capture the caller's deadline + trace span on the
    calling thread, run the coroutine on the RPC loop, block on its
    future. Every await inside ``call_async`` is bounded, so the
    future always resolves."""
    ddl = current_deadline()
    from ..obs.span import current_span
    span = current_span()
    return RPC_LOOP.run(call_async(client, service, method, args,
                                   payload, timeout=timeout, ddl=ddl,
                                   span=span))


# ---------------------------------------------------------------------------
# Peer fan-out (rpc/peer.py): N peers, N coroutines, zero threads


def _fabric_serves(peers: dict) -> bool:
    """The async fabric only speaks to real RPCClients — test doubles
    and in-process loopback clients keep the thread fan-out path."""
    return (fabric_async() and bool(peers)
            and all(isinstance(c, RPCClient) for c in peers.values()))


def fanout(peers: dict, method: str, args: dict,
           timeout: float | None = None) -> dict | None:
    """Parallel peer fan-out on the RPC loop; returns {key: result
    dict | Exception} like NotificationSys._fanout, or None when these
    peers aren't fabric-servable (caller falls back to threads)."""
    if not _fabric_serves(peers):
        return None
    ddl = current_deadline()
    from ..obs.span import current_span
    span = current_span()

    async def one(key: str, client) -> tuple:
        try:
            res, _ = await call_async(client, "peer", method, args,
                                      timeout=timeout, ddl=ddl,
                                      span=span)
            return key, res
        except Exception as exc:  # noqa: BLE001 - per-peer failure
            return key, exc

    async def gather() -> dict:
        pairs = await asyncio.gather(
            *(one(k, c) for k, c in peers.items()))
        return dict(pairs)

    return RPC_LOOP.run(gather())


async def _swallow(coro) -> None:
    try:
        await coro
    except Exception:  # noqa: BLE001 - fire-and-forget push
        pass


def fanout_nowait(peers: dict, method: str, args: dict) -> bool:
    """Fire-and-forget fan-out: schedule one coroutine per peer and
    return immediately. Deliberately deadline-free and span-free — the
    push must OUTLIVE the mutating request that triggered it (same
    contract as the old daemon-thread _fanout_async). Returns False
    when these peers need the thread fallback."""
    if not _fabric_serves(peers):
        return False
    for key, client in peers.items():
        # mtpu-lint: disable=R1 -- fire-and-forget: deadline-FREE and span-free BY CONTRACT (the push must outlive the mutating request), so there is no context to carry
        RPC_LOOP.submit(_swallow(call_async(client, "peer", method,
                                            args, ddl=None,
                                            span=None)))
    return True


# ---------------------------------------------------------------------------
# HTTP/1.1 pipelining (RemoteStorage.create_file streamed writes)


class _PipeState:
    """Loop-side state of one pipelined connection. Writes stay
    ordered because each exchange coroutine writes in its FIRST slice
    (tasks start in submission order) and responses are read in the
    same order under a FIFO asyncio.Lock."""
    __slots__ = ("conn", "rlock", "broken")

    def __init__(self, conn: _AConn):
        self.conn = conn
        self.rlock = asyncio.Lock()
        self.broken: BaseException | None = None


async def _pipe_open(client, timeout: float) -> _PipeState:
    # Always a FRESH connection: a pipeline's burst of writes on a
    # stale pooled socket could not be safely retried (requests past
    # the first may have executed), so don't start on one.
    return _PipeState(await _open_aconn(client, timeout))


async def _pipe_exchange(client, st: _PipeState, req: bytes,
                         eff_timeout: float) -> tuple[dict, bytes]:
    if st.broken is not None:
        raise serr.DiskNotFound(
            f"{client.endpoint()} unreachable: pipeline broken: "
            f"{st.broken}")
    CENSUS.enter()
    try:
        try:
            st.conn.writer.write(req)
            async with st.rlock:
                await st.conn.writer.drain()
                status, rbody, _keep = await asyncio.wait_for(
                    _read_response(st.conn.reader), eff_timeout)
        except (OSError, EOFError, ValueError,
                asyncio.TimeoutError) as e:
            st.broken = e
            _kill(st.conn)
            client._mark_offline()
            raise serr.DiskNotFound(
                f"{client.endpoint()} unreachable: {e}")
        if status != 200:
            raise wire_to_error(status, rbody)
        result_json, data = unframe(rbody)
        return json.loads(result_json or b"{}"), data
    finally:
        CENSUS.exit()


async def _pipe_close(client, st: _PipeState, healthy: bool) -> None:
    if healthy and st.broken is None:
        _put_aconn(client, st.conn)
    else:
        _kill(st.conn)


class Pipeline:
    """Sync handle for pipelined RPCs to ONE peer over one dedicated
    connection: up to PIPELINE_WINDOW requests ride the wire before
    the sender blocks on the oldest response, so a streamed
    create_file overlaps chunk N's upload with chunk N-1..N-3's disk
    writes instead of stalling a full RTT per chunk.

    Pipelined calls never tune the dynamic timeout (a multi-chunk
    stream's per-response time measures queueing, not peer RTT) but DO
    mark the peer offline on connection-level failures — they are the
    data plane."""

    def __init__(self, client, timeout: float | None = None):
        self.client = client
        self._ddl = current_deadline()
        self._base = timeout if timeout is not None else client.timeout
        self._pending: list = []
        if not client.is_online():
            raise serr.DiskNotFound(f"{client.endpoint()} offline")
        from ..faultinject import FAULTS
        if FAULTS.enabled:
            _lat, _part = FAULTS.peer(client.endpoint())
            if _lat:
                time.sleep(_lat)
            if _part:
                client._mark_offline()
                raise serr.DiskNotFound(
                    f"{client.endpoint()} unreachable: injected "
                    "partition")
        try:
            self._st = RPC_LOOP.run(_pipe_open(client,
                                               self._eff_timeout()))
        except (OSError, asyncio.TimeoutError) as e:
            client._mark_offline()
            raise serr.DiskNotFound(
                f"{client.endpoint()} unreachable: {e}")

    def _eff_timeout(self) -> float:
        if self._ddl is not None:
            return max(0.05, min(self._base, self._ddl.remaining()))
        return self._base

    def send(self, service: str, method: str, args: dict,
             payload: bytes = b"") -> None:
        """Queue one call; blocks only when the window is full (on the
        OLDEST in-flight response, raising its mapped error)."""
        if self._ddl is not None:
            self._ddl.check(f"rpc.pipeline.{service}/{method}")
        req = _request_bytes(self.client, service, method, args,
                             payload, self._ddl, None)
        while len(self._pending) >= PIPELINE_WINDOW:
            self._pending.pop(0).result()
        # mtpu-lint: disable=R1 -- the deadline is baked into the request frame and _eff_timeout; the exchange coroutine carries no ambient context
        self._pending.append(RPC_LOOP.submit(_pipe_exchange(
            self.client, self._st, req, self._eff_timeout())))

    def finish(self) -> None:
        """Wait for every outstanding response (raising the first
        error), then return the connection to the peer's pool."""
        try:
            while self._pending:
                self._pending.pop(0).result()
        except BaseException:
            self.abort()
            raise
        # mtpu-lint: disable=R1 -- connection return/teardown, no request context exists to carry
        RPC_LOOP.submit(_pipe_close(self.client, self._st, True))

    def abort(self) -> None:
        """Drain outstanding responses (errors swallowed — the caller
        already has its exception) and close the connection: requests
        past a failure must not be re-interleaved onto a pooled
        socket."""
        while self._pending:
            f = self._pending.pop(0)
            try:
                f.result()
            except Exception:  # noqa: BLE001 - already failing
                pass
        # mtpu-lint: disable=R1 -- connection teardown, no request context exists to carry
        RPC_LOOP.submit(_pipe_close(self.client, self._st, False))
