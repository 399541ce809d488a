"""Internal RPC transport: authenticated POST with length-prefixed JSON +
binary framing, pooled keep-alive connections, and health-gated clients
with reconnect (ref cmd/rest/client.go:62,193 MarkOffline +
HealthCheckFn).

Wire format per call (everything in the BODY — headers stay tiny):
    POST /minio-tpu/rpc/v1/<service>/<method>
    x-mtpu-auth: hex hmac-sha256(cluster_key,
                   service/method + "\\n" + ts + "\\n" + args_json
                   + "\\n" + sha256(payload))
    x-mtpu-ts:   unix seconds (rejected outside +/- 5 min skew window;
                 bounds replay — cluster ports are expected to run on a
                 trusted network like the reference's)
    body: [4B big-endian args_len][args_json][payload]
Response 200: [4B result_len][result_json][body]; errors are 4xx/5xx with
a JSON {error_type, message} mapped back to storage errors.

The port's own copy of ``minio_tpu/rpc/transport.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import json
import random
import struct
import socket
import threading
import time

from ..qos.deadline import (H_DEADLINE, Deadline, DeadlineExceeded,
                            current_deadline, deadline_scope,
                            record_expiry)
from ..storage import errors as serr

RPC_PREFIX = "/minio-tpu/rpc/v1"
MAX_SKEW = 300  # seconds

_ERR_TYPES = {
    "DiskNotFound": serr.DiskNotFound,
    "FaultyDisk": serr.FaultyDisk,
    "VolumeNotFound": serr.VolumeNotFound,
    "VolumeExists": serr.VolumeExists,
    "FileNotFound": serr.FileNotFound,
    "VersionNotFound": serr.VersionNotFound,
    "FileCorrupt": serr.FileCorrupt,
    "DiskFull": serr.DiskFull,
    "DeadlineExceeded": DeadlineExceeded,
}


def sign(cluster_key: bytes, method: str, ts: str, args_json: str,
         payload: bytes) -> str:
    msg = "\n".join([method, ts, args_json,
                     hashlib.sha256(payload).hexdigest()])
    return hmac.new(cluster_key, msg.encode(), hashlib.sha256).hexdigest()


def frame(args_json: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(args_json)) + args_json + payload


def unframe(body: bytes) -> tuple[bytes, bytes]:
    if len(body) < 4:
        raise ValueError("short rpc frame")
    n = struct.unpack(">I", body[:4])[0]
    if len(body) < 4 + n:
        raise ValueError("truncated rpc frame")
    return body[4:4 + n], body[4 + n:]


def error_to_wire(e: BaseException) -> tuple[int, bytes]:
    name = type(e).__name__
    if isinstance(e, (serr.FileNotFound, serr.VolumeNotFound,
                      serr.VersionNotFound)):
        status = 404
    elif isinstance(e, DeadlineExceeded):
        status = 503  # retryable: the CALLER's budget ran out
    else:
        status = 500
    return status, json.dumps({"error_type": name,
                               "message": str(e)}).encode()


def wire_to_error(status: int, body: bytes) -> Exception:
    try:
        doc = json.loads(body)
        cls = _ERR_TYPES.get(doc.get("error_type"), serr.FaultyDisk)
        return cls(doc.get("message", f"rpc status {status}"))
    except (ValueError, KeyError):
        return serr.FaultyDisk(f"rpc status {status}: {body[:200]!r}")


class RPCClient:
    """Health-gated RPC caller to one peer, with a pooled keep-alive
    connection."""

    # Seconds a peer stays marked offline before a reconnect probe.
    # Live-reloadable via config-KV `rpc offline_retry=` (the server's
    # apply hook rewrites the CLASS attribute, so every client in the
    # process follows without reconstruction).
    OFFLINE_RETRY = 2.0
    # Reconnect-probe jitter: each offline window is stretched by a
    # random factor in [1, 1 + OFFLINE_JITTER] so a restarted peer
    # sees the cluster's reconnect probes SPREAD over the window
    # instead of a thundering herd at the exact same instant (every
    # node marked it offline within the same failed fan-out).
    OFFLINE_JITTER = 0.5

    def __init__(self, host: str, port: int, cluster_key: bytes,
                 timeout: float = 30.0, tls=None):
        """tls: ssl.SSLContext for https:// cluster endpoints (see
        utils.certs.client_context_from_env); the HMAC signing below
        authenticates every call either way — TLS adds transport
        privacy (ref the reference's TLS-everywhere internode with
        JWT auth on top)."""
        from ..utils.dyntimeout import DynamicTimeout
        self.host = host
        self.port = port
        self.cluster_key = cluster_key
        self.tls = tls
        # Self-tuning timeout: slow peers stretch it, fast ones shrink
        # it back (ref cmd/dynamic-timeouts.go:35). The floor is 2.5s,
        # not the reference's 1s: a peer served by the event-loop
        # front door answers through loop→worker→loop hops whose tail
        # under CPU contention is scheduling-bound, and a spurious
        # sub-second timeout here MARKS THE PEER OFFLINE — one blip
        # then degrades every write to that node for OFFLINE_RETRY,
        # which is how a momentarily-busy box turns into MRF backlog.
        self.dyn_timeout = DynamicTimeout(timeout, minimum=2.5)
        self._offline_until = 0.0
        self._mu = threading.Lock()
        self._pool: list[http.client.HTTPConnection] = []

    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def is_online(self) -> bool:
        return time.monotonic() >= self._offline_until

    def _mark_offline(self) -> None:
        window = self.OFFLINE_RETRY * (
            1.0 + self.OFFLINE_JITTER * random.random())
        with self._mu:
            self._offline_until = time.monotonic() + window

    @property
    def timeout(self) -> float:
        return self.dyn_timeout.timeout

    def _get_conn(self, t: float | None = None,
                  ) -> tuple[http.client.HTTPConnection, bool]:
        """(connection, reused): callers retry once on a FRESH socket
        when a pooled one fails — a peer restart leaves every pooled
        keep-alive connection stale, and treating that as peer death
        knocks a healthy node out for OFFLINE_RETRY."""
        if t is None:
            t = self.timeout
        with self._mu:
            if self._pool:
                conn = self._pool.pop()
                conn.timeout = t  # used on (re)connect
                if conn.sock is not None:
                    conn.sock.settimeout(t)
                return conn, True
        return self._new_conn(t), False

    def _new_conn(self, t: float) -> http.client.HTTPConnection:
        if self.tls is not None:
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=t, context=self.tls)
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=t)

    def _drop_pool(self) -> None:
        """Close every pooled connection (stale after a peer restart)."""
        with self._mu:
            pool, self._pool = self._pool, []
        for c in pool:
            c.close()

    def _put_conn(self, conn: http.client.HTTPConnection) -> None:
        with self._mu:
            if len(self._pool) < 8:
                self._pool.append(conn)
                return
        conn.close()

    def call(self, service: str, method: str, args: dict,
             payload: bytes = b"",
             timeout: float | None = None) -> tuple[dict, bytes]:
        """Returns (result_json, body_bytes); raises storage errors.

        `timeout` overrides the self-tuning data-plane timeout for
        calls that legitimately block server-side (e.g. a 3-30s trace
        long-poll) — such calls neither tune the dynamic timeout nor
        mark the peer offline on expiry, so a slow control-plane poll
        can never knock a healthy peer out of the data plane.

        By default the call runs on the async fabric (rpc/aio.py): the
        coroutine twin of the body below executes on the process-wide
        RPC event loop and this thread blocks on its future — same
        semantics, zero extra threads per in-flight call.
        MINIO_RPC_FABRIC=threaded keeps the pooled http.client path."""
        from . import aio
        if aio.fabric_async():
            return aio.bridge_call(self, service, method, args, payload,
                                   timeout)
        return self._call_threaded(service, method, args, payload,
                                   timeout)

    def _call_threaded(self, service: str, method: str, args: dict,
                       payload: bytes = b"",
                       timeout: float | None = None) -> tuple[dict, bytes]:
        """Legacy thread-blocking transport (MINIO_RPC_FABRIC=threaded
        and the paired fabric bench): one pooled http.client
        connection, this thread parked on the socket."""
        if not self.is_online():
            raise serr.DiskNotFound(f"{self.endpoint()} offline")
        # Per-peer wire faults (minio_tpu/faultinject): an injected
        # partition behaves exactly like an unreachable peer — the
        # health gate closes and reconnect probes (with jitter) take
        # over; slow-wire adds latency ahead of the socket I/O.
        from ..faultinject import FAULTS
        if FAULTS.enabled:
            _lat, _part = FAULTS.peer(self.endpoint())
            if _lat:
                time.sleep(_lat)
            if _part:
                self._mark_offline()
                raise serr.DiskNotFound(
                    f"{self.endpoint()} unreachable: injected "
                    "partition")
        # Deadline propagation (qos/deadline.py): a request whose
        # budget is already spent must not burn peer capacity — fail
        # here. Otherwise forward the REMAINING budget so the peer can
        # refuse expired work, and cap the socket timeout to it so a
        # slow peer call cancels when the deadline expires instead of
        # holding the handler for the full transport timeout.
        ddl = current_deadline()
        eff_timeout = timeout
        if ddl is not None:
            rem_s = ddl.remaining()
            if rem_s <= 0:
                record_expiry("rpc-client")
                raise DeadlineExceeded(
                    f"{service}/{method} to {self.endpoint()}: request "
                    "deadline exhausted before dispatch")
            base = timeout if timeout is not None else self.timeout
            eff_timeout = max(0.05, min(base, rem_s))
        args_json = json.dumps(args, sort_keys=True)
        ts = str(int(time.time()))
        body = frame(args_json.encode(), payload)
        headers = {
            "x-mtpu-ts": ts,
            "x-mtpu-auth": sign(self.cluster_key, f"{service}/{method}",
                                ts, args_json, payload),
            "Content-Length": str(len(body)),
        }
        if ddl is not None:
            headers[H_DEADLINE] = str(round(ddl.remaining_ms(), 3))
        # Distributed tracing: the caller's trace context rides a tiny
        # header; the peer opens a server-side span under it and ships
        # its subtree back in the reserved _trace_spans result key, so
        # a cross-node request stitches into ONE tree (the reference
        # has no cross-node stitching — its admin trace merges flat
        # per-node entries).
        from ..obs.span import current_span
        _cur = current_span()
        if _cur is not None:
            headers["x-mtpu-trace"] = f"{_cur.trace_id}:{_cur.span_id}"
        override = timeout is not None
        from .aio import CENSUS
        CENSUS.enter()
        try:
            conn, reused = self._get_conn(eff_timeout)
            # mtpu-lint: disable=R6 -- single-shot retry, not a loop: the continue requires reused=True and a fresh socket comes back reused=False, so it fires at most once; no backoff by design (a stale pool is instant-fail, the peer is healthy)
            while True:
                t0 = time.monotonic()
                logged = override
                resp = None
                try:
                    conn.request("POST",
                                 f"{RPC_PREFIX}/{service}/{method}",
                                 body=body, headers=headers)
                    resp = conn.getresponse()
                    rbody = resp.read()
                    if not override:
                        self.dyn_timeout.log_success(
                            time.monotonic() - t0)
                    logged = True
                    if resp.status != 200:
                        self._put_conn(conn)
                        raise wire_to_error(resp.status, rbody)
                    result_json, data = unframe(rbody)
                    self._put_conn(conn)
                    result = json.loads(result_json or b"{}")
                    if isinstance(result, dict):
                        remote_spans = result.pop("_trace_spans", None)
                        if remote_spans and _cur is not None and \
                                isinstance(remote_spans, list):
                            # Peer-supplied subtrees are untrusted
                            # input: prune to the local depth/fan-out/
                            # size bounds before they enter the trace
                            # ring.
                            from ..obs.span import sanitize_remote
                            for s in remote_spans[:8]:
                                sc = sanitize_remote(s)
                                if sc is not None:
                                    _cur.add_child(sc)
                    return result, data
                except (OSError, http.client.HTTPException,
                        ValueError) as e:
                    conn.close()
                    if (reused and resp is None and isinstance(
                            e, (http.client.RemoteDisconnected,
                                ConnectionResetError,
                                BrokenPipeError))):
                        # A stale pooled socket (peer restarted): the
                        # error arrived BEFORE any response started, on
                        # a reused keep-alive connection — the
                        # signature of a dead pool, not a dead peer.
                        # Retry ONCE on a fresh socket; errors after a
                        # response began (or any error on a fresh
                        # socket) never retry, so an RPC the peer may
                        # have executed is never re-sent.
                        self._drop_pool()
                        conn, reused = self._get_conn(eff_timeout)
                        continue
                    if ddl is not None and ddl.expired():
                        # The request DEADLINE elapsed, not the peer:
                        # the socket timeout above was deadline-capped,
                        # so say nothing about peer health — no offline
                        # mark, no dynamic-timeout tuning.
                        record_expiry("rpc-client")
                        raise DeadlineExceeded(
                            f"{service}/{method} to {self.endpoint()}: "
                            f"deadline expired mid-call: {e}")
                    # Only genuine ceiling hits tune the timeout up —
                    # an instant connection-refused says nothing about
                    # slowness.
                    if not logged and isinstance(e, (TimeoutError,
                                                     socket.timeout)):
                        self.dyn_timeout.log_failure()
                    if not override:
                        self._mark_offline()
                    raise serr.DiskNotFound(
                        f"{self.endpoint()} unreachable: {e}")
        finally:
            CENSUS.exit()

    def close(self) -> None:
        with self._mu:
            for c in self._pool:
                c.close()
            self._pool.clear()
        from . import aio
        aio.close_client(self)


class RPCRegistry:
    """Server side: named services exposing methods.

    A service is an object; exposed methods take (args: dict,
    payload: bytes) and return (result: dict, body: bytes).
    """

    def __init__(self, cluster_key: bytes):
        self.cluster_key = cluster_key
        self._services: dict[str, object] = {}

    def register(self, name: str, service: object) -> None:
        self._services[name] = service

    def handle(self, path: str, headers: dict[str, str],
               body: bytes) -> tuple[int, dict[str, str], bytes]:
        """Dispatch an RPC HTTP request; returns (status, headers, body)."""
        if not path.startswith(RPC_PREFIX + "/"):
            return 404, {}, b"not found"
        rest = path[len(RPC_PREFIX) + 1:]
        if "/" not in rest:
            return 404, {}, b"bad rpc path"
        service_name, method = rest.split("/", 1)
        try:
            args_bytes, payload = unframe(body)
        except ValueError:
            return 400, {}, b"bad rpc frame"
        ts = headers.get("x-mtpu-ts", "")
        try:
            if abs(time.time() - int(ts)) > MAX_SKEW:
                return 403, {}, b"rpc timestamp out of window"
        except ValueError:
            return 403, {}, b"bad rpc timestamp"
        args_json = args_bytes.decode("utf-8", "replace")
        want = sign(self.cluster_key, f"{service_name}/{method}", ts,
                    args_json, payload)
        if not hmac.compare_digest(want,
                                   headers.get("x-mtpu-auth", "")):
            return 403, {}, b"bad rpc signature"
        service = self._services.get(service_name)
        fn = getattr(service, f"rpc_{method}", None) if service else None
        if fn is None:
            return 404, {}, f"no method {service_name}/{method}".encode()
        try:
            args = json.loads(args_json)
            from ..obs.metrics2 import METRICS2
            METRICS2.inc("minio_tpu_v2_rpc_requests_total",
                         {"service": service_name, "method": method})
            # Remaining-budget propagation: refuse work whose caller
            # can no longer use the answer, and re-open the budget so
            # anything this handler calls in turn (disk I/O, nested
            # RPC) keeps decrementing the SAME deadline.
            ddl = None
            ddl_hdr = headers.get(H_DEADLINE, "")
            if ddl_hdr:
                try:
                    rem_ms = float(ddl_hdr)
                except ValueError:
                    rem_ms = None
                if rem_ms is not None:
                    if rem_ms <= 0:
                        record_expiry("rpc-server")
                        raise DeadlineExceeded(
                            f"{service_name}/{method}: caller deadline "
                            "already expired")
                    ddl = Deadline.from_remaining_ms(rem_ms)
            srv_span = None
            trace_hdr = headers.get("x-mtpu-trace", "")
            if trace_hdr and ":" in trace_hdr:
                # Server-side span under the caller's context; its
                # subtree (including local disk-op children) returns in
                # the reserved result key and grafts onto the caller's
                # tree (RPCClient.call pops it).
                from ..obs.span import Span
                tid, _, pid = trace_hdr.partition(":")
                srv_span = Span(f"rpc.server.{service_name}.{method}",
                                tid[:64], pid[:32])
            with deadline_scope(ddl):
                if srv_span is not None:
                    with srv_span:
                        result, rbody = fn(args, payload)
                    if isinstance(result, dict):
                        result = dict(result)
                        result["_trace_spans"] = [srv_span.to_dict()]
                else:
                    result, rbody = fn(args, payload)
            out = frame(json.dumps(result).encode(), rbody)
            return 200, {}, out
        except BaseException as e:  # noqa: BLE001 — serialized to peer
            status, ebody = error_to_wire(e)
            return status, {}, ebody
