"""Span-based request tracing: one tree per request, keyed by the
request id the S3 front end already mints (x-amz-request-id).

The reference traces per-handler wall time only (httpTrace,
cmd/handler-utils.go:349); measurement-first EC papers (arXiv:1709.05365,
arXiv:1504.07038) show per-phase, per-node attribution is what turns EC
tuning into engineering — so every layer here opens child spans: the S3
handler (root), erasure engine phases, TPU kernel invocations, and each
per-disk storage call (local and RPC). The trace id crosses the peer RPC
boundary in a header (rpc/transport.py) and server-side spans come back
in the response, so a distributed PUT stitches into ONE tree.

Cost discipline (acceptance: <= 5% on the bench PUT path):
- no active trace -> ``TRACER.span()`` returns a shared no-op context
  manager after one contextvar read;
- spans are plain objects, two perf_counter() calls each;
- children per span are capped (dropped tail is counted, never grown);
- completed traces land in a bounded ring, oldest evicted.

The port's own copy of ``minio_tpu/obs/span.py``, with no change in
behaviour.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "minio_tpu_span", default=None)

# Per-span child cap: a streamed multi-GiB PUT must not grow its trace
# without bound — the tail is dropped and counted in `dropped`.
MAX_CHILDREN = 64

# Per-span event cap (QoS shed/deadline markers): same bounding rule.
MAX_EVENTS = 16


class _Noop:
    """Shared do-nothing span context (the untraced fast path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One timed operation in a trace tree.

    Also a context manager: entering makes it the thread's current span
    (children attach via the contextvar), exiting records the duration
    and restores the previous current span.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "duration_ms", "tags", "children", "events", "dropped",
                 "_t0", "_token", "_tracer", "_done")

    _seq = 0
    _seq_mu = threading.Lock()

    def __init__(self, name: str, trace_id: str, parent_id: str = "",
                 tags: dict | None = None, tracer: "Tracer | None" = None):
        with Span._seq_mu:
            Span._seq += 1
            seq = Span._seq
        self.span_id = f"{seq:x}"
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.start = time.time()
        self.duration_ms = 0.0
        self.tags = tags or {}
        self.children: list = []  # Span | dict (grafted remote spans)
        self.events: list = []    # point-in-time markers (QoS shed, ...)
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._token = None
        self._tracer = tracer
        self._done = False

    # -- tree assembly -------------------------------------------------

    def add_child(self, child) -> None:
        """Attach a Span or an already-serialized span dict (remote).
        list.append is GIL-atomic, safe from parallel_map workers; the
        length check here is advisory under concurrency (two workers
        may both pass it) — to_dict() enforces the cap exactly."""
        if len(self.children) >= MAX_CHILDREN:
            self.dropped += 1
            return
        self.children.append(child)

    def add_event(self, name: str, **attrs) -> None:
        """Record a point-in-time marker on this span (admission shed,
        deadline expiry). Bounded like children; append is GIL-atomic."""
        if len(self.events) >= MAX_EVENTS:
            self.dropped += 1
            return
        ev = {"name": name, "time": time.time()}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def to_dict(self) -> dict:
        d = {
            "traceId": self.trace_id, "spanId": self.span_id,
            "parentId": self.parent_id, "name": self.name,
            "start": self.start,
            "durationMs": round(self.duration_ms, 3),
        }
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.events:
            d["events"] = [dict(e) for e in self.events[:MAX_EVENTS]]
        kids = self.children
        dropped = self.dropped
        if len(kids) > MAX_CHILDREN:  # racy appends past the cap
            dropped += len(kids) - MAX_CHILDREN
            kids = kids[:MAX_CHILDREN]
        if kids:
            d["children"] = [c if isinstance(c, dict) else c.to_dict()
                             for c in kids]
        if dropped:
            d["droppedChildren"] = dropped
        return d

    # -- context management --------------------------------------------

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.finish()
        return False

    def detach_context(self) -> None:
        """Reset the contextvar token WITHOUT finishing the span — for
        handoff points where the entering thread returns to a pool
        while the span stays open (the async front door's streaming
        responses: the drain task carries the span in a copied context
        and calls finish() later, from a context where resetting the
        original token would be illegal)."""
        if self._token is not None:
            _current.reset(self._token)
            self._token = None

    def finish(self) -> dict | None:
        """Close the span; for a ROOT span returns the completed trace
        tree (and lands it in the tracer's ring)."""
        if self._done:
            return None
        self._done = True
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3
        if not self.parent_id and self._tracer is not None:
            return self._tracer._complete(self)
        return None


class Tracer:
    """Process-wide span factory + bounded ring of completed traces."""

    RING_SIZE = 256

    def __init__(self):
        self.enabled = os.environ.get("MINIO_TPU_TRACE", "on") != "off"
        self._ring: deque = deque(maxlen=self.RING_SIZE)
        self._mu = threading.Lock()

    # -- span creation -------------------------------------------------

    @staticmethod
    def current() -> Span | None:
        return _current.get()

    def begin(self, name: str, trace_id: str, **tags) -> Span | None:
        """Open a ROOT span (no context entered yet; pair with
        Span.__enter__/finish). None when tracing is disabled."""
        if not self.enabled:
            return None
        return Span(name, trace_id, tags=tags or None, tracer=self)

    def span(self, name: str, parent: Span | None = None, **tags):
        """Child span context manager. Attaches to `parent` when given
        (cross-thread: parallel_map workers), else to the thread's
        current span; a shared no-op when neither exists."""
        if parent is None:
            parent = _current.get()
            if parent is None:
                return _NOOP
        child = Span(name, parent.trace_id, parent.span_id,
                     tags=tags or None)
        parent.add_child(child)
        return child

    # -- completed traces ----------------------------------------------

    def _complete(self, root: Span) -> dict:
        tree = root.to_dict()
        with self._mu:
            self._ring.append(tree)
        from .metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_traces_completed_total")
        return tree

    def recent(self, n: int = 32) -> list[dict]:
        with self._mu:
            items = list(self._ring)
        return items[-n:]

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()


# Bounds for span trees GRAFTED from peer RPC responses: a remote
# subtree bypasses the local add_child cap (dicts pass through
# to_dict verbatim), and the RPC response body is not covered by the
# request HMAC — so prune depth/fan-out/node count at ingestion.
MAX_REMOTE_DEPTH = 8
MAX_REMOTE_NODES = 256

_SPAN_KEYS = ("traceId", "spanId", "parentId", "name", "start",
              "durationMs", "tags", "droppedChildren")


def sanitize_remote(node, _depth: int = 0,
                    _budget: list | None = None) -> dict | None:
    """Prune an untrusted remote span dict to the same bounds local
    trees obey; None when it isn't a dict or the node budget is spent."""
    if not isinstance(node, dict):
        return None
    if _budget is None:
        _budget = [MAX_REMOTE_NODES]
    if _budget[0] <= 0:
        return None
    _budget[0] -= 1
    out = {k: node[k] for k in _SPAN_KEYS if k in node}
    if isinstance(out.get("name"), str):
        out["name"] = out["name"][:128]
    tags = out.get("tags")
    if isinstance(tags, dict):
        out["tags"] = {
            str(k)[:64]: (v if isinstance(v, (int, float, bool))
                          else str(v)[:256])
            for k, v in list(tags.items())[:16]}
    elif "tags" in out:
        del out["tags"]
    events = node.get("events")
    if isinstance(events, list):
        kept_ev = []
        for e in events[:MAX_EVENTS]:
            if isinstance(e, dict):
                kept_ev.append({
                    str(k)[:64]: (v if isinstance(v, (int, float, bool))
                                  else str(v)[:256])
                    for k, v in list(e.items())[:8]})
        if kept_ev:
            out["events"] = kept_ev
    kids = node.get("children")
    if isinstance(kids, list) and _depth < MAX_REMOTE_DEPTH:
        kept = []
        for c in kids[:MAX_CHILDREN]:
            sc = sanitize_remote(c, _depth + 1, _budget)
            if sc is not None:
                kept.append(sc)
        if kept:
            out["children"] = kept
        if len(kids) > MAX_CHILDREN:
            out["droppedChildren"] = (out.get("droppedChildren", 0)
                                      + len(kids) - MAX_CHILDREN)
    return out


# The process-wide tracer every layer shares.
TRACER = Tracer()


def current_span() -> Span | None:
    return _current.get()
