"""Admission control: per-API-class concurrency caps with bounded FIFO
wait queues (ref the maxClients middleware + `MINIO_API_REQUESTS_MAX` /
`MINIO_API_REQUESTS_DEADLINE`, cmd/generic-handlers.go — extended with
per-class read/write/list/admin caps so one flooded class cannot starve
the others).

Semantics:
- a GLOBAL cap (`api.requests_max`) bounds total in-flight S3 work;
- per-class caps (`api.requests_max_<class>`) bound each class;
- 0 anywhere = unlimited (in-flight is still tracked for metrics and
  for the scheduler's foreground-busy probe);
- over-cap requests wait FIFO up to the request's remaining deadline
  budget, then shed with 503 SlowDown + Retry-After;
- the wait queue itself is bounded (QUEUE_FACTOR x cap): when it is
  full the request sheds immediately — queueing unboundedly under
  overload is the exact failure admission control exists to prevent.

All caps reconfigure live through the config-KV apply hook
(S3Server._apply_config); waiters re-evaluate on every change.

The port's own copy of ``minio_tpu/qos/admission.py``, with no change in
behaviour.
"""

from __future__ import annotations

import collections
import threading
import time

from .deadline import Deadline

API_CLASSES = ("read", "write", "list", "admin", "select")

# Bounded wait queue: at most this many waiters per enforced cap slot.
QUEUE_FACTOR = 4

# Retry-After ceiling (seconds) — clients should back off for about the
# wait budget they'd otherwise have burned, never for minutes.
MAX_RETRY_AFTER = 120


class AdmissionShed(Exception):
    """Request refused by admission control (maps to 503 SlowDown)."""

    def __init__(self, api_class: str, reason: str, retry_after: int):
        super().__init__(f"admission shed ({api_class}): {reason}")
        self.api_class = api_class
        self.reason = reason
        self.retry_after = retry_after


def classify(method: str, bucket: str, key: str,
             params=()) -> str:
    """Map a request shape to its admission class (the coarse read /
    write / list / admin / select split the caps are keyed by).
    SelectObjectContent gets its OWN class: an analytics sweep is
    CPU/kernel-bound scan work, and a dedicated cap
    (`api.requests_max_select`) lets an operator brown it out without
    touching PUT/GET capacity."""
    if key and method == "POST" and "select" in params:
        return "select"
    if key:
        return "read" if method in ("GET", "HEAD") else "write"
    if bucket:
        return "list" if method in ("GET", "HEAD") else "write"
    return "list" if method in ("GET", "HEAD") else "admin"


class _Gate:
    """One FIFO-fair concurrency gate. limit <= 0 admits everything but
    still tracks in-flight."""

    def __init__(self, name: str):
        self.name = name
        self._cv = threading.Condition(threading.Lock())
        self.limit = 0
        self.inflight = 0
        self._queue: collections.deque = collections.deque()

    def set_limit(self, limit: int) -> None:
        with self._cv:
            self.limit = max(0, int(limit))
            self._cv.notify_all()  # a raised cap admits waiters now

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def acquire(self, deadline: Deadline | None) -> None:
        """Admit, or wait FIFO until admitted / the deadline expires /
        the queue is full. Raises AdmissionShed (reason tagged)."""
        me = object()
        with self._cv:
            if self.limit <= 0 or (self.inflight < self.limit
                                   and not self._queue):
                self.inflight += 1
                return
            if len(self._queue) >= self.limit * QUEUE_FACTOR:
                raise AdmissionShed(self.name, "queue-full",
                                    _retry_after(deadline))
            self._queue.append(me)
            try:
                while True:
                    if self.limit <= 0 or (self.inflight < self.limit
                                           and self._queue[0] is me):
                        self._queue.remove(me)
                        self.inflight += 1
                        # Wake the next waiter: one event can admit
                        # MANY (a live cap raise) — without this only
                        # the head would notice until the next release.
                        self._cv.notify_all()
                        return
                    wait = deadline.remaining() if deadline else None
                    if wait is not None and wait <= 0:
                        self._queue.remove(me)
                        self._cv.notify_all()
                        raise AdmissionShed(self.name, "wait-deadline",
                                            _retry_after(deadline))
                    self._cv.wait(wait)
            except AdmissionShed:
                raise
            except BaseException:
                try:
                    self._queue.remove(me)
                except ValueError:
                    pass
                self._cv.notify_all()
                raise

    def release(self) -> None:
        with self._cv:
            self.inflight = max(0, self.inflight - 1)
            self._cv.notify_all()


def _retry_after(deadline: Deadline | None) -> int:
    budget = deadline.budget_s if deadline is not None else 1.0
    return max(1, min(MAX_RETRY_AFTER, int(round(budget))))


class AdmissionController:
    """The server-wide gate set: one global + one per API class."""

    def __init__(self):
        self._global = _Gate("global")
        self._classes = {c: _Gate(c) for c in API_CLASSES}
        self.deadline_s = 10.0  # api.requests_deadline (wait + request)
        # monotonic() of the last foreground release: closed-loop
        # clients leave instantaneous in-flight gaps between requests;
        # the scheduler's throttle probe treats "active within a small
        # window" as busy so sweeps don't slip into those gaps.
        self._last_fg_release = 0.0

    # -- live (re)configuration ---------------------------------------

    def configure(self, requests_max: int, per_class: dict[str, int],
                  deadline_s: float) -> None:
        """Apply config-KV values; waiters react immediately."""
        self._global.set_limit(requests_max)
        for c, gate in self._classes.items():
            gate.set_limit(per_class.get(c, 0))
        self.deadline_s = max(0.0, deadline_s)

    def limit_for(self, api_class: str) -> int:
        return self._classes[api_class].limit

    @property
    def engaged(self) -> bool:
        """True when any cap is configured. The request-EXECUTION
        deadline budget only bites on an engaged (operator-configured)
        system: with no caps, requests_deadline keeps its reference
        semantics (a wait budget that never applies) and long requests
        run uncapped exactly as before — a default-config server must
        not start quorum-committing partial writes under load just
        because a 10s default exists."""
        return (self._global.limit > 0
                or any(g.limit > 0 for g in self._classes.values()))

    def foreground_inflight(self) -> int:
        """Client-facing in-flight work (read/write/list) — the
        scheduler's foreground-busy probe; admin traffic is not
        latency-sensitive foreground load, and neither are `select`
        scans — their kernel dispatches run BACKGROUND-lane and must
        not count themselves as the foreground they defer to."""
        return sum(self._classes[c].inflight
                   for c in ("read", "write", "list"))

    def foreground_active(self, window_s: float = 0.0) -> bool:
        """In-flight now, or released within the last `window_s` (the
        sticky probe the sweep throttle uses)."""
        if self.foreground_inflight() > 0:
            return True
        return (window_s > 0
                and time.monotonic() - self._last_fg_release < window_s)

    # -- admission -----------------------------------------------------

    def acquire(self, api_class: str,
                deadline: Deadline | None = None) -> "_Admitted":
        """Context manager guarding one request; raises AdmissionShed
        with Retry-After when over cap past the wait budget."""
        gate = self._classes[api_class]
        t0 = time.perf_counter()
        try:
            # CLASS gate first: a request queued behind its class cap
            # must not sit on a global slot meanwhile — that would let
            # one flooded class eat global capacity with requests that
            # are not even running, starving the other classes.
            gate.acquire(deadline)
            try:
                self._global.acquire(deadline)
            except BaseException:
                gate.release()
                raise
        except AdmissionShed as shed:
            self._record_shed(api_class, shed.reason)
            raise
        finally:
            self._observe(api_class, gate,
                          (time.perf_counter() - t0) * 1e3)
        return _Admitted(self, api_class)

    def _release(self, api_class: str) -> None:
        self._classes[api_class].release()
        self._global.release()
        if api_class in ("read", "write", "list"):
            self._last_fg_release = time.monotonic()
        self._observe(api_class, self._classes[api_class], None)

    # -- accounting ----------------------------------------------------

    def _observe(self, api_class: str, gate: _Gate,
                 wait_ms: float | None) -> None:
        from ..obs.metrics2 import METRICS2
        labels = {"class": api_class}
        METRICS2.set_gauge("minio_tpu_v2_qos_admission_inflight",
                           labels, gate.inflight)
        METRICS2.set_gauge("minio_tpu_v2_qos_admission_queue_depth",
                           labels, gate.queue_depth())
        if wait_ms is not None:
            METRICS2.observe("minio_tpu_v2_qos_admission_wait_ms",
                             labels, wait_ms)

    def _record_shed(self, api_class: str, reason: str) -> None:
        from ..obs.metrics2 import METRICS2
        from ..obs.span import current_span
        METRICS2.inc("minio_tpu_v2_qos_shed_total",
                     {"class": api_class, "reason": reason})
        span = current_span()
        if span is not None:
            span.add_event("qos.shed", api_class=api_class,
                           reason=reason)


class _Admitted:
    """Held admission slot; releases on context exit (idempotent —
    streaming responses release from the request-finish path, which
    also runs as a safety net)."""

    __slots__ = ("_ctrl", "_api_class", "_released")

    def __init__(self, ctrl: AdmissionController, api_class: str):
        self._ctrl = ctrl
        self._api_class = api_class
        self._released = False

    def __enter__(self) -> "_Admitted":
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ctrl._release(self._api_class)
