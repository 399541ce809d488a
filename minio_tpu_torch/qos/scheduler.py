"""Two-priority dispatch lanes for the batching layer.

Background kernel work (heal re-encode, crawler/scanner verify sweeps)
competes with foreground PUT/GET encode for the same coalescing window
and device queue — the foreground/background interference online-EC
studies flag as the dominant tail-latency source (arXiv:1709.05365;
RapidRAID pipelines repair off the critical path, arXiv:1207.6744).

The lane rides a contextvar: heal/crawler call sites wrap their work in
``background_lane()`` and every dispatch in ops/batching.py consults
``GATE.dispatch(current_lane())``. Background dispatches defer while
foreground work is busy — busy meaning a foreground dispatch is in
flight OR the admission controller reports client requests in flight —
re-checking each ``DEFER_SLICE_S``; after ``MAX_DEFERRALS`` slices the
dispatch PROMOTES and proceeds anyway (aging: deferred, never starved).

The port's own copy of ``minio_tpu/qos/scheduler.py``, with no change in
behaviour.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import weakref

FOREGROUND = "fg"
BACKGROUND = "bg"

_lane: contextvars.ContextVar[str] = contextvars.ContextVar(
    "minio_tpu_qos_lane", default=FOREGROUND)


def current_lane() -> str:
    return _lane.get()


@contextlib.contextmanager
def background_lane():
    """Tag everything in this scope (heal sweep, crawler cycle) as
    background for dispatch priority."""
    token = _lane.set(BACKGROUND)
    try:
        yield
    finally:
        _lane.reset(token)


@contextlib.contextmanager
def lane_scope(lane: str):
    """Re-enter a captured lane on another thread (the quorum pool's
    cross-thread QoS-context hand-off, parallel/quorum.py)."""
    token = _lane.set(lane)
    try:
        yield
    finally:
        _lane.reset(token)


class PriorityGate:
    """Foreground-first dispatch gate with background aging."""

    # One deferral slice ~= a few coalescing windows; MAX_DEFERRALS
    # slices bound background added latency to ~tens of ms per dispatch.
    DEFER_SLICE_S = 0.01
    MAX_DEFERRALS = 4

    # Loop pacing (throttle_background): a background sweep yields
    # between WORK ITEMS while foreground is busy — the dominant
    # interference is the sweep's I/O+hash work, not its kernel
    # dispatches (ref waitForLowHTTPReq + dynamicSleeper,
    # cmd/data-crawler.go: the reference sleeps background ops
    # proportionally to their own cost while client requests are in
    # flight). The wait is THROTTLE_FACTOR x the caller's last item
    # cost (duty cycle ~1/(1+factor) under constant load), capped at
    # THROTTLE_MAX_WAIT_S — the aging bound that keeps one item
    # flowing even under permanent foreground pressure.
    THROTTLE_SLICE_S = 0.02
    THROTTLE_MAX_WAIT_S = 1.0
    THROTTLE_FACTOR = 10.0
    THROTTLE_DEFAULT_COST_S = 0.05
    # Sticky window for the THROTTLE probe only: closed-loop clients
    # leave sub-ms in-flight gaps between requests; "released within
    # this window" still counts as busy so sweeps don't slip through.
    FG_RECENT_S = 0.25

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._fg_inflight = 0
        # Admission controllers (weakly held — test suites create many
        # short-lived servers): their foreground in-flight counts also
        # mean "busy", so host-only deployments (no shared device
        # queue) still keep heal out of the serving path's way.
        self._controllers: list = []

    def register(self, controller) -> None:
        """Weakly register an AdmissionController as a busy source."""
        with self._cv:
            self._controllers.append(weakref.ref(controller))

    def _fg_busy(self, recent_window_s: float = 0.0) -> bool:
        """Foreground dispatch in flight, or client requests in flight
        on any registered admission controller (optionally sticky:
        active within `recent_window_s`)."""
        if self._fg_inflight > 0:
            return True
        dead = False
        for ref in self._controllers:
            ctrl = ref()
            if ctrl is None:
                dead = True
                continue
            try:
                if ctrl.foreground_active(recent_window_s):
                    return True
            except Exception:
                continue
        if dead:
            self._controllers = [r for r in self._controllers
                                 if r() is not None]
        return False

    @contextlib.contextmanager
    def dispatch(self, lane: str):
        """Scope one batching dispatch. Foreground registers busy;
        background defers while foreground is busy, promoting after
        MAX_DEFERRALS slices."""
        from ..obs.metrics2 import METRICS2
        if lane != BACKGROUND:
            with self._cv:
                self._fg_inflight += 1
            METRICS2.inc("minio_tpu_v2_qos_dispatch_total",
                         {"lane": FOREGROUND})
            try:
                yield
            finally:
                with self._cv:
                    self._fg_inflight -= 1
                    self._cv.notify_all()
            return
        deferrals = 0
        with self._cv:
            while self._fg_busy() and deferrals < self.MAX_DEFERRALS:
                deferrals += 1
                METRICS2.inc("minio_tpu_v2_qos_bg_deferrals_total")
                self._cv.wait(self.DEFER_SLICE_S)
            promoted = self._fg_busy()
        if promoted:
            METRICS2.inc("minio_tpu_v2_qos_bg_promotions_total")
        METRICS2.inc("minio_tpu_v2_qos_dispatch_total",
                     {"lane": BACKGROUND})
        yield

    def throttle_background(self, cost_s: float | None = None) -> float:
        """Pace a background LOOP: called between per-object heal /
        crawl steps, sleeps in slices while foreground is busy, for up
        to THROTTLE_FACTOR x `cost_s` (the last item's own duration),
        aging-capped at THROTTLE_MAX_WAIT_S. Returns seconds waited.
        No-op outside the background lane or with foreground idle
        (cheap enough to call unconditionally)."""
        if _lane.get() != BACKGROUND:
            return 0.0
        if cost_s is None:
            cost_s = self.THROTTLE_DEFAULT_COST_S
        bound = min(self.THROTTLE_MAX_WAIT_S,
                    self.THROTTLE_FACTOR * max(cost_s, 0.0))
        from ..obs.metrics2 import METRICS2
        waited = 0.0
        with self._cv:
            if not self._fg_busy(self.FG_RECENT_S):
                return 0.0
            while self._fg_busy(self.FG_RECENT_S) and waited < bound:
                METRICS2.inc("minio_tpu_v2_qos_bg_deferrals_total")
                t0 = time.monotonic()
                self._cv.wait(self.THROTTLE_SLICE_S)
                waited += time.monotonic() - t0
            promoted = self._fg_busy(self.FG_RECENT_S)
        if promoted:
            METRICS2.inc("minio_tpu_v2_qos_bg_promotions_total")
        return waited


# Process-wide gate shared by every batching dispatch.
GATE = PriorityGate()
