"""Event-loop health plane: per-loop lag telemetry, a stall flight
recorder, and an always-on continuous profiler.

The process is event-loop-centric — one RPC loop carries every
peer call (rpc/aio.py) and N front-door loops carry every connection
(s3/asyncserver.py) — so a single blocked callback is a cluster-wide
stall, yet the only defense was the STATIC lint rule R8 ("no blocking
calls in async bodies").  This module is R8's runtime twin (the repo
pattern set by locktrace for the lock rules):

- **Heartbeat** (``LoopMonitor.register``): every event loop runs a
  10Hz heartbeat coroutine measuring scheduling lag — expected vs
  actual wake of ``asyncio.sleep`` — into an EWMA + rolling-window
  p99 and the ``minio_tpu_v2_loop_lag_ms{loop}`` histogram, plus a
  per-loop census (pending tasks, ready callbacks, open transports).
  The timeline samples the census per tick (``loopLag``/``loopTasks``
  rows) and ``tools/mtpu_top.py`` renders a ``loops:`` row.

- **Stall flight recorder**: a watcher thread notices a heartbeat
  overdue by more than ``obs.loop_stall_ms`` (config-KV, default
  250ms) and snapshots the loop thread's stack via
  ``sys._current_frames()`` into a bounded ring — one capture per
  stall episode, taken WHILE the loop is blocked, so the top frame is
  the blamed code.  Each capture emits a cause-carrying console line
  and a ``loop.stall`` span event; the watchdog built-in rule
  ``loop_stall`` (obs/watchdog.py) fires on recent captures with the
  usual pending/resolve hysteresis and freezes the ring into the
  incident bundle (obs/incidents.py ``loops`` section).

- **Continuous profiler**: the SamplingProfiler's frame walk
  (utils/profiler.py ``sample_stacks``) run at ~1% duty cycle
  (one all-thread sample per 100ms) forever, aggregated into
  per-minute self-time + folded-stack profiles served at admin
  ``/profile`` — so a stall incident links lag -> blamed frame ->
  where the process actually spends time, without anyone having
  started a profiling session first.  Config-KV
  ``obs.profile_continuous`` (default on) toggles it live.

Testability rides the fault plane: ``faultinject`` grows a
``loop_block`` rule kind whose latency the heartbeat schedules as a
REAL blocking ``time.sleep`` callback onto its own loop
(``_injected_loop_block`` below), so the detect -> blame -> fire ->
resolve chain is provable end-to-end against a live server.

The port's own copy of ``minio_tpu/obs/loopmon.py``, with no change in
behaviour but one: servers ``hold`` the plane and ``release`` it at
stop, and the last release stops the watcher and profiler threads, which
the reference keeps for the process lifetime.
"""

from __future__ import annotations

import asyncio
import atexit
import sys
import threading
import time
from collections import Counter, deque

HEARTBEAT_S = 0.1          # 10Hz: lag resolution vs overhead balance
EWMA_ALPHA = 0.2
LAG_WINDOW = 300           # rolling p99 window (~30s at 10Hz)
STALL_RING = 32            # stall captures kept (newest wins)
STALL_STACK_DEPTH = 48     # frames kept per capture
WATCH_PERIOD_S = 0.05      # watcher poll; bounds blame latency
# How long a stall capture keeps the watchdog rule breaching: long
# enough to cross pending_ticks hysteresis on 1s sampler ticks even
# for a ONE-SHOT 400ms block, short enough to resolve promptly.
RECENT_STALL_S = 10.0


def _injected_loop_block(seconds: float) -> None:
    """Deliberate loop blocker (faultinject ``loop_block``): scheduled
    via ``call_soon`` so it runs ON the monitored loop — the stall
    recorder must catch exactly this frame."""
    time.sleep(seconds)  # mtpu-lint: disable=R11 -- faultinject loop_block: blocking ON the loop is this function's entire purpose (the stall recorder must blame this frame)


class _LoopState:
    __slots__ = ("name", "loop", "thread_ident", "active", "task",
                 "beats", "last_beat", "last_ms", "ewma_ms", "lags",
                 "pending", "ready", "transports", "stalls",
                 "stalled_at")

    def __init__(self, name: str, loop):
        self.name = name
        self.loop = loop
        self.thread_ident: int | None = None  # learned on first beat
        self.active = True
        self.task = None
        self.beats = 0
        self.last_beat = 0.0      # monotonic of the latest beat
        self.last_ms = 0.0
        self.ewma_ms = 0.0
        self.lags: deque = deque(maxlen=LAG_WINDOW)
        self.pending = 0          # tasks on the loop
        self.ready = 0            # ready callbacks queued
        self.transports = 0       # selector-registered fds
        self.stalls = 0
        self.stalled_at = 0.0     # monotonic; nonzero = episode open


class ContinuousProfiler:
    """Low-duty-cycle whole-process sampler: ONE ``sample_stacks``
    walk per ``PERIOD_S`` (~1% duty at typical stack depths),
    aggregated into per-minute profiles — self-time by frame plus
    folded stacks ("f1;f2;f3 N", the flamegraph input format)."""

    PERIOD_S = 0.1
    MINUTES_KEPT = 15

    def __init__(self):
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Closed per-minute profiles, oldest first; the open minute
        # rides separately so report() always has fresh data.
        self._minutes: deque = deque(maxlen=self.MINUTES_KEPT)
        self._cur: dict | None = None
        self.samples_total = 0

    @property
    def running(self) -> bool:
        return self._thread is not None

    def start(self) -> None:
        with self._mu:
            if self._thread is not None:
                return
            self._stop.clear()
            # mtpu-lint: disable=R1 -- always-on profiling daemon observes ALL threads for the process lifetime
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="loopmon-profiler")
            self._thread.start()

    def stop(self) -> None:
        with self._mu:
            t = self._thread
            self._thread = None
        if t is not None:
            self._stop.set()
            t.join(timeout=2)

    def _run(self) -> None:
        from ..utils.profiler import sample_stacks
        me = frozenset((threading.get_ident(),))
        while not self._stop.wait(self.PERIOD_S):
            stacks = sample_stacks(skip=me)
            now = time.time()
            with self._mu:
                cur = self._cur
                if cur is None or now - cur["start"] >= 60.0:
                    if cur is not None and cur["samples"]:
                        self._minutes.append(cur)
                    cur = self._cur = {"start": now, "samples": 0,
                                       "leaf": Counter(),
                                       "folded": Counter()}
                cur["samples"] += 1
                self.samples_total += 1
                for stack in stacks:
                    if not stack:
                        continue
                    cur["leaf"][stack[0]] += 1
                    # Folded key is root-first (flamegraph order),
                    # bounded so one recursive stack can't bloat it.
                    cur["folded"][tuple(
                        reversed(stack[:STALL_STACK_DEPTH]))] += 1
            from .metrics2 import METRICS2
            METRICS2.inc("minio_tpu_v2_profile_samples_total", {},
                         len(stacks))

    def _merged(self, minutes: int) -> tuple[Counter, Counter, int]:
        with self._mu:
            closed = list(self._minutes)[-max(0, minutes - 1):] \
                if minutes > 1 else []
            if self._cur is not None:
                closed = closed + [self._cur]
            leaf: Counter = Counter()
            folded: Counter = Counter()
            samples = 0
            for m in closed:
                leaf.update(m["leaf"])
                folded.update(m["folded"])
                samples += m["samples"]
            return leaf, folded, samples

    def report(self, top: int = 50, minutes: int = 5) -> dict:
        """Top-N self-time rows + folded-stack text over the last
        ``minutes`` (open minute included) — the admin ``/profile``
        payload."""
        from ..utils.profiler import frame_label
        leaf, folded, samples = self._merged(minutes)
        total = max(1, samples)
        rows = [{"function": frame_label(key), "samples": n,
                 "pct": round(100.0 * n / total, 1)}
                for key, n in leaf.most_common(top)]
        folded_lines = [
            ";".join(f"{name} {file.rsplit('/', 1)[-1]}:{line}"
                     for file, line, name in stack) + f" {n}"
            for stack, n in folded.most_common(1000)]
        return {"running": self.running, "samples": samples,
                "minutes": minutes,
                "periodMs": self.PERIOD_S * 1000.0,
                "self": rows, "folded": folded_lines}


class LoopMonitor:
    """Process-wide registry of monitored event loops (singleton
    ``LOOPMON``); owns the heartbeats, the stall watcher thread and
    the continuous profiler."""

    def __init__(self):
        self._mu = threading.Lock()
        self._loops: dict[str, _LoopState] = {}
        self.enabled = True
        self.stall_ms = 250.0
        self.profiler = ContinuousProfiler()
        self._watcher: threading.Thread | None = None
        self._watch_stop = threading.Event()
        self._holders = 0
        # Stall flight-recorder ring: newest-last capture dicts.
        self._stall_ring: deque = deque(maxlen=STALL_RING)
        # Process-lifetime loops (the RPC loop) never unregister on
        # their own; cancel their heartbeats before the interpreter
        # tears daemon threads down or every exit prints "Task was
        # destroyed but it is pending!".
        atexit.register(self._shutdown)

    def _shutdown(self) -> None:
        for name in list(self._loops):
            self.unregister(name, wait_s=0.2)
        self._watch_stop.set()
        self.profiler.stop()

    def hold(self) -> None:
        """A server that is up holds the plane (``S3Server.start``)."""
        with self._mu:
            self._holders += 1

    def release(self) -> None:
        """``S3Server.stop``: when the last holder releases and no loop
        is left registered, the watcher and the profiler stop, so a
        stopped server leaves no loopmon thread behind (the next
        ``register`` or ``configure`` starts them again)."""
        with self._mu:
            self._holders = max(0, self._holders - 1)
        self._wind_down()

    def _wind_down(self) -> None:
        """Stop the watcher and the profiler when no server holds the
        plane and no loop is registered (``release``, ``unregister``)."""
        with self._mu:
            if self._holders or self._loops:
                return
            watcher, stop = self._watcher, self._watch_stop
            self._watcher, self._watch_stop = None, threading.Event()
        if watcher is not None:
            stop.set()
            watcher.join(timeout=2)
        self.profiler.stop()

    # -- configuration (config-KV ``obs`` apply hook) -------------------

    def configure(self, stall_ms: float | None = None,
                  profile_continuous: bool | None = None) -> None:
        if stall_ms is not None:
            if stall_ms <= 0:
                raise ValueError("loop_stall_ms must be positive")
            self.stall_ms = float(stall_ms)
        if profile_continuous is not None:
            if profile_continuous:
                self.profiler.start()
            else:
                self.profiler.stop()

    def set_enabled(self, flag: bool) -> None:
        """Pause/resume the whole plane (paired-overhead benches):
        heartbeats keep ticking but record nothing, the watcher skips,
        and the profiler stops."""
        self.enabled = bool(flag)
        if not flag:
            self.profiler.stop()

    # -- loop registration ----------------------------------------------

    def register(self, name: str, loop) -> None:
        """Idempotent: arm a heartbeat on ``loop`` under ``name``.
        Safe from any thread (the heartbeat task is created on the
        loop itself via call_soon_threadsafe)."""
        if loop is None:
            return
        with self._mu:
            old = self._loops.get(name)
            if old is not None and old.loop is loop and old.active:
                return
            st = _LoopState(name, loop)
            self._loops[name] = st
            self._ensure_watcher()
        if old is not None:
            # Name collision (e.g. two in-process test servers both
            # calling their first loop "s3-0"): latest wins, but the
            # displaced heartbeat must die or it leaks as a
            # destroyed-pending task when ITS loop stops.
            self._cancel_heartbeat(old, wait_s=0.0)

        def _arm() -> None:
            if st.active:
                st.task = loop.create_task(self._heartbeat(st))
        try:
            loop.call_soon_threadsafe(_arm)
        except RuntimeError:
            # Loop already closed between register and arm: forget it.
            with self._mu:
                if self._loops.get(name) is st:
                    del self._loops[name]

    def unregister(self, name: str, wait_s: float = 0.5) -> None:
        """Disarm ``name``'s heartbeat; the last loop out with no server
        holding the plane winds the watcher and the profiler down."""
        with self._mu:
            st = self._loops.pop(name, None)
        if st is not None:
            self._cancel_heartbeat(st, wait_s)
            self._wind_down()

    @staticmethod
    def _cancel_heartbeat(st: _LoopState, wait_s: float) -> None:
        st.active = False
        task = st.task
        if task is None:
            return
        done = threading.Event()

        def _cancel() -> None:
            task.cancel()
            # cancel() schedules the task's final step; a chained
            # call_soon lands AFTER it, so done means DONE — callers
            # about to stop the loop won't destroy a pending task.
            st.loop.call_soon(done.set)
        try:
            st.loop.call_soon_threadsafe(_cancel)
        except RuntimeError:
            return  # loop already closed; task died with it
        if wait_s > 0 and threading.get_ident() != st.thread_ident:
            done.wait(wait_s)

    def _ensure_watcher(self) -> None:
        # Caller holds self._mu.
        if self._watcher is not None:
            return
        # mtpu-lint: disable=R1 -- stall watcher daemon observes every registered loop for the process lifetime
        self._watcher = threading.Thread(
            target=self._watch, args=(self._watch_stop,), daemon=True,
            name="loopmon-watcher")
        self._watcher.start()

    # -- heartbeat (runs ON the monitored loop) -------------------------

    async def _heartbeat(self, st: _LoopState) -> None:
        st.thread_ident = threading.get_ident()
        # Arm counts as a beat: a block landing BEFORE the first real
        # beat (boot-time CPU storms delay it by seconds) must still
        # be capturable, not skipped as "never alive".
        st.last_beat = time.monotonic()
        try:
            while st.active:
                before = time.monotonic()
                await asyncio.sleep(HEARTBEAT_S)
                if not self.enabled:
                    st.last_beat = time.monotonic()
                    continue
                # Fault plane: a `loop_block` rule for this loop turns
                # into a REAL blocking callback on this very loop —
                # scheduled, not inlined, so the stall capture blames
                # _injected_loop_block, not the heartbeat.
                try:
                    from ..faultinject import FAULTS
                    blk = FAULTS.loop_block(st.name)
                except Exception:  # noqa: BLE001 - fault plane optional
                    blk = 0.0
                if blk > 0:
                    st.loop.call_soon(_injected_loop_block, blk)
                now = time.monotonic()
                lag_ms = max(0.0, (now - before - HEARTBEAT_S) * 1e3)
                self._record(st, lag_ms, now)
        except asyncio.CancelledError:
            pass

    def _record(self, st: _LoopState, lag_ms: float,
                now_mono: float) -> None:
        st.last_beat = now_mono
        st.beats += 1
        st.last_ms = lag_ms
        st.ewma_ms = lag_ms if st.beats == 1 else (
            EWMA_ALPHA * lag_ms + (1.0 - EWMA_ALPHA) * st.ewma_ms)
        st.lags.append(lag_ms)
        if st.stalled_at:
            st.stalled_at = 0.0  # episode over; next one recaptures
        # Census from INSIDE the loop (all_tasks is loop-thread-only
        # reliable; _ready/_selector are CPython internals, guarded).
        try:
            st.pending = len(asyncio.all_tasks(st.loop))
        except RuntimeError:
            pass
        q = getattr(st.loop, "_ready", None)
        if q is not None:
            st.ready = len(q)
        sel = getattr(st.loop, "_selector", None)
        if sel is not None:
            try:
                st.transports = len(sel.get_map())
            except (RuntimeError, AttributeError):
                pass
        from .metrics2 import METRICS2
        METRICS2.observe("minio_tpu_v2_loop_lag_ms",
                         {"loop": st.name}, lag_ms)
        # Gauges refresh at 1Hz, not per beat — they are levels.
        if st.beats % 10 == 1:
            METRICS2.set_gauge("minio_tpu_v2_loop_lag_ewma_ms",
                               {"loop": st.name},
                               round(st.ewma_ms, 3))
            METRICS2.set_gauge("minio_tpu_v2_loop_tasks",
                               {"loop": st.name}, st.pending)

    # -- stall watcher (its own thread) ---------------------------------

    def _watch(self, stop: threading.Event) -> None:
        while not stop.wait(WATCH_PERIOD_S):
            if not self.enabled:
                continue
            stall_s = self.stall_ms / 1e3
            now = time.monotonic()
            with self._mu:
                states = list(self._loops.values())
            frames = None
            for st in states:
                if (not st.active or st.thread_ident is None
                        or not st.last_beat or st.stalled_at):
                    continue
                overdue = now - st.last_beat - HEARTBEAT_S
                if overdue < stall_s:
                    continue
                st.stalled_at = now
                st.stalls += 1
                if frames is None:  # one frame walk per poll
                    frames = sys._current_frames()
                self._capture(st, overdue * 1e3,
                              frames.get(st.thread_ident))

    def _capture(self, st: _LoopState, overdue_ms: float,
                 frame) -> None:
        from ..logger import Logger
        from ..utils.profiler import frame_label
        from .metrics2 import METRICS2
        from .span import current_span
        stack: list[str] = []
        while frame is not None and len(stack) < STALL_STACK_DEPTH:
            code = frame.f_code
            stack.append(frame_label((code.co_filename,
                                      code.co_firstlineno,
                                      code.co_name)))
            frame = frame.f_back
        # Blame the first frame that is CODE, not our own
        # instrumentation: under MTPU_LOCKTRACE time.sleep itself is a
        # Python wrapper (locktrace._traced_sleep) and would otherwise
        # eat the headline that should name the caller.
        top = stack[0] if stack else "<no python frame>"
        for label in stack:
            if "locktrace.py" not in label:
                top = label
                break
        entry = {"loop": st.name, "overdueMs": round(overdue_ms, 1),
                 "at": time.time(), "topFrame": top, "stack": stack}
        with self._mu:
            self._stall_ring.append(entry)
        METRICS2.inc("minio_tpu_v2_loop_stalls_total",
                     {"loop": st.name})
        Logger.get().warn(
            f"loopmon: loop {st.name} stalled {overdue_ms:.0f}ms "
            f"in {top}", "loopmon", loop=st.name, frame=top)
        span = current_span()
        if span is not None:
            span.add_event("loop.stall", loop=st.name, frame=top,
                           overdue_ms=round(overdue_ms, 1))

    # -- reads ----------------------------------------------------------

    def lag_census(self) -> dict[str, float]:
        """{loop: EWMA lag ms} — the timeline's ``loopLag`` sample."""
        with self._mu:
            return {name: round(st.ewma_ms, 3)
                    for name, st in self._loops.items() if st.beats}

    def task_census(self) -> dict[str, int]:
        """{loop: pending tasks} — the timeline's ``loopTasks``."""
        with self._mu:
            return {name: st.pending
                    for name, st in self._loops.items() if st.beats}

    def recent_stalls(self, now: float | None = None,
                      window_s: float = RECENT_STALL_S) -> list[dict]:
        """Stall captures younger than ``window_s`` — the watchdog
        ``loop_stall`` rule's breach input (``now`` is wall-clock; the
        engine passes its tick time so tests stay deterministic)."""
        now = time.time() if now is None else now
        with self._mu:
            # Bounded BOTH ways: a capture "in the future" relative to
            # ``now`` (tests tick the watchdog at synthetic times while
            # real wall-clock captures sit in the ring) must not count
            # as recent, or one genuine stall poisons every
            # synthetic-time tick afterwards.
            return [dict(e) for e in self._stall_ring
                    if 0.0 <= now - e["at"] <= window_s]

    def snapshot(self) -> dict:
        """Full census + stall ring — the incident bundle's ``loops``
        section and the loopmon part of admin ``/profile``."""
        with self._mu:
            loops = []
            for name, st in sorted(self._loops.items()):
                lags = sorted(st.lags)
                p99 = lags[int(len(lags) * 0.99)] if lags else 0.0
                loops.append({
                    "loop": name, "beats": st.beats,
                    "lagMs": round(st.last_ms, 3),
                    "ewmaMs": round(st.ewma_ms, 3),
                    "p99Ms": round(p99, 3),
                    "pendingTasks": st.pending,
                    "readyCallbacks": st.ready,
                    "transports": st.transports,
                    "stalls": st.stalls,
                    "stalled": bool(st.stalled_at)})
            return {"enabled": self.enabled,
                    "stallMs": self.stall_ms,
                    "profilerRunning": self.profiler.running,
                    "loops": loops,
                    "stalls": [dict(e) for e in self._stall_ring]}


LOOPMON = LoopMonitor()
