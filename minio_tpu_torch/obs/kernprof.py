"""Kernel-dispatch profiling + per-backend dispatch health.

Port of minio_tpu/obs/kernprof.py. This module is the dispatch-path
brain-scan:

- **Per-dispatch profiles**: every ``KernelStats.record`` feeds a
  latency histogram keyed (kernel, backend, batch-size bucket) plus a
  per-backend byte counter, and hands the sample to the codec autotuner
  (ops/autotune.py), which refines its throughput model from it.

- **A dispatch health state machine per backend** -- ``device`` (the
  CUDA card: kernels K1, K2, X2), ``native`` (the C++ host kernels,
  minio_tpu_torch/native), ``torch-cpu`` (the kernels' plain PyTorch
  versions on the CPU, in place of the reference's ``xla-cpu``) and
  ``host`` (pure numpy/python) -- each tracked UP -> DEGRADED -> DOWN
  from REAL dispatch outcomes plus a cheap probe.  Every transition
  emits a console line with its cause, a ``kernel.backend`` span event
  on the active trace, and the ``minio_tpu_v2_kernel_backend_state``
  gauge.  A DOWN backend is skipped by dispatch policy (``allow()``) and
  re-probed on an interval -- except the card: its failures reach the
  callers (ops/batching.py), so it is never planned away to the host.

- **Coalescer queue-wait vs execute split**: ops/batching.py's
  EncodeCoalescer reports how long each request waited in the window
  (``record_queue_wait``) separately from the execute wall the dispatch
  histogram carries.

Each dispatch is also the worst-dispatch exemplar candidate of the
current timeline window (``TIMELINE.note_kernel``, obs/timeline.py), as
in the reference.
"""

from __future__ import annotations

import threading
import time

# Dispatch backends, most- to least-preferred. "device" is the CUDA card
# (the hand-written kernels); "native" the C++ host kernels
# (minio_tpu_torch/native); "torch-cpu" the kernels' plain PyTorch
# versions on the CPU (what the device lane is when the dispatch device
# is the CPU); "host" the pure numpy/python floor that can never go away.
DEVICE = "device"
NATIVE = "native"
TORCH_CPU = "torch-cpu"
HOST = "host"
BACKENDS = (DEVICE, NATIVE, TORCH_CPU, HOST)

UP, DEGRADED, DOWN = "up", "degraded", "down"
_STATE_VALUE = {UP: 0, DEGRADED: 1, DOWN: 2}

# Batch-occupancy buckets for the dispatch histogram label: block
# counts collapse to few series, not one per batch size.
_BATCH_BUCKETS = ((1, "1"), (4, "2-4"), (16, "5-16"), (64, "17-64"))


def batch_bucket(blocks: int) -> str:
    for ub, name in _BATCH_BUCKETS:
        if blocks <= ub:
            return name
    return "65+"


class _Backend:
    __slots__ = ("name", "state", "fail_streak", "ok_streak",
                 "dispatches", "bytes", "failures", "last_error",
                 "changed_at", "last_probe")

    def __init__(self, name: str):
        self.name = name
        self.state = UP  # optimistic until an outcome/probe says else
        self.fail_streak = 0
        self.ok_streak = 0
        self.dispatches = 0
        self.bytes = 0
        self.failures = 0
        self.last_error = ""
        self.changed_at = 0.0
        self.last_probe = 0.0


class KernelProfiler:
    """Process-wide dispatch profiler + backend health (``KERNPROF``)."""

    # First failure degrades; this many CONSECUTIVE failures take the
    # backend DOWN (dispatch policy skips it; only probes touch it).
    DOWN_AFTER = 3
    # Consecutive successes that clear DEGRADED back to UP (one lucky
    # dispatch amid a flapping lane must not flap the state/logs).
    RECOVER_OK = 4
    # Seconds between recovery probes of a DOWN backend.
    PROBE_INTERVAL_S = 30.0

    def __init__(self):
        self.enabled = True
        self._mu = threading.Lock()
        self._backends = {b: _Backend(b) for b in BACKENDS}
        # Transitions decided under _mu queue here and publish in FIFO
        # order under _announce_mu — two threads transitioning
        # back-to-back (sampler probe vs. dispatch failure) must not
        # publish the gauge/log/span sinks in swapped order, or the
        # gauge sticks at the older state forever.
        self._pending: list[tuple] = []
        self._announce_mu = threading.Lock()

    # -- per-dispatch profile -----------------------------------------

    def record_dispatch(self, kernel: str, backend: str, nbytes: int,
                        wall_s: float, blocks: int = 0) -> None:
        """One successful kernel dispatch (called under
        ``KernelStats.record``)."""
        if not self.enabled:
            return
        b = self._backends.get(backend)
        if b is None:
            return
        transition = None
        with self._mu:
            b.dispatches += 1
            b.bytes += nbytes
            b.fail_streak = 0
            b.ok_streak += 1
            if b.state != UP and b.ok_streak >= self.RECOVER_OK:
                # DEGRADED recovers on a success streak; DOWN normally
                # recovers via probe, but a pinned backend bypasses
                # the gate — real successes flowing through it must
                # not leave the state reported down.
                transition = self._set_state(b, UP, "recovered")
        from .metrics2 import METRICS2
        METRICS2.observe(
            "minio_tpu_v2_kernel_dispatch_ms",
            {"kernel": kernel, "backend": backend,
             "batch": batch_bucket(max(1, blocks))}, wall_s * 1e3)
        METRICS2.inc("minio_tpu_v2_kernel_backend_bytes_total",
                     {"kernel": kernel, "backend": backend}, nbytes)
        if transition is not None:
            self._flush_announcements()
        # Live sample for the codec dispatch planner: the per-dispatch
        # profile layer is exactly what a probe-and-pick autotuner
        # reads (ops/autotune.py refines its throughput model from
        # every real dispatch).
        from ..ops.autotune import AUTOTUNE
        AUTOTUNE.observe(kernel, backend, nbytes, wall_s)
        # Worst-dispatch exemplar for the current timeline window.
        from .timeline import TIMELINE
        TIMELINE.note_kernel(kernel, backend, wall_s * 1e3)

    def record_queue_wait(self, kernel: str, wait_ms: float) -> None:
        """Coalescer window wait for one request — the queue half of
        the queue-wait vs device-execute split."""
        if not self.enabled:
            return
        from .metrics2 import METRICS2
        METRICS2.observe("minio_tpu_v2_kernel_queue_wait_ms",
                         {"kernel": kernel}, wait_ms)

    # -- dispatch outcomes --------------------------------------------

    def dispatch_failed(self, backend: str,
                        exc: BaseException | str) -> None:
        """A real dispatch on `backend` raised.  Replaces
        ``ops/batching._warn_device_fallback``: the cause is logged on
        every STATE TRANSITION (not once per process), so a second
        distinct failure mode — or a failure after a recovery — is
        never swallowed."""
        b = self._backends.get(backend)
        if b is None:
            return
        cause = exc if isinstance(exc, str) else repr(exc)
        with self._mu:
            b.failures += 1
            b.fail_streak += 1
            b.ok_streak = 0
            b.last_error = cause
            if b.fail_streak >= self.DOWN_AFTER:
                self._set_state(b, DOWN, cause)
            elif b.state == UP:
                self._set_state(b, DEGRADED, cause)
        # Unconditional: even when another thread's concurrent outcome
        # won the transition, returning only after the queue drains
        # means callers observe sinks caught up to the state they just
        # fed (flush blocks on _announce_mu until in-flight publishes
        # finish).
        self._flush_announcements()

    def allow(self, backend: str) -> bool:
        """Dispatch-policy gate: False only when the backend is DOWN
        (recovery is the probe's job — real traffic stops paying the
        failure latency).  Lock-free attr read on the hot path.  The
        card lane is always allowed: a broken card shows as its
        dispatches' errors, never as work moved to the host."""
        if backend == DEVICE:
            return True
        b = self._backends.get(backend)
        return b is None or b.state != DOWN

    def state_of(self, backend: str) -> str:
        b = self._backends.get(backend)
        return b.state if b is not None else UP

    # -- state machine internals (caller holds self._mu) ---------------

    def _set_state(self, b: _Backend, new: str, cause: str):
        if b.state == new:
            return None
        old, b.state = b.state, new
        b.changed_at = time.time()
        if new == UP:
            b.fail_streak = 0
        b.ok_streak = 0
        self._pending.append((b.name, old, new, cause))
        return b.name, old, new, cause

    # -- transition fan-out (outside the state lock) -------------------

    def _flush_announcements(self) -> None:
        """Publish queued transitions in the order they were decided.
        Holding _announce_mu across the drain keeps sink order equal
        to transition order even when the flusher is not the thread
        that decided the transition (it then also carries that
        transition's span event, which is the lesser evil: a swapped
        publish leaves the state gauge wrong until the NEXT
        transition)."""
        with self._announce_mu:
            while True:
                with self._mu:
                    if not self._pending:
                        return
                    item = self._pending.pop(0)
                self._announce(*item)

    def _announce(self, backend: str, old: str, new: str,
                  cause: str) -> None:
        from ..logger import Logger
        from .metrics2 import METRICS2
        from .span import current_span
        Logger.get().info(
            f"kernprof: backend {backend} {old} -> {new} ({cause})",
            "kernprof", backend=backend, state=new)
        METRICS2.set_gauge("minio_tpu_v2_kernel_backend_state",
                           {"backend": backend}, _STATE_VALUE[new])
        METRICS2.inc("minio_tpu_v2_kernel_backend_transitions_total",
                     {"backend": backend, "state": new})
        span = current_span()
        if span is not None:
            span.add_event("kernel.backend", backend=backend,
                           old=old, new=new, cause=cause[:256])

    # -- recovery probes -----------------------------------------------

    def maybe_probe(self, now: float | None = None) -> None:
        """Rate-limited recovery probing of DOWN backends (driven by
        the timeline sampler tick; tests call ``probe()`` directly).
        A probe is a tiny real dispatch on that backend — it goes
        through the same fault-injection hook as serving dispatch, so
        an active `kernel` fault plan keeps a probed backend down."""
        now = time.monotonic() if now is None else now
        due = []
        with self._mu:
            for b in self._backends.values():
                if b.state == DOWN and \
                        now - b.last_probe >= self.PROBE_INTERVAL_S:
                    b.last_probe = now
                    due.append(b.name)
        for name in due:
            self.probe(name)

    def probe(self, backend: str) -> bool:
        """One recovery probe; success re-adopts the backend (-> UP)."""
        from .metrics2 import METRICS2
        b = self._backends.get(backend)
        failures_before = b.failures if b is not None else 0
        from ..ops._cuda import BuildFailed
        try:
            ok = _probe_backend(backend)
            err = "" if ok else "probe declined"
        except BuildFailed:
            raise       # a broken build is no lane state
        except Exception as exc:  # noqa: BLE001 - probe must not raise
            ok, err = False, repr(exc)
        METRICS2.inc("minio_tpu_v2_kernel_backend_probes_total",
                     {"backend": backend,
                      "result": "pass" if ok else "fail"})
        if b is None:
            return ok
        if not ok:
            # A probe IS a real dispatch on that backend — its failure
            # is state-machine evidence like any serving dispatch (an
            # explicit probe of an UP backend under an active fault
            # must degrade it, not just note an error string).  But a
            # native probe that failed INSIDE _disable_native already
            # fed dispatch_failed — feeding again would double the
            # fail streak and take native DOWN in 2 probes where every
            # other lane needs 3.
            if b.failures == failures_before:
                self.dispatch_failed(backend, err or "probe failed")
            return False
        with self._mu:
            b.fail_streak = 0
            self._set_state(b, UP, "probe passed")
        # Unconditional (see dispatch_failed): a concurrent probe may
        # have won the UP transition — this probe still returns only
        # once the sinks reflect it.
        self._flush_announcements()
        return ok

    def probe_all(self) -> dict[str, bool]:
        """One probe per backend — the admin /kernel-health?probe=true
        census (boot stays cheap: states are evidence-based, so a
        backend with zero dispatches reads as nominally up/unproven
        until outcomes or an explicit probe say otherwise)."""
        return {name: self.probe(name) for name in BACKENDS}

    # -- views ---------------------------------------------------------

    def mix_snapshot(self) -> dict[str, dict]:
        """Cumulative per-backend dispatch/byte/failure counters -- a
        run deltas these around a phase to record which backend actually
        did the math (chip_smoke.py's lane mix)."""
        with self._mu:
            return {b.name: {"dispatches": b.dispatches,
                             "bytes": b.bytes,
                             "failures": b.failures}
                    for b in self._backends.values()}

    def snapshot(self) -> dict:
        """JSON-ready health view (admin /kernel-health)."""
        with self._mu:
            backends = {}
            for b in self._backends.values():
                backends[b.name] = {
                    "state": b.state,
                    "dispatches": b.dispatches,
                    "bytes": b.bytes,
                    "failures": b.failures,
                    "failStreak": b.fail_streak,
                    "lastError": b.last_error,
                    "changedAt": b.changed_at,
                }
            return {"backends": backends}

    def states(self) -> dict[str, int]:
        """{backend: 0|1|2} — the timeline's per-sample state series."""
        with self._mu:
            return {b.name: _STATE_VALUE[b.state]
                    for b in self._backends.values()}

    def reset(self) -> None:
        with self._mu:
            self._backends = {b: _Backend(b) for b in BACKENDS}
            self._pending.clear()


def _probe_backend(backend: str) -> bool:
    """A tiny real dispatch on one backend.  Byte-correctness is the
    pass criterion -- a backend that answers garbage is as down as one
    that raises.  Each probe consults the fault-injection `kernel`
    hook, so injected dispatch faults hold their backend down."""
    import numpy as np

    from ..faultinject import FAULTS
    from ..ops.gf256 import gf_mat_vec_apply
    data = np.arange(2 * 64, dtype=np.uint8).reshape(2, 64)
    if backend == HOST:
        FAULTS.kernel("rs_encode")
        want = gf_mat_vec_apply(np.eye(2, dtype=np.uint8), data)
        return bool((want == data).all())
    if backend == NATIVE:
        FAULTS.kernel("rs_encode")
        from .. import native
        return native.probe()
    if backend == TORCH_CPU:
        FAULTS.kernel("rs_encode")
        import torch

        from ..ops import rs_gpu
        from ..ops.gf256 import gf_matrix_to_bitplane
        bm = torch.from_numpy(gf_matrix_to_bitplane(
            np.eye(2, dtype=np.uint8)).astype(np.float32))
        out = rs_gpu.gf_apply_plain(bm, torch.from_numpy(data)).numpy()
        return bool((out == data).all())
    if backend == DEVICE:
        FAULTS.kernel("rs_encode")
        from ..ops import batching
        # Fresh device census: a card that came back is what this probe
        # exists to notice, so the cached answer is re-evaluated here.
        if not batching.reprobe_device_present():
            return False
        out = batching.device_encode(data[None, :, :], 2, 1)
        from ..ops.rs_matrix import parity_matrix
        want = gf_mat_vec_apply(parity_matrix(2, 1), data)
        return bool((out[0, :2] == data).all()
                    and (out[0, 2:] == want).all())
    return False


# The process-wide profiler every dispatch boundary shares.
KERNPROF = KernelProfiler()
