"""Self-tuning codec dispatch: a measured per-lane throughput planner.

Port of minio_tpu/ops/autotune.py. A fixed crossover between the card
and the host is wrong on every box but the one it was tuned on: coding
throughput depends on the batch size, the lane and the contention.
``AUTOTUNE`` replaces it with a measured model:

- **Probe ladder** (on demand): one REAL dispatch with a known-answer
  check per (lane, size rung) -- the same plumbing as kernprof's
  recovery probes, routed through the fault-injection ``kernel`` hook so
  an active fault plan keeps a lane unmeasured -- seeding a
  per-(kernel, batch-size-bucket, lane) throughput model.  The device
  lane runs kernel K1 (``rs_gpu.gf_apply``) on the dispatch device: the
  card, or its plain PyTorch version (``torch-cpu``) when the dispatch
  device is the CPU.

- **Live refinement**: every ``KernelStats.record`` feeds its
  (kernel, backend, bytes, wall) sample back here through kernprof, so
  the model tracks the box it is actually running on.

- **Plan with hysteresis**: per (kernel, bucket) the fastest HEALTHY
  lane wins; an incumbent is only unseated by a challenger measuring
  ``hysteresis``x faster over >= ``MIN_SAMPLES`` samples, so one noisy
  sample can't flap the plan.  kernprof DOWN lanes are never chosen
  (``KERNPROF.allow`` gates at decision time, not just plan time);
  pinned backends (codec ``backend="gpu"|"cpu"``) bypass the planner
  entirely.

- **Re-planning**: ``batching.reprobe_device_present()`` reports a
  device-census change here, which re-probes the device lane and
  recomputes the plan.

Every plan transition and probe outcome publishes through three sinks:
a cause-carrying console line, a ``codec.plan`` span event on the active
trace, and the ``codec_plan_*`` metrics.

The ONLY hardwired threshold of the dispatch plane lives here
(``DEFAULT_DEVICE_MIN_BYTES``, the pre-measurement static policy).
The ladder never starts a thread of its own unless a caller asks for
``ensure_probed(background=True)``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

# Lane names come from the kernprof state machine — the planner and
# the health machine must agree on identity.
from ..obs.kernprof import BACKENDS, DEVICE, HOST, NATIVE, TORCH_CPU

RS_ENCODE = "rs_encode"
RS_DECODE = "rs_decode"
SELECT_SCAN = "select_scan"
# Regenerating-code (REGEN storage class) GF apply — ops/rs_regen.py.
REGEN_CODE = "regen_code"
KERNELS = (RS_ENCODE, RS_DECODE, SELECT_SCAN, REGEN_CODE)
# The RS probe ladder seeds only the codec kernels — select scans get
# their OWN known-answer probe (ops/select_kernels.probe_lane): GF
# table-gather throughput says nothing about predicate-mask math.
_CODEC_KERNELS = (RS_ENCODE, RS_DECODE)
# Lanes a select scan can actually run on: there is no C++ select
# kernel, so NATIVE is not probed (decide() falling back to NATIVE is
# mapped to HOST by select_kernels.choose_lane).  Rows per select rung
# at least this many.
_SELECT_PROBE_ROWS = 4096

# Batch-size buckets for the dispatch decision: coalesced-dispatch
# bytes, not block counts (the decision input is "how big is this
# batch", the kernprof histogram's block-bucket answers "how full").
_SIZE_BUCKETS = ((64 * 1024, "<64K"),
                 (1024 * 1024, "64K-1M"),
                 (4 * 1024 * 1024, "1-4M"),
                 (16 * 1024 * 1024, "4-16M"))
TOP_BUCKET = "16M+"
BUCKETS = tuple(name for _, name in _SIZE_BUCKETS) + (TOP_BUCKET,)

# The pre-measurement static policy: device when present and the batch
# clears this floor (the reference's TPU_MIN_BYTES). Used only until the
# probe ladder has run, and when autotuning is disabled -- the ONE
# hardwired threshold of the dispatch plane.
DEFAULT_DEVICE_MIN_BYTES = 4 * 1024 * 1024

_LANE_INDEX = {b: i for i, b in enumerate(BACKENDS)}

# No-model-data last resort, most- to least-preferred: numpy host
# ranks ABOVE the plain PyTorch lane on the CPU (a float32 bit-plane
# product per byte column), and this branch by definition has no
# measurement saying otherwise.
_FALLBACK_ORDER = (DEVICE, NATIVE, HOST, TORCH_CPU)

# Probe rung per bucket: (bucket, B, S) with k = _PROBE_K, so B*k*S is
# the rung's bytes; shapes stay in one (B=8, k=4) family so only S
# varies rung to rung.  The top bucket is seeded from the 4-16M rung (a
# 32MiB probe would pay more wall than it buys).
_PROBE_K, _PROBE_M = 4, 2
_PROBE_RUNGS = (("<64K", 8, 1024),        # 32 KiB
                ("64K-1M", 8, 16384),     # 512 KiB
                ("1-4M", 8, 65536),       # 2 MiB
                ("4-16M", 8, 262144))     # 8 MiB


def _card_checked(lane: str, what: str,
                  result: tuple[float | None, str]
                  ) -> tuple[float | None, str]:
    """A probe's (bytes/s, cause), raising when the card lane failed: a
    broken card or kernel is the caller's error, as its dispatches' are
    (ops/batching.py), never a lane the plan quietly routes around."""
    bps, err = result
    if bps is None and lane == DEVICE:
        raise RuntimeError(f"autotune: the {what} probe failed on the "
                           f"card ({err})")
    return result


def size_bucket(nbytes: int) -> str:
    for ub, name in _SIZE_BUCKETS:
        if nbytes <= ub:
            return name
    return TOP_BUCKET


class _LaneModel:
    """EWMA throughput for one (kernel, bucket, lane)."""

    __slots__ = ("bps", "samples")

    def __init__(self):
        self.bps = 0.0
        self.samples = 0

    def feed(self, bps: float, alpha: float = 0.3) -> None:
        self.bps = bps if self.samples == 0 else (
            alpha * bps + (1.0 - alpha) * self.bps)
        self.samples += 1


class CodecAutotuner:
    """Process-wide codec dispatch planner (``AUTOTUNE``)."""

    # A challenger lane must measure this much faster than the
    # incumbent to flip the plan — one lucky sample amid scheduler
    # noise must not flap the dispatch policy (and its three sinks).
    HYSTERESIS = 1.25
    # Live samples a challenger needs before it may unseat an
    # incumbent (probe-ladder seeds count as one deliberate sample and
    # set the INITIAL plan, where there is no incumbent to protect).
    MIN_SAMPLES = 3
    # Clamp floor for measured walls: a sub-resolution timer blip on a
    # 64KiB batch computes as an absurd GiB/s and would poison the
    # EWMA.  Clamping (not rejecting) keeps the evidence -- a native
    # encode of 32KiB can take ~10us, and DROPPING such samples would
    # lock the <64K bucket out of live-only convergence and out of
    # hysteresis challenges entirely.
    MIN_WALL_S = 5e-6

    def __init__(self):
        self.enabled = True
        self.hysteresis = self.HYSTERESIS
        self._mu = threading.Lock()
        self._model: dict[tuple[str, str, str], _LaneModel] = {}
        self._plan: dict[tuple[str, str], str] = {}
        self._plan_version = 0
        self._probed = False
        self._probe_mu = threading.Lock()
        self._probe_thread: threading.Thread | None = None
        self._last_probe: dict[str, dict] = {}
        self._last_select_probe: dict[str, dict] = {}
        self._last_regen_probe: dict[str, dict] = {}
        # Transition fan-out, kernprof-style: decided under _mu,
        # published FIFO under _announce_mu so two threads replanning
        # back-to-back can't publish the sinks in swapped order.
        self._pending: list[tuple] = []
        self._announce_mu = threading.Lock()

    # -- live model -----------------------------------------------------

    def observe(self, kernel: str, backend: str, nbytes: int,
                wall_s: float) -> None:
        """One real dispatch outcome (fed by ``KERNPROF.record_dispatch``
        — the PR-7 profile layer is the autotuner's sensor)."""
        if kernel not in KERNELS or backend not in _LANE_INDEX:
            return
        if wall_s <= 0 or nbytes <= 0:
            return
        bucket = size_bucket(nbytes)
        with self._mu:
            self._feed_locked(kernel, bucket, backend,
                              nbytes / max(wall_s, self.MIN_WALL_S))
            self._replan_locked(kernel, bucket, "live samples")
            pending = bool(self._pending)
        # Flush only when this sample actually flipped the plan — the
        # no-op case must stay a couple of dict ops under one lock.
        if pending:
            self._flush_announcements()

    def _feed_locked(self, kernel: str, bucket: str, lane: str,
                     bps: float) -> None:
        key = (kernel, bucket, lane)
        m = self._model.get(key)
        if m is None:
            m = self._model[key] = _LaneModel()
        m.feed(bps)

    # -- decisions ------------------------------------------------------

    def decide(self, kernel: str, nbytes: int) -> str:
        """The dispatch decision: fastest measured healthy lane for
        this (kernel, size bucket); static pre-measurement policy until
        the ladder has run or when autotuning is off.  Never returns a
        kernprof-DOWN lane."""
        from ..obs.kernprof import KERNPROF
        lane = None
        if self.enabled:
            bucket = size_bucket(nbytes)
            with self._mu:
                lane = self._plan.get((kernel, bucket))
                if lane is not None and not self._probed:
                    # Live-only plan (probe_on_boot=off): engage only
                    # once the chosen lane has real evidence — a
                    # single early sample must not steer dispatch.
                    m = self._model.get((kernel, bucket, lane))
                    if m is None or m.samples < self.MIN_SAMPLES:
                        lane = None
        if lane is None:
            lane = self._static_lane(nbytes)
        if KERNPROF.allow(lane) and self._lane_available(lane):
            return lane
        # Planned lane is DOWN/gone: next-fastest healthy lane from
        # the model, preference order as the no-data fallback.
        bucket = size_bucket(nbytes)
        with self._mu:
            ranked = sorted(
                ((m.bps, ln) for ln, m in
                 ((ln, self._model.get((kernel, bucket, ln)))
                  for ln in BACKENDS)
                 if m is not None and m.samples > 0),
                reverse=True)
        for _, ln in ranked:
            if ln != lane and KERNPROF.allow(ln) \
                    and self._lane_available(ln):
                return ln
        for ln in _FALLBACK_ORDER:
            if ln != lane and KERNPROF.allow(ln) \
                    and self._lane_available(ln):
                return ln
        return HOST  # the floor that can never go away

    def use_jit_lane(self, kernel: str, nbytes: int) -> bool:
        """True when the plan routes this dispatch through the kernel
        path (K1 on the card, or its plain version on the CPU when that
        is the dispatch device -- ``batching.attempt_backend``)."""
        return self.decide(kernel, nbytes) in (DEVICE, TORCH_CPU)

    def host_lane(self, kernel: str, nbytes: int) -> str | None:
        """Which HOST-side lane the plan picked (NATIVE lets the C++
        kernel answer with numpy fallback; HOST forces pure numpy);
        None when the plan routed to the kernel path."""
        lane = self.decide(kernel, nbytes)
        return lane if lane in (NATIVE, HOST) else None

    def coalesce_worthwhile(self) -> bool:
        """Should PUT encodes pay the cross-request coalescing window?
        Only when a real device exists AND the plan still sends some
        encode bucket to it — a window in front of host encodes adds
        latency and batches nothing the host cares about.  Mirrors
        decide()'s evidence rule (probed OR >= MIN_SAMPLES live
        samples per entry), so a process that never ran the ladder and
        whose live-built plan routed every bucket off-device stops paying
        the window too; buckets with no engaged evidence yet keep the
        static device-present answer."""
        from . import batching
        if not batching.device_present():
            return False
        if not self.enabled:
            return True  # static policy: device-present == coalesce
        with self._mu:
            engaged = 0
            for (k, b), lane in self._plan.items():
                if k != RS_ENCODE:
                    continue
                if not self._probed:
                    m = self._model.get((k, b, lane))
                    if m is None or m.samples < self.MIN_SAMPLES:
                        continue  # not engaged: static still rules it
                if lane == DEVICE:
                    return True
                engaged += 1
            # Evidence for every encode bucket and none chose the
            # device -> the window buys nothing; otherwise some
            # bucket still follows the static device policy.
            return engaged < len(BUCKETS)

    def _static_lane(self, nbytes: int) -> str:
        from . import batching
        if batching.device_present() \
                and nbytes >= DEFAULT_DEVICE_MIN_BYTES:
            return DEVICE
        # NATIVE resolves to numpy inside host_apply when the C++ lib
        # is unavailable — same ladder the serving path always had.
        return NATIVE

    @staticmethod
    def _lane_available(lane: str) -> bool:
        if lane == DEVICE:
            from . import batching
            return batching.device_present()
        if lane == TORCH_CPU:
            # attempt_backend() lands on torch-cpu only when the
            # dispatch device is the CPU -- with a card the kernel path
            # IS the device, so "torch-cpu" is unreachable (and choosing
            # its stale model entry would dispatch onto the possibly-
            # DOWN device it was meant to avoid).
            from . import batching
            return not batching.device_present()
        return True

    # -- probe ladder ---------------------------------------------------

    def ensure_probed(self, background: bool = True) -> None:
        """Run the probe ladder once per process.  ``background=True``
        runs it on a thread of its own (a server's boot must not wait on
        kernel and native builds -- the static policy covers the gap);
        callers that must not leave a thread behind, as tests, pass
        False."""
        if self._probed:
            return
        if not background:
            self.probe_ladder()
            return
        with self._probe_mu:
            if self._probed or (self._probe_thread is not None
                                and self._probe_thread.is_alive()):
                return
            # mtpu-lint: disable=R1 -- one-shot process-wide probe worker; it serves no single request's context
            self._probe_thread = threading.Thread(
                target=self._probe_quietly, daemon=True,
                name="codec-autotune-probe")
            self._probe_thread.start()

    def _probe_quietly(self) -> None:
        try:
            self.probe_ladder()
        except Exception:  # noqa: BLE001 - boot probe must not kill anything
            from ..logger import Logger
            Logger.get().log_once("autotune: probe ladder failed",
                                  "autotune")

    def probe_ladder(self) -> dict[str, dict]:
        """Measure every reachable lane at every size rung with a
        known-answer check; seed the model and (re)compute the plan.
        Returns {lane: {bucket: GiB/s | None}} (None = probe failed)."""
        results: dict[str, dict] = {}
        for lane in BACKENDS:
            # _lane_available also excludes torch-cpu while a card
            # answers: attempt_backend() can't reach it then -- the
            # kernel rung measures DEVICE instead.
            if not self._lane_available(lane):
                continue
            results[lane] = {}
            for bucket, B, S in _PROBE_RUNGS:
                bps, err = _card_checked(lane, "rs",
                                         self._probe_lane(lane, B, S))
                nbytes = B * _PROBE_K * S
                self._record_probe(lane, bucket, nbytes, bps, err)
                results[lane][bucket] = (
                    round(bps / (1 << 30), 6) if bps else None)
            # Seed the top bucket from the largest rung: throughput is
            # flat past the 8MiB knee and a 32MiB probe would pay more
            # wall than the information buys.
            top = results[lane].get("4-16M")
            if top:
                with self._mu:
                    for kern in _CODEC_KERNELS:
                        self._feed_locked(kern, TOP_BUCKET, lane,
                                          top * (1 << 30))
        self._probe_select_lanes()
        self._probe_regen_lanes()
        with self._mu:
            self._last_probe = results
            for kern in KERNELS:
                for bucket in BUCKETS:
                    self._replan_locked(kern, bucket, "probe ladder")
            self._probed = True
        self._flush_announcements()
        return results

    def _record_probe(self, lane: str, bucket: str, nbytes: int,
                      bps: float | None, err: str) -> None:
        from ..logger import Logger
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_codec_plan_probes_total",
                     {"lane": lane,
                      "result": "pass" if bps else "fail"})
        if bps:
            with self._mu:
                for kern in _CODEC_KERNELS:
                    # One ladder seeds both codec kernels: encode and
                    # reconstruct run the same GF apply machinery, and
                    # live refinement keys them apart from here on.
                    self._feed_locked(kern, bucket, lane, bps)
            Logger.get().info(
                f"autotune: probe {lane}[{bucket}] "
                f"{bps / (1 << 30):.3f} GiB/s", "autotune",
                lane=lane, bucket=bucket)
        else:
            Logger.get().info(
                f"autotune: probe {lane}[{bucket}] failed ({err})",
                "autotune", lane=lane, bucket=bucket)

    def _probe_select_lanes(self) -> None:
        """Known-answer select-scan probes per size rung: the kernel
        lane (X2 on the card, torch-cpu otherwise) and the numpy host
        lane -- seeding the (select_scan, bucket, lane) model so scan
        dispatch probes-and-picks like RS math does."""
        from .select_kernels import probe_lane
        jit_lane = DEVICE if self._device_visible() else TORCH_CPU
        results: dict[str, dict] = {}
        for lane in (jit_lane, HOST):
            results[lane] = {}
            for bucket, _B, _S in _PROBE_RUNGS:
                nbytes = _B * _PROBE_K * _S
                # two float32 columns per probe batch
                rows = max(_SELECT_PROBE_ROWS, nbytes // 8)
                bps, err = _card_checked(lane, "select",
                                         probe_lane(lane, rows))
                from ..obs.metrics2 import METRICS2
                from ..logger import Logger
                METRICS2.inc("minio_tpu_v2_codec_plan_probes_total",
                             {"lane": lane,
                              "result": "pass" if bps else "fail"})
                if bps:
                    with self._mu:
                        self._feed_locked(SELECT_SCAN, bucket, lane,
                                          bps)
                    Logger.get().info(
                        f"autotune: probe select/{lane}[{bucket}] "
                        f"{bps / (1 << 30):.3f} GiB/s", "autotune",
                        lane=lane, bucket=bucket)
                else:
                    Logger.get().info(
                        f"autotune: probe select/{lane}[{bucket}] "
                        f"failed ({err})", "autotune", lane=lane,
                        bucket=bucket)
                results[lane][bucket] = (
                    round(bps / (1 << 30), 6) if bps else None)
            top = results[lane].get("4-16M")
            if top:
                with self._mu:
                    self._feed_locked(SELECT_SCAN, TOP_BUCKET, lane,
                                      top * (1 << 30))
        with self._mu:
            self._last_select_probe = results

    def _probe_regen_lanes(self) -> None:
        """Known-answer regenerating-code probes per size rung: the
        kernel lane (K1 on the card, torch-cpu otherwise) and the numpy
        host lane -- seeding the (regen_code, bucket, lane) model so the
        REGEN codec's dispatch is measured, never hardwired.  RS probe
        numbers don't transfer: the regen apply is a (B, .) stripe
        matmul with B = kd - k(k-1)/2 rows, a different shape family
        from the k-row RS apply."""
        from .rs_regen import probe_lane
        jit_lane = DEVICE if self._device_visible() else TORCH_CPU
        results: dict[str, dict] = {}
        for lane in (jit_lane, HOST):
            results[lane] = {}
            for bucket, _B, _S in _PROBE_RUNGS:
                nbytes = _B * _PROBE_K * _S
                # probe geometry is 4+2 (B = 14 stripe rows)
                nstripes = max(4096, nbytes // 14)
                bps, err = _card_checked(lane, "regen",
                                         probe_lane(lane, nstripes))
                from ..obs.metrics2 import METRICS2
                from ..logger import Logger
                METRICS2.inc("minio_tpu_v2_codec_plan_probes_total",
                             {"lane": lane,
                              "result": "pass" if bps else "fail"})
                if bps:
                    with self._mu:
                        self._feed_locked(REGEN_CODE, bucket, lane,
                                          bps)
                    Logger.get().info(
                        f"autotune: probe regen/{lane}[{bucket}] "
                        f"{bps / (1 << 30):.3f} GiB/s", "autotune",
                        lane=lane, bucket=bucket)
                else:
                    Logger.get().info(
                        f"autotune: probe regen/{lane}[{bucket}] "
                        f"failed ({err})", "autotune", lane=lane,
                        bucket=bucket)
                results[lane][bucket] = (
                    round(bps / (1 << 30), 6) if bps else None)
            top = results[lane].get("4-16M")
            if top:
                with self._mu:
                    self._feed_locked(REGEN_CODE, TOP_BUCKET, lane,
                                      top * (1 << 30))
        with self._mu:
            self._last_regen_probe = results

    @staticmethod
    def _device_visible() -> bool:
        from . import batching
        return batching.device_present()

    def _probe_lane(self, lane: str, B: int,
                    S: int) -> tuple[float | None, str]:
        """One sized known-answer probe on `lane`: (bytes/s, "") or
        (None, cause).  A probe is a REAL dispatch -- it consults the
        fault-injection `kernel` hook like kernprof's recovery probes,
        so an active fault plan keeps a lane unmeasured.  A kernel or
        native build failure raises (never a lane state)."""
        from ._cuda import BuildFailed
        from .gf256 import gf_mat_vec_apply
        from .rs_matrix import parity_matrix
        k, m = _PROBE_K, _PROBE_M
        rng = np.random.default_rng(B * S)  # deterministic per rung
        data = rng.integers(0, 256, (B, k, S)).astype(np.uint8)
        pm = parity_matrix(k, m)
        want = gf_mat_vec_apply(
            pm, data.transpose(1, 0, 2).reshape(k, B * S))
        try:
            from ..faultinject import FAULTS
            FAULTS.kernel("rs_encode")
            runner = self._lane_runner(lane, pm, data, k, m)
            out = runner()  # warm: kernel build / native build / cache
            wall = min(self._timed(runner) for _ in range(2))
            got = np.asarray(out)
            # Normalize to (m, B, S): the kernel lane answers batch-major
            # (B, m, S), the host lanes column-folded (m, B*S).
            if got.shape == (B, m, S):
                got = got.transpose(1, 0, 2)
            got = got.reshape(m, B, S)
            if not (got == want.reshape(m, B, S)).all():
                return None, "known-answer mismatch"
            return (data.nbytes / max(wall, 1e-9)), ""
        except BuildFailed:
            raise
        except Exception as exc:  # noqa: BLE001 - a probe must not raise
            return None, f"{type(exc).__name__}: {exc}"

    @staticmethod
    def _timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def _lane_runner(self, lane: str, pm, data, k: int, m: int):
        """A thunk computing this lane's parity for `data` -- raises
        when the lane can't run (native library disabled, card gone)."""
        B, _, S = data.shape
        cols = np.ascontiguousarray(
            data.transpose(1, 0, 2).reshape(k, B * S))
        if lane in (DEVICE, TORCH_CPU):
            from . import _cuda, batching, rs_gpu
            from .gf256 import gf_matrix_to_bitplane
            dev = batching.dispatch_device()
            bm = rs_gpu.as_bitmatrix(
                gf_matrix_to_bitplane(pm).astype(np.float32), dev)
            placed = _cuda.to_device(data, dev)

            def run_kernel():
                out = rs_gpu.gf_apply(bm, placed)
                return out.cpu().numpy()  # sync: the wall must be real
            return run_kernel
        if lane == NATIVE:
            from ..native import rs_apply_native

            def run_native():
                out = rs_apply_native(pm, cols)
                if out is None:
                    raise RuntimeError("native kernel unavailable")
                return out
            return run_native

        from .gf256 import gf_mat_vec_apply

        def run_host():
            return gf_mat_vec_apply(pm, cols)
        return run_host

    # -- planning -------------------------------------------------------

    def _replan_locked(self, kernel: str, bucket: str,
                       cause: str) -> None:
        """Recompute one (kernel, bucket) plan entry from the model
        (caller holds _mu).  Hysteresis: a measured incumbent is only
        unseated by a challenger `hysteresis`x faster with >=
        MIN_SAMPLES samples."""
        from ..obs.kernprof import KERNPROF
        # O(lanes) direct lookups — this runs per DISPATCH via
        # observe(), so no full-model scan (KERNPROF.allow is a
        # lock-free attribute read).
        candidates = []
        for ln in BACKENDS:
            m = self._model.get((kernel, bucket, ln))
            if m is not None and m.samples > 0 \
                    and KERNPROF.allow(ln) \
                    and self._lane_available(ln):
                candidates.append((m.bps, m.samples, ln))
        if not candidates:
            return
        candidates.sort(reverse=True)
        best_bps, best_n, best = candidates[0]
        key = (kernel, bucket)
        incumbent = self._plan.get(key)
        if incumbent == best:
            return
        inc_model = self._model.get((kernel, bucket, incumbent)) \
            if incumbent else None
        inc_healthy = (incumbent is not None
                       and KERNPROF.allow(incumbent)
                       and self._lane_available(incumbent))
        if inc_model is not None and inc_healthy:
            if best_n < self.MIN_SAMPLES:
                return
            if best_bps < inc_model.bps * self.hysteresis:
                return
            why = (f"{cause}: {best} {best_bps / (1 << 30):.3f} "
                   f"GiB/s > {incumbent} "
                   f"{inc_model.bps / (1 << 30):.3f} GiB/s "
                   f"x{self.hysteresis:.2f}")
        else:
            why = (f"{cause}: {best} "
                   f"{best_bps / (1 << 30):.3f} GiB/s"
                   + (f" (incumbent {incumbent} unhealthy)"
                      if incumbent else ""))
        self._plan[key] = best
        self._plan_version += 1
        self._pending.append((kernel, bucket, incumbent, best, why))

    def replan(self, cause: str) -> None:
        """Recompute the whole plan (device census changed, config
        flip, probe re-adoption)."""
        with self._mu:
            for kern in KERNELS:
                for bucket in BUCKETS:
                    self._replan_locked(kern, bucket, cause)
        self._flush_announcements()

    def on_device_census_change(self, old_n: int, new_n: int) -> None:
        """``batching.reprobe_device_present`` saw the device count
        change: the serving mesh was rebuilt; re-probe the device lane
        and re-plan so dispatch follows the new hardware."""
        cause = f"device census changed ({old_n} -> {new_n} devices)"
        from ..logger import Logger
        Logger.get().info(f"autotune: {cause}; re-planning",
                          "autotune")
        if self._probed:
            # Re-measure only the device lane (the host lanes didn't
            # change).
            lane = DEVICE if self._device_visible() else TORCH_CPU
            for bucket, B, S in _PROBE_RUNGS:
                bps, err = _card_checked(lane, "rs",
                                         self._probe_lane(lane, B, S))
                self._record_probe(lane, bucket, B * _PROBE_K * S,
                                   bps, err)
        self.replan(cause)

    # -- transition fan-out (outside _mu) -------------------------------

    def _flush_announcements(self) -> None:
        with self._announce_mu:
            while True:
                with self._mu:
                    if not self._pending:
                        return
                    item = self._pending.pop(0)
                self._announce(*item)

    def _announce(self, kernel: str, bucket: str, old: str | None,
                  new: str, cause: str) -> None:
        from ..logger import Logger
        from ..obs.metrics2 import METRICS2
        from ..obs.span import current_span
        Logger.get().info(
            f"autotune: plan {kernel}[{bucket}] "
            f"{old or 'unset'} -> {new} ({cause})", "autotune",
            kernel=kernel, bucket=bucket, lane=new)
        METRICS2.set_gauge("minio_tpu_v2_codec_plan_lane",
                           {"kernel": kernel, "bucket": bucket},
                           _LANE_INDEX[new])
        METRICS2.inc("minio_tpu_v2_codec_plan_transitions_total",
                     {"kernel": kernel, "bucket": bucket, "lane": new})
        span = current_span()
        if span is not None:
            span.add_event("codec.plan", kernel=kernel, bucket=bucket,
                           old=old or "", new=new, cause=cause[:256])

    # -- config ---------------------------------------------------------

    def configure(self, enabled: bool, hysteresis: float) -> None:
        """Enable/disable the planner and set its hysteresis."""
        flipped = enabled and not self.enabled
        self.enabled = enabled
        h = float(hysteresis)
        # `not (h >= 1.0)` also floors NaN (a plain max() would let a
        # NaN comparison pick either operand depending on order).
        self.hysteresis = h if h >= 1.0 else 1.0
        if flipped and self._probed:
            self.replan("autotune re-enabled")

    # -- views ----------------------------------------------------------

    def plan_indices(self) -> dict[str, int]:
        """Flat {"kernel/bucket": lane index} — the timeline's
        per-sample codec-plan series (collapse/merge take elementwise
        max, like backend states)."""
        with self._mu:
            return {f"{k}/{b}": _LANE_INDEX[lane]
                    for (k, b), lane in sorted(self._plan.items())}

    def plan_compact(self) -> dict[str, dict[str, str]]:
        """{kernel: {bucket: lane}} -- the compact plan a run prints
        beside its lane mix."""
        with self._mu:
            out: dict[str, dict[str, str]] = {}
            for (k, b), lane in sorted(self._plan.items()):
                out.setdefault(k, {})[b] = lane
            return out

    def snapshot(self) -> dict:
        """JSON-ready planner view: the live
        plan, the measured per-lane crossover table, probe results,
        and gauges the operator needs to trust a number."""
        from ..obs.kernprof import KERNPROF
        with self._mu:
            crossover: dict[str, dict[str, dict]] = {}
            for (k, b, ln), m in sorted(self._model.items()):
                crossover.setdefault(k, {}).setdefault(b, {})[ln] = {
                    "gibs": round(m.bps / (1 << 30), 6),
                    "samples": m.samples,
                }
            plan = {f"{k}/{b}": lane
                    for (k, b), lane in sorted(self._plan.items())}
            out = {
                "enabled": self.enabled,
                "probed": self._probed,
                "planVersion": self._plan_version,
                "hysteresis": self.hysteresis,
                "plan": plan,
                "crossover": crossover,
                "lastProbe": self._last_probe,
                "lastSelectProbe": self._last_select_probe,
                "lastRegenProbe": self._last_regen_probe,
            }
        out["backendStates"] = {
            b: KERNPROF.state_of(b) for b in BACKENDS}
        return out

    def reset(self) -> None:
        with self._mu:
            self._model.clear()
            self._plan.clear()
            self._plan_version = 0
            self._probed = False
            self._last_probe = {}
            self._last_select_probe = {}
            self._last_regen_probe = {}
            self._pending.clear()
        self.enabled = True
        self.hysteresis = self.HYSTERESIS


# The process-wide planner every dispatch decision shares.
AUTOTUNE = CodecAutotuner()
