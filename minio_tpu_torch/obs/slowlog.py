"""Always-on slow-request capture with per-layer latency attribution.

Any request whose wall time exceeds its API class's live-reloadable SLO
threshold (config-KV ``obs.slow_ms[_read|_write|_list|_admin]``), or
that answers 5xx, gets its full span tree plus its QoS
admission/deadline data persisted into a bounded ring — annotated with
a computed **blamed layer** so "why was this request slow?" is answered
from the entry itself, not by replaying load. Deliberate backpressure
(admission sheds, burnt deadlines) is EXEMPT: a 503 SlowDown is the
QoS layer working, and letting sheds flood the ring/blame histogram
would bury the real tail (bench.py's qos_brownout asserts this).

Blame is derived from child-span SELF-times (duration minus children):
  admission-wait  QoS queue wait before the handler ran
  encode-kernel   RS/bitrot kernel work (kernel.*, ec.encode)
  disk            local disk ops + shard fan-out (disk.*, ec.shard_*)
  rpc             peer wire + remote server time (rpc.*)
  client-stream   root self-time: reading the client's body / writing
                  the response (plus auth and handler glue)
  other           anything unattributable (no trace, unknown spans)

Entries land as a metrics-v2 histogram labeled by class and blamed
layer, so dashboards see WHERE tail latency lives without scraping the
ring. An optional profile-on-slow mode (``obs.profile_on_slow``)
triggers a short SamplingProfiler burst when the slow rate spikes.

The port's own copy of ``minio_tpu/obs/slowlog.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
import time
from collections import deque

BLAME_ADMISSION = "admission-wait"
BLAME_ENCODE = "encode-kernel"
BLAME_SCAN = "scan-kernel"
BLAME_DISK = "disk"
BLAME_RPC = "rpc"
BLAME_CLIENT = "client-stream"
BLAME_OTHER = "other"

BLAME_LAYERS = (BLAME_ADMISSION, BLAME_ENCODE, BLAME_SCAN, BLAME_DISK,
                BLAME_RPC, BLAME_CLIENT, BLAME_OTHER)

API_CLASSES = ("read", "write", "list", "admin", "select")


def _bucket_for(name: str) -> str | None:
    """Span name -> blame bucket; None = inherit the parent's bucket."""
    if name.startswith("disk.") or name.startswith("ec.shard_"):
        return BLAME_DISK
    if name.startswith("rpc."):
        return BLAME_RPC
    if name.startswith("select."):
        # Columnar S3 Select scan work (s3select/engine.py): a
        # scan-bound SelectObjectContent blames its kernel time, not
        # client-stream — the disk/decode spans BELOW select.scan
        # still re-bucket to their own layers.
        return BLAME_SCAN
    if (name.startswith("kernel.") or name == "ec.encode"
            or name.startswith("bitrot")):
        return BLAME_ENCODE
    return None


def blame_layers(tree: dict | None,
                 admission_wait_ms: float = 0.0) -> dict[str, float]:
    """Attribute a span tree's wall time to blame buckets by self-time.

    Parallel fan-out children may sum past their parent's duration (six
    disks writing at once); self-time clamps at zero and the children
    keep their full durations — over-attribution to a bucket is exactly
    the signal wanted (the quorum waited on that layer)."""
    totals = dict.fromkeys(BLAME_LAYERS, 0.0)
    totals[BLAME_ADMISSION] = max(0.0, admission_wait_ms)

    def walk(node: dict, inherited: str, deduct: float = 0.0) -> None:
        if not isinstance(node, dict):
            return
        dur = float(node.get("durationMs", 0.0) or 0.0)
        kids = [c for c in node.get("children", ())
                if isinstance(c, dict)]
        child_sum = sum(float(c.get("durationMs", 0.0) or 0.0)
                        for c in kids)
        bucket = _bucket_for(str(node.get("name", ""))) or inherited
        totals[bucket] += max(0.0, dur - child_sum - deduct)
        for c in kids:
            walk(c, bucket)

    if tree is not None:
        # Root self-time is the handler reading/writing the client
        # stream (plus auth/glue) — everything below it re-buckets.
        # The admission wait elapsed INSIDE the root span (route_qos
        # blocks under it with no child span), so deduct it from the
        # root's self-time: without this, client-stream >= admission
        # always and a QoS-queuing-dominated request misblames.
        walk(tree, BLAME_CLIENT, deduct=totals[BLAME_ADMISSION])
    return totals


def blamed_layer(totals: dict[str, float]) -> str:
    worst = max(totals, key=lambda b: totals[b])
    return worst if totals[worst] > 0.0 else BLAME_OTHER


class SlowLog:
    """Bounded ring of annotated slow/5xx request captures
    (singleton ``SLOWLOG``; served by admin ``/slowlog``)."""

    RING_SIZE = 128
    # Profile-on-slow: a burst fires when this many captures land
    # within TRIGGER_WINDOW_S, at most once per COOLDOWN_S.
    PROFILE_TRIGGER = 5
    TRIGGER_WINDOW_S = 10.0
    PROFILE_BURST_S = 2.0
    PROFILE_COOLDOWN_S = 60.0

    def __init__(self):
        self.enabled = True
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=self.RING_SIZE)
        self.total = 0
        # Requests excluded as deliberate backpressure (admission
        # sheds, burnt deadlines): the direct evidence the exemption
        # engaged — bench's brownout asserts every shed incremented
        # this instead of guessing from 503 status codes (a quorum
        # 503 is a capture we WANT, not a leak).
        self.exempted = 0
        self.slow_ms = 1000.0
        self._class_ms: dict[str, float | None] = {}
        self.profile_on_slow = False
        self.last_profile: dict | None = None
        self._slow_times: deque = deque(maxlen=self.PROFILE_TRIGGER)
        self._profiling = False
        self._last_burst = 0.0

    # -- live configuration (config-KV apply hook) ---------------------

    def configure(self, slow_ms: float,
                  per_class: dict[str, float | None] | None = None,
                  profile_on_slow: bool = False) -> None:
        """slow_ms <= 0 disables the latency trigger (5xx capture
        stays on); per-class values override the global threshold."""
        with self._mu:
            self.slow_ms = float(slow_ms)
            self._class_ms = dict(per_class or {})
            self.profile_on_slow = bool(profile_on_slow)

    def threshold_ms(self, api_class: str) -> float:
        override = self._class_ms.get(api_class)
        return self.slow_ms if override is None else float(override)

    def thresholds(self) -> dict:
        return {"default": self.slow_ms,
                **{c: v for c, v in sorted(self._class_ms.items())
                   if v is not None}}

    # -- capture -------------------------------------------------------

    def record(self, *, api: str, api_class: str, method: str,
               path: str, status: int, duration_ms: float,
               request_id: str = "", trace: dict | None = None,
               qos: dict | None = None,
               exempt: bool = False) -> dict | None:
        """Called once per finished S3 request; returns the captured
        entry, or None on the (overwhelmingly common) fast path."""
        if not self.enabled:
            return None
        if exempt:
            with self._mu:
                self.exempted += 1
            return None
        thr = self.threshold_ms(api_class or "read")
        slow = thr > 0 and duration_ms >= thr
        if not slow and status < 500:
            return None
        wait_ms = float((qos or {}).get("waitMs", 0.0) or 0.0)
        totals = blame_layers(trace, admission_wait_ms=wait_ms)
        blamed = blamed_layer(totals)
        entry = {
            "time": time.time(),
            "api": api, "apiClass": api_class,
            "method": method, "path": path,
            "statusCode": status,
            "durationMs": round(duration_ms, 3),
            "thresholdMs": thr,
            "requestID": request_id,
            "blamedLayer": blamed,
            "blameMs": {b: round(v, 3) for b, v in totals.items()
                        if v > 0.0},
            "slow": slow,
        }
        if qos:
            entry["qos"] = dict(qos)
        if trace is not None:
            entry["spans"] = trace
        with self._mu:
            self._ring.append(entry)
            self.total += 1
        from .metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_slow_requests_total",
                     {"class": api_class or "read", "blame": blamed})
        METRICS2.observe("minio_tpu_v2_slow_request_duration_ms",
                         {"class": api_class or "read",
                          "blame": blamed}, duration_ms)
        self._maybe_profile()
        return entry

    # -- profile-on-slow -----------------------------------------------

    def _maybe_profile(self) -> None:
        if not self.profile_on_slow:
            return
        now = time.monotonic()
        with self._mu:
            self._slow_times.append(now)
            if (self._profiling
                    or len(self._slow_times) < self.PROFILE_TRIGGER
                    or now - self._slow_times[0] > self.TRIGGER_WINDOW_S
                    or now - self._last_burst < self.PROFILE_COOLDOWN_S):
                return
            self._profiling = True
            self._last_burst = now
        # mtpu-lint: disable=R1 -- the 2s profile burst runs past the slow request that tripped it, by design
        threading.Thread(target=self._burst, daemon=True,
                         name="slowlog-profile-burst").start()

    def _burst(self) -> None:
        from ..utils.profiler import SamplingProfiler
        try:
            prof = SamplingProfiler(interval=0.005)
            prof.start()
            time.sleep(self.PROFILE_BURST_S)
            report = prof.stop()
            with self._mu:
                self.last_profile = {"at": time.time(),
                                     "report": report}
            from .metrics2 import METRICS2
            METRICS2.inc("minio_tpu_v2_profile_bursts_total")
        finally:
            with self._mu:
                self._profiling = False

    # -- reads ---------------------------------------------------------

    def entries(self, n: int = 50, blame: str = "",
                api: str = "") -> list[dict]:
        """Newest-last tail of the ring, filtered by blamed layer
        and/or api-class/api-name substring."""
        with self._mu:
            items = list(self._ring)
        if blame:
            items = [e for e in items if e["blamedLayer"] == blame]
        if api:
            items = [e for e in items
                     if api in (e["apiClass"], e["api"])]
        return items[-n:]

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()
            self.total = 0
            self.exempted = 0
            self._slow_times.clear()
            self.last_profile = None


# The process-wide slow-request log the S3 front end records into.
SLOWLOG = SlowLog()
