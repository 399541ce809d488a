"""Cluster timeline: a fixed-memory ring of 1-second samples over the
key serving series.

Everything metrics-v2 exports is a cumulative counter — perfect for
Prometheus, useless for the question the SSD-array EC study
(arXiv:1709.05365) shows matters most: WHERE the bottleneck is *right
now*, because it migrates between codec, disk and queueing as load
shifts.  This module adds the time dimension in-process: a sampler
thread deltas the registry once per ``period_s`` into a bounded ring
(>= 15 min retention at fixed memory), so ``/minio-tpu/v2/timeline``
(node) and its cluster fan-in always have history to serve — no
external scraper required, and `tools/mtpu_top.py` renders it live.

Per sample: per-class QPS / inflight / shed, rx/tx bytes, kernel
bytes + GiB/s per dispatch backend (obs/kernprof.py), admission queue
depth, drive-state census, hedge fires, MRF depth, kernel backend
states — and an EXEMPLAR: the trace id of the window's worst request
(and worst kernel dispatch), so a spike in the timeline links straight
to its trace tree / slowlog entry instead of dead-ending in
an aggregate.

Counter-reset discipline: a delta that goes negative (registry reset,
process restart behind a proxy) re-bases on the current value instead
of emitting garbage negatives.

The sampler tick also drives kernprof's rate-limited recovery probes
and the watchdog's alert evaluation (obs/watchdog.py) — one thread
owns all periodic observability work.  Samples additionally carry the
watchdog's burn-rate numerators (per-class 5xx/slowlog deltas), the
count of counter re-bases this window, and the alert census.

The port's own copy of ``minio_tpu/obs/timeline.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# Bounds the ring regardless of config: retention/period is clamped so
# a bad KV write can never grow the ring past ~10 hours of seconds.
MIN_PERIOD_S = 0.05
MAX_SAMPLES = 36000
DEFAULT_PERIOD_S = 1.0
DEFAULT_RETENTION_S = 15 * 60.0

_CLASSES = ("read", "write", "list", "admin", "select")


def _series_sum(metric: dict, by: str | None = None,
                field: str = "value") -> dict | float:
    """Sum a snapshot metric's series — total, or keyed by one label."""
    if by is None:
        return sum(s.get(field, 0) or 0 for s in metric.get("series", []))
    out: dict = {}
    for s in metric.get("series", []):
        key = s.get("labels", {}).get(by, "")
        out[key] = out.get(key, 0) + (s.get(field, 0) or 0)
    return out


class Timeline:
    """Process-wide sample ring + sampler thread (``TIMELINE``)."""

    def __init__(self, period_s: float = DEFAULT_PERIOD_S,
                 retention_s: float = DEFAULT_RETENTION_S):
        # Hot-path kill switch for the request/kernel exemplar hooks
        # (the paired on/off overhead measurement toggles this).
        self.enabled = True
        self._mu = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop_ev = threading.Event()
        self._refs = 0
        self._prev: dict | None = None
        self._worst_req: tuple | None = None   # (ms, trace_id, class)
        self._worst_kern: tuple | None = None  # (ms, trace_id, k, b)
        self.configure(period_s, retention_s)

    # -- config ---------------------------------------------------------

    def configure(self, period_s: float, retention_s: float) -> None:
        """(Re)shape the ring; existing samples are kept up to the new
        capacity.  Live-reloadable via config-KV ``obs
        timeline_sample`` / ``timeline_retention``."""
        period_s = max(float(period_s), MIN_PERIOD_S)
        retention_s = max(float(retention_s), period_s)
        cap = min(int(round(retention_s / period_s)) + 2, MAX_SAMPLES)
        with self._mu:
            old = list(getattr(self, "_ring", ()))
            self.period_s = period_s
            self.retention_s = retention_s
            self._ring: deque = deque(old[-cap:], maxlen=cap)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Refcounted: every running server holds one reference; the
        sampler thread stops when the last one stops."""
        with self._mu:
            self._refs += 1
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop_ev = threading.Event()
            # mtpu-lint: disable=R1 -- process-wide sampler daemon; it serves no single request's context
            self._thread = threading.Thread(
                target=self._run, args=(self._stop_ev,), daemon=True,
                name="timeline-sampler")
            self._thread.start()

    def stop(self) -> None:
        with self._mu:
            self._refs = max(0, self._refs - 1)
            if self._refs > 0:
                return
            t, self._thread = self._thread, None
            self._stop_ev.set()
        if t is not None:
            t.join(timeout=5)

    @property
    def active(self) -> bool:
        return self._thread is not None

    def _run(self, stop_ev: threading.Event) -> None:
        # The thread owns the SPECIFIC event it was started with:
        # re-reading self._stop_ev would race a stop()/start() pair —
        # a new start() swaps in a fresh event before the old thread
        # observed the set of its own, leaving two samplers ticking
        # the same ring (half-period deltas) forever.
        probe_thread: threading.Thread | None = None
        while not stop_ev.wait(self.period_s):
            try:
                self.tick()
                # Watchdog evaluation rides the sampler tick — the
                # rules read their burn windows from the ring this
                # tick just appended to, so alerting needs no thread
                # of its own and stops exactly when sampling stops.
                from .watchdog import WATCHDOG
                WATCHDOG.tick()
                # Recovery probes ride the sampler tick but run on
                # their own short-lived thread: a native probe can
                # REBUILD the C++ lib (g++, up to ~2 min) and xla/
                # device probes pay jit compiles — the sample ring
                # must keep filling exactly when a backend incident
                # is in progress. maybe_probe itself stays sync for
                # tests; rate limiting bounds thread churn.
                if probe_thread is None or not probe_thread.is_alive():
                    from .kernprof import KERNPROF
                    # mtpu-lint: disable=R1 -- process-wide probe worker; it serves no single request's context
                    probe_thread = threading.Thread(
                        target=KERNPROF.maybe_probe, daemon=True,
                        name="kernprof-probe")
                    probe_thread.start()
            except Exception:  # noqa: BLE001 - sampler must survive
                from ..logger import Logger
                Logger.get().log_once("timeline: tick failed",
                                      "timeline")

    # -- exemplars ------------------------------------------------------

    def note_request(self, api_class: str, duration_ms: float,
                     trace_id: str) -> None:
        """Candidate worst-request exemplar for the current window
        (called by the S3 front end per request; cheap compare+swap
        under the lock)."""
        if not self.enabled:
            return
        with self._mu:
            if self._worst_req is None or \
                    duration_ms > self._worst_req[0]:
                self._worst_req = (duration_ms, trace_id, api_class)

    def note_kernel(self, kernel: str, backend: str, wall_ms: float,
                    trace_id: str | None = None) -> None:
        if not self.enabled:
            return
        if trace_id is None:
            from .span import current_span
            span = current_span()
            trace_id = span.trace_id if span is not None else ""
        with self._mu:
            if self._worst_kern is None or \
                    wall_ms > self._worst_kern[0]:
                self._worst_kern = (wall_ms, trace_id, kernel, backend)

    # -- sampling -------------------------------------------------------

    def _read_raw(self) -> dict:
        """Raw cumulative values this tick deltas.  Split out so tests
        can feed synthetic counters (reset behavior, merge shapes)."""
        from .drivemon import DRIVEMON
        from .kernprof import KERNPROF
        from .loopmon import LOOPMON
        from .metrics2 import METRICS2
        snap = METRICS2.snapshot()

        def m(name: str) -> dict:
            return snap.get(name, {})

        hedge = _series_sum(m("minio_tpu_v2_hedged_reads_total"),
                            by="result")
        suspect, faulty = DRIVEMON.counts()
        from .watchdog import WATCHDOG
        firing, pending, worst_rule = WATCHDOG.counts()
        return {
            "qps": _series_sum(m("minio_tpu_v2_qos_admission_wait_ms"),
                               by="class", field="count"),
            "shed": _series_sum(m("minio_tpu_v2_qos_shed_total"),
                                by="class"),
            # Watchdog numerators: 5xx + slowlog captures per class
            # (shed above completes the trio of burn-rate signals).
            "errors": _series_sum(
                m("minio_tpu_v2_api_class_errors_total"), by="class"),
            "slow": _series_sum(m("minio_tpu_v2_slow_requests_total"),
                                by="class"),
            # Alert census at sample time (gauge-like, not delta'd):
            # rendered by mtpu_top and summed by the cluster merge.
            "alerts": {"firing": firing, "pending": pending,
                       "worst": worst_rule},
            "inflight": _series_sum(
                m("minio_tpu_v2_qos_admission_inflight"), by="class"),
            "queueDepth": _series_sum(
                m("minio_tpu_v2_qos_admission_queue_depth")),
            "rx": _series_sum(m("minio_tpu_v2_api_rx_bytes_total")),
            "tx": _series_sum(m("minio_tpu_v2_api_tx_bytes_total")),
            "kernelBytes": _series_sum(
                m("minio_tpu_v2_kernel_backend_bytes_total"),
                by="backend"),
            "hedgeFired": hedge.get("fired", 0),
            "cacheHits": _series_sum(m("minio_tpu_v2_cache_hits_total")),
            "cacheMisses": _series_sum(
                m("minio_tpu_v2_cache_misses_total")),
            "cacheFills": _series_sum(
                m("minio_tpu_v2_cache_fills_total")),
            "cacheBytes": _series_sum(m("minio_tpu_v2_cache_bytes")),
            # Connection plane (s3/asyncserver.py): open keep-alive
            # sockets + accept backlog are gauges, parse rejections a
            # counter the tick deltas.
            "conns": _series_sum(m("minio_tpu_v2_open_connections")),
            "acceptQueue": _series_sum(
                m("minio_tpu_v2_accept_queue_depth")),
            "parseErrors": _series_sum(
                m("minio_tpu_v2_conn_parse_errors_total")),
            # Internal RPC fabric (rpc/aio.py): client-side peer calls
            # in flight paired with the PROCESS thread count — flat
            # threads under a fan-out spike is the async fabric's
            # zero-thread-per-call claim, visible per node.
            "rpcInflight": _series_sum(m("minio_tpu_v2_rpc_inflight")),
            "threads": threading.active_count(),
            # Event-loop health census (obs/loopmon.py): per-loop EWMA
            # scheduling lag + pending tasks, and the flat thread
            # count split per executor pool — a stalled loop and an
            # exhausted pool must be distinguishable on the timeline.
            "loopLag": LOOPMON.lag_census(),
            "loopTasks": LOOPMON.task_census(),
            "poolThreads": _series_sum(
                m("minio_tpu_v2_pool_threads"), by="pool"),
            "poolBusy": _series_sum(
                m("minio_tpu_v2_pool_threads_busy"), by="pool"),
            # Analytics scan volume (s3select): decoded bytes +
            # queries, delta'd into a select GiB/s row in mtpu_top.
            "selectProcessed": _series_sum(
                m("minio_tpu_v2_select_processed_bytes_total")),
            "selectRequests": _series_sum(
                m("minio_tpu_v2_select_requests_total")),
            "mrfDepth": _series_sum(m("minio_tpu_v2_mrf_queue_depth")),
            # Durable-queue twin of mrfDepth: live entries in the
            # per-set MRF journal (watchdog recovery_backlog watches
            # its growth).
            "mrfJournal": _series_sum(
                m("minio_tpu_v2_mrf_journal_backlog")),
            "drives": {"suspect": suspect, "faulty": faulty,
                       "quarantined":
                           len(DRIVEMON.quarantined_endpoints())},
            "backendState": KERNPROF.states(),
            "codecPlan": _codec_plan(),
            # Attribution census (obs/usage.py): the fast window's top
            # bucket per QoS class — gauge-like, not delta'd, so a
            # timeline spike names WHO drove it without a /usage call.
            "usageTop": _usage_top(),
        }

    def tick(self, now: float | None = None) -> dict | None:
        """Take one sample (sampler thread; tests call directly).
        The first tick only establishes the baseline."""
        now = time.time() if now is None else now
        raw = self._read_raw()
        # The read time rides in the baseline so rate math uses the
        # REAL inter-tick interval, not the nominal period (the
        # sampler drifts under load; GiB/s must not).
        raw["_t"] = now
        with self._mu:
            prev, self._prev = self._prev, raw
            worst_req, self._worst_req = self._worst_req, None
            worst_kern, self._worst_kern = self._worst_kern, None
            if prev is None:
                return None
            # Counter delta, reset-safe: a counter that went DOWN was
            # reset — re-base on its current value, never emit a
            # negative. Re-bases are COUNTED into the sample: a storm
            # of them is itself a signal (watchdog counter_resets).
            resets = 0

            def _d(cur: float, prev_v: float) -> float:
                nonlocal resets
                d = cur - prev_v
                if d < 0:
                    resets += 1
                    return cur
                return d

            dt = max(now - prev.get("_t", now - self.period_s), 1e-9)
            sample: dict = {
                "t": round(now, 3),
                # Real inter-tick interval the deltas cover: rate
                # consumers (mtpu_top) must divide by THIS, not the
                # nominal period — the sampler drifts under load,
                # which is exactly when an operator is watching.
                "dt": round(dt, 3),
                "qps": {c: _d(raw["qps"].get(c, 0),
                              prev["qps"].get(c, 0))
                        for c in _CLASSES},
                "shed": {c: _d(raw["shed"].get(c, 0),
                               prev["shed"].get(c, 0))
                         for c in _CLASSES},
                # Burn-rate numerators (watchdog): 5xx + slowlog
                # captures, same per-class delta discipline as qps.
                "errors": {c: _d((raw.get("errors") or {}).get(c, 0),
                                 (prev.get("errors") or {}).get(c, 0))
                           for c in _CLASSES},
                "slow": {c: _d((raw.get("slow") or {}).get(c, 0),
                               (prev.get("slow") or {}).get(c, 0))
                         for c in _CLASSES},
                "inflight": {c: raw["inflight"].get(c, 0)
                             for c in _CLASSES},
                "queueDepth": raw["queueDepth"],
                "rx": _d(raw["rx"], prev["rx"]),
                "tx": _d(raw["tx"], prev["tx"]),
                "kernelBytes": {
                    b: _d(v, prev["kernelBytes"].get(b, 0))
                    for b, v in raw["kernelBytes"].items()},
                "hedgeFired": _d(raw["hedgeFired"],
                                 prev["hedgeFired"]),
                # Cache row (hot-object serving tier): hit/miss/fill
                # deltas + resident bytes, rendered by mtpu_top.
                "cacheHits": _d(raw.get("cacheHits", 0),
                                prev.get("cacheHits", 0)),
                "cacheMisses": _d(raw.get("cacheMisses", 0),
                                  prev.get("cacheMisses", 0)),
                "cacheFills": _d(raw.get("cacheFills", 0),
                                 prev.get("cacheFills", 0)),
                "cacheBytes": raw.get("cacheBytes", 0),
                "conns": raw.get("conns", 0),
                "acceptQueue": raw.get("acceptQueue", 0),
                "parseErrors": _d(raw.get("parseErrors", 0),
                                  prev.get("parseErrors", 0)),
                "rpcInflight": raw.get("rpcInflight", 0),
                "threads": raw.get("threads", 0),
                # Event-loop / pool census (gauge-like, not delta'd):
                # per-loop EWMA lag ms + pending tasks, per-pool
                # thread size and busy count.
                "loopLag": dict(raw.get("loopLag") or {}),
                "loopTasks": dict(raw.get("loopTasks") or {}),
                "poolThreads": dict(raw.get("poolThreads") or {}),
                "poolBusy": dict(raw.get("poolBusy") or {}),
                "selectProcessed": _d(raw.get("selectProcessed", 0),
                                      prev.get("selectProcessed", 0)),
                "selectRequests": _d(raw.get("selectRequests", 0),
                                     prev.get("selectRequests", 0)),
                "mrfDepth": raw["mrfDepth"],
                "mrfJournal": raw.get("mrfJournal", 0),
                "drives": dict(raw["drives"]),
                "backendState": dict(raw["backendState"]),
                # Codec dispatch plan census (gauge-like): flat
                # {"kernel/bucket": lane index} from ops/autotune.py,
                # so a plan flip is visible in the same ring as the
                # backend-state flip that usually caused it.
                "codecPlan": dict(raw.get("codecPlan") or {}),
                # Attribution census (gauge-like, like alerts): the
                # fast window's top bucket per class at sample time.
                "usageTop": dict(raw.get("usageTop") or {}),
                # Alert census at sample time (the watchdog evaluates
                # AFTER each tick, so this reflects the previous
                # evaluation — one period of honest lag).
                "alerts": dict(raw.get("alerts")
                               or {"firing": 0, "pending": 0,
                                   "worst": ""}),
                "nodes": 1,
            }
            sample["resets"] = resets
            sample["kernelGiBs"] = {
                b: round(v / dt / (1 << 30), 6)
                for b, v in sample["kernelBytes"].items()}
            if worst_req is not None:
                sample["worstRequest"] = {
                    "durationMs": round(worst_req[0], 3),
                    "traceId": worst_req[1], "class": worst_req[2]}
            if worst_kern is not None:
                sample["worstKernel"] = {
                    "wallMs": round(worst_kern[0], 3),
                    "traceId": worst_kern[1], "kernel": worst_kern[2],
                    "backend": worst_kern[3]}
            self._ring.append(sample)
            return sample

    # -- views ----------------------------------------------------------

    def samples(self, n: int | None = None,
                since: float | None = None) -> list[dict]:
        with self._mu:
            items = list(self._ring)
        return slice_samples(items, n=n, since=since)

    def snapshot(self, n: int | None = None,
                 since: float | None = None) -> dict:
        return {"periodS": self.period_s,
                "retentionS": self.retention_s,
                "samples": self.samples(n=n, since=since)}

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()
            self._prev = None
            self._worst_req = None
            self._worst_kern = None


def slice_samples(items: list[dict], n: int | None = None,
                  since: float | None = None) -> list[dict]:
    """The one ?n=/?since= slicing semantic, shared by the node ring
    and the cluster merge.  n=0 means none: a bare [-0:] slice would
    be the WHOLE ring, the exact opposite of what ?n=0 asks for."""
    if since is not None:
        items = [s for s in items if s.get("t", 0) > since]
    if n is not None:
        items = items[-n:] if n > 0 else []
    return items


def _codec_plan() -> dict[str, int]:
    from ..ops.autotune import AUTOTUNE
    return AUTOTUNE.plan_indices()


def _usage_top() -> dict:
    from .usage import USAGE
    return USAGE.class_top_shares()


def _bucket(t: float, period_s: float) -> float:
    return round(int(t / period_s) * period_s, 3)


def _collapse_node(snap: dict, period_s: float) -> list[dict]:
    """One node's samples collapsed to at most one per merge bucket.

    A node sampling FASTER than the merge period (per-node live-reload
    of ``obs timeline_sample``) would otherwise land several samples in
    one bucket and be summed as several nodes — inflating `nodes`,
    gauges, and GiB/s by the period ratio.  Within a bucket: counters
    (qps/shed/rx/tx/kernel bytes/hedges) sum, gauges (inflight, queue,
    MRF, drive census) take the bucket's LATEST sample, backend states
    take the worst seen, exemplars the max, and GiB/s is recomputed
    from the summed bytes over the merge period."""
    groups: dict[float, list[dict]] = {}
    for s in snap.get("samples", []):
        groups.setdefault(_bucket(s.get("t", 0.0), period_s),
                          []).append(s)
    out: list[dict] = []
    for key in sorted(groups):
        group = sorted(groups[key], key=lambda s: s.get("t", 0.0))
        if len(group) == 1:
            out.append(group[0])
            continue
        last = group[-1]
        c: dict = {
            "t": key, "nodes": 1,
            "qps": {}, "shed": {}, "errors": {}, "slow": {},
            "kernelBytes": {},
            "inflight": dict(last.get("inflight") or {}),
            "queueDepth": last.get("queueDepth", 0),
            "rx": 0, "tx": 0, "hedgeFired": 0, "resets": 0,
            "selectProcessed": 0, "selectRequests": 0,
            "cacheHits": 0, "cacheMisses": 0, "cacheFills": 0,
            "cacheBytes": last.get("cacheBytes", 0),
            "conns": last.get("conns", 0),
            "acceptQueue": last.get("acceptQueue", 0),
            "parseErrors": 0,
            "rpcInflight": last.get("rpcInflight", 0),
            "threads": last.get("threads", 0),
            # Census like alerts: the bucket's latest loop/pool state.
            "loopLag": dict(last.get("loopLag") or {}),
            "loopTasks": dict(last.get("loopTasks") or {}),
            "poolThreads": dict(last.get("poolThreads") or {}),
            "poolBusy": dict(last.get("poolBusy") or {}),
            "mrfDepth": last.get("mrfDepth", 0),
            "mrfJournal": last.get("mrfJournal", 0),
            "drives": dict(last.get("drives") or {}),
            # Census, not a counter: the node's LATEST alert state.
            "alerts": dict(last.get("alerts") or {}),
            # Census like alerts: the bucket's latest codec plan.
            "codecPlan": dict(last.get("codecPlan") or {}),
            # Census: the bucket's latest attribution shares.
            "usageTop": dict(last.get("usageTop") or {}),
            "backendState": {},
        }
        for s in group:
            for fld in ("qps", "shed", "errors", "slow",
                        "kernelBytes"):
                for k, v in (s.get(fld) or {}).items():
                    c[fld][k] = c[fld].get(k, 0) + v
            for fld in ("rx", "tx", "hedgeFired", "cacheHits",
                        "cacheMisses", "cacheFills", "resets",
                        "parseErrors", "selectProcessed",
                        "selectRequests"):
                c[fld] += s.get(fld, 0)
            for k, v in (s.get("backendState") or {}).items():
                c["backendState"][k] = max(c["backendState"].get(k, 0),
                                           v)
            for wf, metric in (("worstRequest", "durationMs"),
                               ("worstKernel", "wallMs")):
                w = s.get(wf)
                if w and w.get(metric, 0) > c.get(wf, {}).get(
                        metric, -1):
                    c[wf] = dict(w)
        c["kernelGiBs"] = {k: round(v / period_s / (1 << 30), 6)
                           for k, v in c["kernelBytes"].items()}
        out.append(c)
    return out


def merge_timelines(snapshots: list[dict],
                    period_s: float | None = None) -> dict:
    """Merge node timeline snapshots into one cluster view.

    Samples align on floor(t / period) buckets, so a LAGGING peer
    (clock a little behind, or a scrape that raced its sampler) still
    lands its samples in the right windows; buckets only some nodes
    reported carry their true ``nodes`` count rather than faking a
    cluster-wide zero.  Sums: qps/shed/rx/tx/kernel bytes/hedges/drive
    census; gauges (inflight, queue, MRF) add across nodes; backend
    states take the per-backend WORST (a cluster where any node's
    device is down should say so); the worst-request exemplar is the
    max across nodes — the whole point of carrying trace ids."""
    if period_s is None:
        period_s = max([s.get("periodS", DEFAULT_PERIOD_S)
                        for s in snapshots] or [DEFAULT_PERIOD_S])
    buckets: dict[float, dict] = {}
    for snap in snapshots:
        for s in _collapse_node(snap, period_s):
            key = _bucket(s.get("t", 0.0), period_s)
            cur = buckets.get(key)
            if cur is None:
                cur = buckets[key] = {
                    "t": key, "nodes": 0,
                    "qps": {}, "shed": {}, "errors": {}, "slow": {},
                    "inflight": {},
                    "queueDepth": 0, "rx": 0, "tx": 0,
                    "kernelBytes": {}, "kernelGiBs": {},
                    "hedgeFired": 0, "mrfDepth": 0, "mrfJournal": 0,
                    "conns": 0, "acceptQueue": 0, "parseErrors": 0,
                    "rpcInflight": 0, "threads": 0,
                    "loopLag": {}, "loopTasks": {},
                    "poolThreads": {}, "poolBusy": {},
                    "resets": 0,
                    "selectProcessed": 0, "selectRequests": 0,
                    "cacheHits": 0, "cacheMisses": 0,
                    "cacheFills": 0, "cacheBytes": 0,
                    "drives": {"suspect": 0, "faulty": 0,
                               "quarantined": 0},
                    "alerts": {"firing": 0, "pending": 0,
                               "worst": ""},
                    "codecPlan": {},
                    "usageTop": {},
                    "backendState": {},
                }
            cur["nodes"] += int(s.get("nodes", 1))
            for fld in ("qps", "shed", "errors", "slow", "inflight",
                        "kernelBytes", "kernelGiBs"):
                for k, v in (s.get(fld) or {}).items():
                    cur[fld][k] = cur[fld].get(k, 0) + v
            for fld in ("queueDepth", "rx", "tx", "hedgeFired",
                        "mrfDepth", "mrfJournal", "cacheHits",
                        "cacheMisses", "cacheFills", "cacheBytes",
                        "conns", "acceptQueue", "parseErrors",
                        "rpcInflight", "threads",
                        "resets", "selectProcessed",
                        "selectRequests"):
                cur[fld] += s.get(fld, 0)
            for k, v in (s.get("drives") or {}).items():
                cur["drives"][k] = cur["drives"].get(k, 0) + v
            al = s.get("alerts") or {}
            cal = cur["alerts"]
            cal["firing"] += al.get("firing", 0)
            cal["pending"] += al.get("pending", 0)
            # Worst rule: keep the first firing node's headline (any
            # one is a valid entry point into /v2/alerts/cluster).
            if al.get("worst") and (not cal["worst"]
                                    or al.get("firing", 0) > 0):
                cal["worst"] = al["worst"]
            for k, v in (s.get("backendState") or {}).items():
                cur["backendState"][k] = max(
                    cur["backendState"].get(k, 0), v)
            # Loop names are per node but may collide across nodes
            # (every node has an "rpc" loop): lag takes the WORST
            # node's EWMA (the cluster row answers "is any loop
            # lagging"), tasks/pool counts sum like threads.
            for k, v in (s.get("loopLag") or {}).items():
                cur["loopLag"][k] = max(cur["loopLag"].get(k, 0), v)
            for fld in ("loopTasks", "poolThreads", "poolBusy"):
                for k, v in (s.get(fld) or {}).items():
                    cur[fld][k] = cur[fld].get(k, 0) + v
            # Per-(kernel/bucket) WORST lane across nodes (highest
            # index = furthest from the device), same rule as backend
            # states: a cluster where any node fell back should say so.
            for k, v in (s.get("codecPlan") or {}).items():
                cur["codecPlan"][k] = max(cur["codecPlan"].get(k, 0),
                                          v)
            # Per-class WORST concentration across nodes: the cluster
            # row names the bucket with the highest single-node share
            # (an exact cross-node merge lives on /usage/cluster; the
            # timeline census is the headline, like alerts.worst).
            for cls, top in (s.get("usageTop") or {}).items():
                cur_top = cur["usageTop"].get(cls)
                if cur_top is None or top.get("share", 0) > \
                        cur_top.get("share", 0):
                    cur["usageTop"][cls] = dict(top)
            w = s.get("worstRequest")
            if w and w.get("durationMs", 0) > cur.get(
                    "worstRequest", {}).get("durationMs", -1):
                cur["worstRequest"] = dict(w)
            wk = s.get("worstKernel")
            if wk and wk.get("wallMs", 0) > cur.get(
                    "worstKernel", {}).get("wallMs", -1):
                cur["worstKernel"] = dict(wk)
    return {"periodS": period_s,
            "nodes": len(snapshots),
            "samples": [buckets[k] for k in sorted(buckets)]}


# The process-wide timeline every sink shares.
TIMELINE = Timeline()
