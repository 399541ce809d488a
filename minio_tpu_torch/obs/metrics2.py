"""Metrics v2: a typed, registered metric namespace with Prometheus
histograms, node/cluster split (ref the reference's cmd/metrics-v2.go
node vs cluster collectors).

Every metric name is REGISTERED up front with its type and help text;
recording to an unregistered name raises — tools/obs_lint.py enforces
the same invariant statically, so the namespace cannot drift.

The registry serializes to a JSON snapshot (`snapshot()`), snapshots
from peers MERGE (`merge()` — counters add, histogram buckets add), and
any snapshot renders to Prometheus text exposition (`render()`). The
node endpoint renders the local snapshot; the cluster endpoint fans out
an RPC (rpc/peer.py `metrics2`), merges, and renders the sum.

The port's own copy of ``minio_tpu/obs/metrics2.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import threading

# Latency buckets in milliseconds (requests and phases share them; the
# +Inf bucket is implicit).
LATENCY_BUCKETS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 10000)

# Cardinality-guard overflow counter: every fold of a capped label
# value into "_other" lands here (registered in __init__ so every
# registry instance — including test-local ones — carries it).
_OVERFLOW = "minio_tpu_v2_metrics_label_overflow_total"


class MetricsV2:
    """Thread-safe registry of counters and histograms."""

    def __init__(self):
        self._mu = threading.Lock()
        # name -> (type, help, buckets|None)
        self._specs: dict[str, tuple[str, str, tuple | None]] = {}
        # name -> {labels_key: value | [bucket_counts, sum, count]}
        self._data: dict[str, dict[tuple, object]] = {}
        # labels_key -> labels dict (for rendering)
        self._labels: dict[tuple, dict] = {}
        # Cardinality guard: name -> {label: cap}; a capped label's
        # values past its cap fold into "_other" at recording time
        # (see _guard) — the fix for the latent unbounded-cardinality
        # risk of any per-bucket/per-tenant series.
        self._cap_labels: dict[str, dict[str, int]] = {}
        # (name, label) -> distinct values admitted so far
        self._cap_seen: dict[tuple[str, str], set] = {}
        self._specs[_OVERFLOW] = (
            "counter",
            "Capped-label values folded into _other by the "
            "cardinality guard, by metric and label.", None)
        self._data[_OVERFLOW] = {}

    # -- registration --------------------------------------------------

    def register(self, name: str, mtype: str, help_text: str,
                 buckets: tuple | None = None,
                 cap_labels: dict[str, int] | None = None) -> None:
        if mtype not in ("counter", "gauge", "histogram"):
            raise ValueError(f"bad metric type {mtype!r}")
        if mtype == "histogram" and buckets is None:
            buckets = LATENCY_BUCKETS_MS
        with self._mu:
            self._specs[name] = (mtype, help_text, buckets)
            self._data.setdefault(name, {})
            if cap_labels:
                self._cap_labels[name] = {
                    lbl: max(1, int(cap))
                    for lbl, cap in cap_labels.items()}

    def set_label_cap(self, name: str, label: str, cap: int) -> None:
        """Live-retune a label's cardinality cap (config-KV ``usage
        cardinality_cap``).  Already-admitted values keep their series
        (shrinking the cap only folds NEW values — re-labeling live
        counters would corrupt the deltas every scraper holds)."""
        with self._mu:
            if name not in self._specs:
                raise ValueError(f"unregistered metric {name!r}")
            self._cap_labels.setdefault(name, {})[label] = \
                max(1, int(cap))

    def registered_names(self) -> set[str]:
        with self._mu:
            return set(self._specs)

    def _key(self, labels: dict | None) -> tuple:
        """Series identity: a sorted items tuple, NOT a serialized
        string — this runs under the registry lock on every disk op /
        kernel call / request, so the critical section must stay at
        dict-key cost (the <= 5%% tracing-overhead budget)."""
        if not labels:
            return ()
        key = tuple(sorted(labels.items()))
        if key not in self._labels:
            self._labels[key] = dict(labels)
        return key

    def _spec(self, name: str, want: tuple[str, ...]):
        spec = self._specs.get(name)
        if spec is None:
            raise ValueError(f"unregistered metric {name!r} "
                             "(register it in obs/metrics2.py)")
        if spec[0] not in want:
            raise ValueError(f"{name} is a {spec[0]}, not {want}")
        return spec

    def _guard(self, name: str, labels: dict | None) -> dict | None:
        """Apply the cardinality cap (caller holds the lock): for each
        capped label, a value past the cap rewrites to "_other" and
        counts into metrics_label_overflow_total — so a hostile or
        runaway keyspace can never grow a capped series unboundedly,
        and the fold is itself observable."""
        caps = self._cap_labels.get(name)
        if not caps or not labels:
            return labels
        out = None
        for lbl, cap in caps.items():
            v = labels.get(lbl)
            if v is None or v == "_other":
                continue
            seen = self._cap_seen.setdefault((name, lbl), set())
            if v in seen:
                continue
            if len(seen) < cap:
                seen.add(v)
                continue
            if out is None:
                out = dict(labels)
            out[lbl] = "_other"
            # Direct write (we already hold the lock; inc() would
            # deadlock) — the overflow counter is registered below.
            series = self._data[_OVERFLOW]
            okey = self._key({"metric": name, "label": lbl})
            series[okey] = series.get(okey, 0) + 1
        return out if out is not None else labels

    # -- recording -----------------------------------------------------

    def inc(self, name: str, labels: dict | None = None,
            v: float = 1) -> None:
        with self._mu:
            self._spec(name, ("counter", "gauge"))
            series = self._data[name]
            key = self._key(self._guard(name, labels))
            series[key] = series.get(key, 0) + v

    def set_gauge(self, name: str, labels: dict | None = None,
                  v: float = 0) -> None:
        with self._mu:
            self._spec(name, ("gauge",))
            self._data[name][self._key(self._guard(name, labels))] = v

    def observe(self, name: str, labels: dict | None = None,
                v: float = 0.0) -> None:
        with self._mu:
            _, _, buckets = self._spec(name, ("histogram",))
            series = self._data[name]
            key = self._key(self._guard(name, labels))
            h = series.get(key)
            if h is None:
                h = series[key] = [[0] * (len(buckets) + 1), 0.0, 0]
            counts, _, _ = h
            for i, ub in enumerate(buckets):
                if v <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            h[1] += v
            h[2] += 1

    def get(self, name: str, labels: dict | None = None):
        """Current value: number (counter/gauge) or (sum, count) for a
        histogram; 0 / (0, 0) when the series has no samples yet."""
        with self._mu:
            mtype = self._spec(name, ("counter", "gauge", "histogram"))[0]
            val = self._data[name].get(self._key(labels))
            if mtype == "histogram":
                return (val[1], val[2]) if val else (0.0, 0)
            return val or 0

    # -- snapshot / merge / render ------------------------------------

    def snapshot(self) -> dict:
        with self._mu:
            out = {}
            for name, (mtype, help_text, buckets) in self._specs.items():
                series = []
                for key, val in self._data[name].items():
                    labels = self._labels.get(key, {})
                    if mtype == "histogram":
                        series.append({"labels": labels,
                                       "counts": list(val[0]),
                                       "sum": val[1], "count": val[2]})
                    else:
                        series.append({"labels": labels, "value": val})
                out[name] = {"type": mtype, "help": help_text,
                             "buckets": list(buckets) if buckets else None,
                             "series": series}
            return out

    def reset(self) -> None:
        with self._mu:
            for name in self._data:
                self._data[name] = {}
            # The cardinality guard resets with the series it guards:
            # stale seen-sets would fold post-reset traffic against
            # ghost admissions (new values denied their own series by
            # names that no longer exist in the registry).
            self._cap_seen.clear()


def merge(*snapshots: dict) -> dict:
    """Sum metric snapshots across nodes (counters add; histogram
    bucket counts, sums and counts add; gauges add — cluster totals)."""
    out: dict = {}
    for snap in snapshots:
        for name, m in snap.items():
            cur = out.get(name)
            if cur is None:
                out[name] = {
                    "type": m["type"], "help": m["help"],
                    "buckets": m.get("buckets"),
                    "series": [dict(s, labels=dict(s["labels"]),
                                    **({"counts": list(s["counts"])}
                                       if "counts" in s else {}))
                               for s in m["series"]],
                }
                continue
            index = {json.dumps(sorted(s["labels"].items())): s
                     for s in cur["series"]}
            for s in m["series"]:
                key = json.dumps(sorted(s["labels"].items()))
                hit = index.get(key)
                if hit is None:
                    add = dict(s, labels=dict(s["labels"]))
                    if "counts" in s:
                        add["counts"] = list(s["counts"])
                    cur["series"].append(add)
                    index[key] = add
                elif "counts" in s:
                    hit["counts"] = [a + b for a, b in
                                     zip(hit["counts"], s["counts"])]
                    hit["sum"] += s["sum"]
                    hit["count"] += s["count"]
                else:
                    hit["value"] += s["value"]
    return out


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _label_str(labels: dict, extra: str = "") -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v) -> str:
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return repr(v) if not isinstance(v, int) else str(v)


def render(snapshot: dict) -> str:
    """Prometheus text exposition (format 0.0.4) of a snapshot."""
    lines: list[str] = []
    for name in sorted(snapshot):
        m = snapshot[name]
        if not m["series"]:
            continue
        lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['type']}")
        for s in sorted(m["series"],
                        key=lambda s: sorted(s["labels"].items())):
            labels = s["labels"]
            if m["type"] == "histogram":
                cum = 0
                for ub, c in zip(m["buckets"], s["counts"]):
                    cum += c
                    le = 'le="%s"' % _num(ub)
                    lines.append(
                        f"{name}_bucket{_label_str(labels, le)} {cum}")
                cum += s["counts"][-1]
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_label_str(labels, inf)} {cum}")
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_num(round(s['sum'], 6))}")
                lines.append(f"{name}_count{_label_str(labels)} "
                             f"{s['count']}")
            else:
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_num(s['value'])}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The v2 metric namespace. EVERY name recorded anywhere in the codebase
# must be registered here — METRICS2 raises otherwise, and
# tools/obs_lint.py enforces it statically on the tier-1 path.

METRICS2 = MetricsV2()

METRICS2.register(
    "minio_tpu_v2_api_requests_total", "counter",
    "S3 API requests served, by api and status code.")
METRICS2.register(
    "minio_tpu_v2_api_request_duration_ms", "histogram",
    "End-to-end request latency in milliseconds, by api.")
METRICS2.register(
    "minio_tpu_v2_api_rx_bytes_total", "counter",
    "Request body bytes received.")
METRICS2.register(
    "minio_tpu_v2_api_tx_bytes_total", "counter",
    "Response body bytes sent.")
METRICS2.register(
    "minio_tpu_v2_put_phase_duration_ms", "histogram",
    "Per-phase PUT hot-path latency in milliseconds "
    "(auth, transform, encode, write, commit, post).")
METRICS2.register(
    "minio_tpu_v2_disk_op_duration_ms", "histogram",
    "Per-disk storage call latency in milliseconds, by op.")
METRICS2.register(
    "minio_tpu_v2_rpc_requests_total", "counter",
    "Peer RPC calls served, by service and method.")
METRICS2.register(
    "minio_tpu_v2_kernel_invocations_total", "counter",
    "Codec/hash kernel invocations, by kernel and device.")
METRICS2.register(
    "minio_tpu_v2_kernel_bytes_total", "counter",
    "Bytes encoded/decoded/verified by the kernels, "
    "by kernel and device.")
METRICS2.register(
    "minio_tpu_v2_kernel_wall_seconds_total", "counter",
    "Kernel wall-clock seconds, by kernel and device.")
METRICS2.register(
    "minio_tpu_v2_kernel_batch_blocks_total", "counter",
    "Blocks carried by kernel batches (occupancy numerator).")
METRICS2.register(
    "minio_tpu_v2_kernel_coalesced_requests_total", "counter",
    "Requests merged into coalesced kernel dispatches.")
METRICS2.register(
    "minio_tpu_v2_kernel_dispatch_ms", "histogram",
    "Per-dispatch kernel latency in milliseconds, by kernel, dispatch "
    "backend (device/native/xla-cpu/host) and batch-size bucket.")
METRICS2.register(
    "minio_tpu_v2_kernel_queue_wait_ms", "histogram",
    "Time a request's encode batch waited in the coalescer window "
    "before dispatch, by kernel (the queue half of the queue-wait vs "
    "execute split).")
METRICS2.register(
    "minio_tpu_v2_kernel_backend_bytes_total", "counter",
    "Bytes dispatched per kernel and dispatch backend "
    "(device/native/xla-cpu/host) — the timeline's GiB/s numerator.")
METRICS2.register(
    "minio_tpu_v2_kernel_backend_state", "gauge",
    "Dispatch backend health state (0=up, 1=degraded, 2=down), "
    "by backend.")
METRICS2.register(
    "minio_tpu_v2_kernel_backend_transitions_total", "counter",
    "Dispatch backend health-state transitions, by backend and "
    "new state.")
METRICS2.register(
    "minio_tpu_v2_kernel_backend_probes_total", "counter",
    "Recovery probes of kernel dispatch backends, by backend and "
    "result (pass/fail).")
METRICS2.register(
    "minio_tpu_v2_codec_plan_lane", "gauge",
    "Codec autotuner plan: chosen dispatch lane per (kernel, batch "
    "size bucket) as an index into kernprof BACKENDS "
    "(0=device 1=native 2=xla-cpu 3=host).")
METRICS2.register(
    "minio_tpu_v2_codec_plan_transitions_total", "counter",
    "Codec autotuner plan flips, by kernel, bucket and new lane "
    "(every flip also logs its cause and lands a codec.plan span "
    "event).")
METRICS2.register(
    "minio_tpu_v2_codec_plan_probes_total", "counter",
    "Codec autotuner probe-ladder dispatches, by lane and result "
    "(pass/fail).")
METRICS2.register(
    "minio_tpu_v2_codec_plan_fanout_total", "counter",
    "Coalesced encode windows fanned out as parallel per-device "
    "dispatches, by device count.")
METRICS2.register(
    "minio_tpu_v2_traces_completed_total", "counter",
    "Completed request traces.")
METRICS2.register(
    "minio_tpu_v2_cluster_nodes", "gauge",
    "Nodes contributing to a cluster metrics scrape.")
METRICS2.register(
    "minio_tpu_v2_qos_admission_inflight", "gauge",
    "In-flight admitted requests, by API class.")
METRICS2.register(
    "minio_tpu_v2_qos_admission_queue_depth", "gauge",
    "Requests waiting in the admission queue, by API class.")
METRICS2.register(
    "minio_tpu_v2_qos_admission_wait_ms", "histogram",
    "Admission wait time in milliseconds, by API class "
    "(shed waits included).")
METRICS2.register(
    "minio_tpu_v2_qos_shed_total", "counter",
    "Requests shed with 503 SlowDown, by API class and reason.")
METRICS2.register(
    "minio_tpu_v2_qos_deadline_expired_total", "counter",
    "Request deadline expiries, by where the budget ran out.")
METRICS2.register(
    "minio_tpu_v2_qos_dispatch_total", "counter",
    "Batching-layer dispatches, by priority lane (fg/bg).")
METRICS2.register(
    "minio_tpu_v2_qos_bg_deferrals_total", "counter",
    "Background dispatch deferral slices yielded to foreground work.")
METRICS2.register(
    "minio_tpu_v2_qos_bg_promotions_total", "counter",
    "Background dispatches promoted past busy foreground (aging).")
METRICS2.register(
    "minio_tpu_v2_pipeline_depth", "gauge",
    "Configured depth of the data-plane pipelines, by pipeline.")
METRICS2.register(
    "minio_tpu_v2_pipeline_stall_seconds_total", "counter",
    "Seconds a data-plane pipeline stage spent blocked on the other "
    "side, by pipeline and stage (produce=worker waited on a full "
    "queue, consume=consumer waited on an empty one).")
METRICS2.register(
    "minio_tpu_v2_drive_state", "gauge",
    "Drive health state by disk endpoint "
    "(0=ok, 1=suspect, 2=faulty).")
METRICS2.register(
    "minio_tpu_v2_drive_state_transitions_total", "counter",
    "Drive health state transitions, by disk endpoint and new state.")
METRICS2.register(
    "minio_tpu_v2_drive_op_latency_ewma_ms", "gauge",
    "Rolling per-drive op-class latency EWMA in milliseconds "
    "(published on health-state transitions).")
METRICS2.register(
    "minio_tpu_v2_drive_op_errors_total", "counter",
    "Drive op errors (real disk faults, not namespace misses), "
    "by disk endpoint and op class.")
METRICS2.register(
    "minio_tpu_v2_drive_quarantines_total", "counter",
    "Drives auto-quarantined by the health monitor, by disk endpoint.")
METRICS2.register(
    "minio_tpu_v2_drive_probation_probes_total", "counter",
    "Probation probe rounds on quarantined drives (shadow read + "
    "bitrot verify), by result (pass/fail).")
METRICS2.register(
    "minio_tpu_v2_hedged_reads_total", "counter",
    "Hedged shard reads, by result: fired (backup read launched past "
    "the straggler budget), won (the hedge substituted a straggler), "
    "wasted (the primary answered anyway).")
METRICS2.register(
    "minio_tpu_v2_hedge_budget_ms", "gauge",
    "Current adaptive straggler budget for hedged shard reads.")
METRICS2.register(
    "minio_tpu_v2_mrf_drops_total", "counter",
    "Heal requests dropped because the MRF queue was full.")
METRICS2.register(
    "minio_tpu_v2_mrf_queue_depth", "gauge",
    "Objects waiting in the most-recently-failed heal queue.")
METRICS2.register(
    "minio_tpu_v2_heal_repair_bytes_total", "counter",
    "Repair traffic moved by object heals, by mode (rs = conventional "
    "k-survivor decode, regen = minimum-bandwidth REGEN repair) and "
    "src (disk = bytes helpers read from media, net = bytes shipped "
    "in helper responses) — the observable form of the regenerating "
    "code's repair-bandwidth claim.")
METRICS2.register(
    "minio_tpu_v2_fault_injections_total", "counter",
    "Faults injected by the runtime fault-injection subsystem, "
    "by kind.")
METRICS2.register(
    "minio_tpu_v2_mrf_journal_backlog", "gauge",
    "Live entries in the durable MRF journal (.minio.sys/mrf.log): "
    "queued repairs that survive a crash and replay at boot.")
METRICS2.register(
    "minio_tpu_v2_mrf_journal_drops_total", "counter",
    "Repairs whose journal append was dropped at the size cap — "
    "queued in memory but NOT crash-durable.")
METRICS2.register(
    "minio_tpu_v2_recovery_swept_total", "counter",
    "Boot-time recovery sweep results, by what (found/cleaned/"
    "stage_files/requeued/journal_replayed).")
METRICS2.register(
    "minio_tpu_v2_cache_hits_total", "counter",
    "Hot-object cache hits, by tier (mem/disk).")
METRICS2.register(
    "minio_tpu_v2_cache_misses_total", "counter",
    "Hot-object cache lookups that missed both tiers.")
METRICS2.register(
    "minio_tpu_v2_cache_fills_total", "counter",
    "Single-flight cache fills settled, by result (cached/uncached/"
    "invalidated/short/error/abandoned/waiter_fallback).")
METRICS2.register(
    "minio_tpu_v2_cache_coalesced_waits_total", "counter",
    "GETs that coalesced onto another request's in-flight fill "
    "instead of paying their own erasure read.")
METRICS2.register(
    "minio_tpu_v2_cache_evictions_total", "counter",
    "Hot-object cache evictions, by tier and reason "
    "(capacity/invalidate).")
METRICS2.register(
    "minio_tpu_v2_cache_stale_total", "counter",
    "Cache hits rejected by ETag revalidation (a lost invalidation "
    "caught before serving stale bytes), by tier.")
METRICS2.register(
    "minio_tpu_v2_cache_invalidations_total", "counter",
    "Cache invalidation events that dropped entries or poisoned "
    "in-flight fills, by source (local/peer/stale/bucket).")
METRICS2.register(
    "minio_tpu_v2_cache_bytes", "gauge",
    "Bytes resident in the hot-object cache, by tier.")
METRICS2.register(
    "minio_tpu_v2_cache_entries", "gauge",
    "Objects resident in the hot-object cache, by tier.")
METRICS2.register(
    "minio_tpu_v2_slow_requests_total", "counter",
    "Requests captured by the slow-request log, by API class and "
    "blamed layer.")
METRICS2.register(
    "minio_tpu_v2_slow_request_duration_ms", "histogram",
    "Latency of slowlog-captured requests in milliseconds, by API "
    "class and blamed layer.")
METRICS2.register(
    "minio_tpu_v2_profile_bursts_total", "counter",
    "Profile-on-slow sampling bursts triggered by slow-rate spikes.")
METRICS2.register(
    "minio_tpu_v2_api_class_errors_total", "counter",
    "Requests answered 5xx, by API class (the error-burn numerator; "
    "per-API status detail lives on api_requests_total).")
METRICS2.register(
    "minio_tpu_v2_alerts_firing", "gauge",
    "Watchdog alert state by rule (1 = firing, 0 = not).")
METRICS2.register(
    "minio_tpu_v2_alert_transitions_total", "counter",
    "Watchdog alert lifecycle transitions, by rule and new state "
    "(pending/firing/resolved).")
METRICS2.register(
    "minio_tpu_v2_alert_webhook_total", "counter",
    "Alert webhook delivery outcomes, by result "
    "(sent/failed/dropped).")
METRICS2.register(
    "minio_tpu_v2_incidents_total", "counter",
    "Incident bundles frozen by firing alerts, by rule.")
METRICS2.register(
    "minio_tpu_v2_open_connections", "gauge",
    "Client connections currently held by the front door "
    "(keep-alive sockets, idle or active).")
METRICS2.register(
    "minio_tpu_v2_accept_queue_depth", "gauge",
    "Connections accepted but not yet established (TLS handshake / "
    "loop handoff in flight).")
METRICS2.register(
    "minio_tpu_v2_rpc_inflight", "gauge",
    "Internal peer RPCs currently in flight on this node (client "
    "side, both fabrics) — pair with the process thread count to "
    "verify the async fabric's zero-thread-per-call claim.")
METRICS2.register(
    "minio_tpu_v2_connections_accepted_total", "counter",
    "Client connections accepted by the front door.")
METRICS2.register(
    "minio_tpu_v2_conn_parse_errors_total", "counter",
    "Connections rejected at the HTTP framing layer (malformed head, "
    "oversized head, bad Content-Length, failed TLS handshake).")
METRICS2.register(
    "minio_tpu_v2_select_scanned_bytes_total", "counter",
    "Object bytes read by SelectObjectContent scans "
    "(the BytesScanned the Progress/Stats events report).")
METRICS2.register(
    "minio_tpu_v2_select_processed_bytes_total", "counter",
    "Bytes the select scan actually decoded (columnar Parquet scans "
    "prune to the referenced columns' uncompressed pages) — the "
    "BytesProcessed numerator and the timeline's scan GiB/s source.")
METRICS2.register(
    "minio_tpu_v2_select_returned_bytes_total", "counter",
    "Payload bytes returned in select Records events.")
METRICS2.register(
    "minio_tpu_v2_select_requests_total", "counter",
    "SelectObjectContent queries executed, by engine "
    "(columnar/row/error).")
METRICS2.register(
    "minio_tpu_v2_select_fallback_rows_total", "counter",
    "Rows the columnar scan routed through the row-engine fallback "
    "(division by zero, exact-integer overflow, complex LIKE, "
    "row-tier batches) — exactness escapes, not errors.")
# Tenant/workload attribution (obs/usage.py). Every dynamic label
# (bucket, tenant) is CAPPED: values past the cap fold into "_other"
# and count into metrics_label_overflow_total — the cap follows the
# usage subsystem's cardinality_cap on live reload (set_label_cap).
_USAGE_CAP = 64
METRICS2.register(
    "minio_tpu_v2_usage_requests_total", "counter",
    "S3 requests attributed per bucket and QoS class "
    "(cardinality-capped; overflow folds into _other).",
    cap_labels={"bucket": _USAGE_CAP})
METRICS2.register(
    "minio_tpu_v2_usage_rx_bytes_total", "counter",
    "Request body bytes received, per bucket (capped).",
    cap_labels={"bucket": _USAGE_CAP})
METRICS2.register(
    "minio_tpu_v2_usage_tx_bytes_total", "counter",
    "Response body bytes sent, per bucket (capped).",
    cap_labels={"bucket": _USAGE_CAP})
METRICS2.register(
    "minio_tpu_v2_usage_errors_total", "counter",
    "Non-shed 5xx answers, per bucket (capped).",
    cap_labels={"bucket": _USAGE_CAP})
METRICS2.register(
    "minio_tpu_v2_usage_shed_total", "counter",
    "503 SlowDown sheds / burnt deadlines, per bucket (capped) — "
    "the noisy_neighbor rule's per-tenant shed numerator.",
    cap_labels={"bucket": _USAGE_CAP})
METRICS2.register(
    "minio_tpu_v2_usage_tenant_requests_total", "counter",
    "S3 requests attributed per access key and QoS class (capped; "
    "tenant ids ride REDACTED — the registry renders on the "
    "unauthenticated metrics pages).",
    cap_labels={"tenant": _USAGE_CAP})
METRICS2.register(
    _OVERFLOW, "counter",
    "Capped-label values folded into _other by the cardinality "
    "guard, by metric and label.")
# Event-loop health plane (obs/loopmon.py): per-loop scheduling lag,
# stall flight recorder, pool census and the continuous profiler.
METRICS2.register(
    "minio_tpu_v2_loop_lag_ms", "histogram",
    "Event-loop heartbeat scheduling lag in milliseconds, by loop "
    "(expected vs actual wake of the 10Hz loopmon heartbeat — the "
    "runtime twin of lint rule R8).")
METRICS2.register(
    "minio_tpu_v2_loop_lag_ewma_ms", "gauge",
    "EWMA of event-loop scheduling lag in milliseconds, by loop.")
METRICS2.register(
    "minio_tpu_v2_loop_tasks", "gauge",
    "Pending asyncio tasks on each monitored event loop.")
METRICS2.register(
    "minio_tpu_v2_loop_stalls_total", "counter",
    "Stall episodes the loopmon flight recorder captured (heartbeat "
    "overdue past obs.loop_stall_ms), by loop.")
METRICS2.register(
    "minio_tpu_v2_pool_threads", "gauge",
    "Executor pool size, by pool (worker/rpc/stream) — splits the "
    "flat process thread count so a stalled loop and an exhausted "
    "pool are distinguishable.")
METRICS2.register(
    "minio_tpu_v2_pool_threads_busy", "gauge",
    "Executor pool threads currently running work, by pool.")
METRICS2.register(
    "minio_tpu_v2_profile_samples_total", "counter",
    "Thread stack samples taken by the continuous profiler "
    "(obs/loopmon.py, ~1% duty cycle).")
