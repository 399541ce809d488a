"""SLO watchdog: multi-window burn-rate alerting, built-in event
rules, and user-defined threshold rules — the consumer the signal
planes (traces, slowlog/drivemon, timeline/kernprof)
never had.

The stack records everything and alerts on nothing: an operator learns
about a brownout, a quarantine cascade, or a silent backend collapse
by polling endpoints after the fact, when the evidence has already
aged out of the rings.  The online-EC-on-SSD-arrays study
(arXiv:1709.05365) shows the failures that matter at scale are
queueing/tail REGRESSIONS, not codec errors — a class that needs
continuous burn-rate evaluation, not threshold spot checks.  This
module closes the loop:

- **Burn-rate rules** (``error_burn`` / ``shed_burn`` / ``slow_burn``):
  per-class fractions of 5xx / shed / over-SLO requests evaluated over
  TWO windows of the timeline ring — a fast window (default 1m) that
  reacts, and a slow window (default 15m) that confirms.  Both must
  breach: a fast-only spike is a blip, a slow-only residue is history.
  The slow-request numerator uses the ``obs.slow_ms`` SLOs as the
  objective — reconfiguring the SLO reconfigures the alert.

- **Built-in event rules** fed by the state machines that already
  exist: drive suspect/faulty/quarantine census (drivemon), kernel
  backend DOWN (kernprof), MRF heal-backlog growth, hot-cache
  hit-ratio collapse, timeline counter-reset storms.

- **User-defined threshold rules** over any REGISTERED metrics-v2
  series, validated before the config persists (config-KV ``alerts
  rules=<JSON>``, live-reloadable).

Lifecycle per rule: ok -> pending (first breach) -> firing (breach
persists ``pending_ticks`` evaluations) -> resolved (clear for
``resolve_ticks``) — hysteresis on both edges so a flapping signal
cannot page.  Every transition emits a cause-carrying console line
(with ``alert_id``/``rule`` join keys for the JSON log mode), an
``alert`` span event on the active trace (if any), and the
``minio_tpu_v2_alerts_firing`` gauge + transitions counter; firing
additionally freezes an incident bundle (obs/incidents.py) and posts
to the optional webhook (bounded queue, bounded retry + backoff).

The engine ticks on the existing timeline sampler (obs/timeline.py
``_run``) — one thread owns all periodic observability work — and
reads its windows from the sample ring, so burn math inherits the
ring's counter-reset re-basing for free.

The port's own copy of ``minio_tpu/obs/watchdog.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request
from collections import deque

OK, PENDING, FIRING = "ok", "pending", "firing"
_STATE_RANK = {OK: 0, PENDING: 1, FIRING: 2}

_CLASSES = ("read", "write", "list", "admin", "select")

# (rule name, per-class sample field, human label) for the three
# burn-rate signals. The fields are the timeline's per-sample DELTAS,
# already counter-reset re-based by the sampler.
BURN_SIGNALS = (("error_burn", "errors", "5xx"),
                ("shed_burn", "shed", "shed"),
                ("slow_burn", "slow", "over-SLO"))


class AlertRuleError(ValueError):
    """A user-submitted alert rule document is malformed."""


# -- window math ------------------------------------------------------------


def window_sums(samples: list[dict], key: str, now: float,
                window_s: float) -> dict[str, float]:
    """Per-class sums of one per-sample delta field over the samples
    stamped inside ``(now - window_s, now]``."""
    out: dict[str, float] = {}
    lo = now - window_s
    for s in samples:
        if s.get("t", 0.0) <= lo:
            continue
        for cls, v in (s.get(key) or {}).items():
            out[cls] = out.get(cls, 0.0) + (v or 0)
    return out


def window_scalar(samples: list[dict], key: str, now: float,
                  window_s: float) -> float:
    lo = now - window_s
    return sum((s.get(key, 0) or 0) for s in samples
               if s.get("t", 0.0) > lo)


def burn_fractions(samples: list[dict], num_key: str, now: float,
                   window_s: float,
                   min_requests: float) -> dict[str, float]:
    """{class: numerator/requests} for classes whose window carried at
    least ``min_requests`` — one request failing out of one is not a
    burn, it is noise."""
    num = window_sums(samples, num_key, now, window_s)
    den = window_sums(samples, "qps", now, window_s)
    return {cls: num.get(cls, 0.0) / total
            for cls, total in den.items() if total >= min_requests}


# -- rules ------------------------------------------------------------------


class _EvalCtx:
    __slots__ = ("samples", "now", "wd", "registry")

    def __init__(self, samples, now, wd, registry=None):
        self.samples = samples
        self.now = now
        self.wd = wd          # thresholds/windows live on the engine
        self.registry = registry  # metrics2 snapshot (user rules only)


class BurnRule:
    """Multi-window SLO burn rate over one per-class fraction."""

    kind = "burn"

    def __init__(self, name: str, num_key: str, what: str):
        self.name = name
        self.num_key = num_key
        self.what = what

    def evaluate(self, ctx: _EvalCtx):
        wd = ctx.wd
        fast = burn_fractions(ctx.samples, self.num_key, ctx.now,
                              wd.fast_s, wd.MIN_REQUESTS)
        slow = burn_fractions(ctx.samples, self.num_key, ctx.now,
                              wd.slow_s, wd.MIN_REQUESTS)
        worst_cls, worst = "", 0.0
        for cls, f in fast.items():
            if (f >= wd.burn_threshold
                    and slow.get(cls, 0.0) >= wd.burn_threshold
                    and f >= worst):
                worst_cls, worst = cls, f
        if not worst_cls:
            return False, "", 0.0
        cause = (f"{worst_cls} {self.what} fraction "
                 f"{worst:.3f} (fast {wd.fast_s:g}s) / "
                 f"{slow.get(worst_cls, 0.0):.3f} (slow {wd.slow_s:g}s)"
                 f" >= {wd.burn_threshold:g}")
        return True, cause, round(worst, 4)


class DriveRule:
    """Drive health census: any suspect/faulty/quarantined drive."""

    name = "drive_degraded"
    kind = "event"

    def evaluate(self, ctx: _EvalCtx):
        last = ctx.samples[-1] if ctx.samples else {}
        census = last.get("drives") or {}
        n = sum(census.get(k, 0) for k in
                ("suspect", "faulty", "quarantined"))
        if n <= 0:
            return False, "", 0.0
        # Name the drives — REDACTED identities, because the node
        # alerts surface is unauthenticated like the metrics pages
        # (admin /drive-health maps them back to full endpoints).
        from .drivemon import DRIVEMON, redacted_endpoint
        names = []
        for row in DRIVEMON.snapshot().get("drives", []):
            if row.get("state") != "ok" or row.get("quarantined"):
                tag = row.get("state", "?")
                if row.get("quarantined"):
                    tag += "+quarantined"
                names.append(
                    f"{redacted_endpoint(str(row.get('endpoint', '')))}"
                    f"={tag}")
        cause = ("degraded drives: " + ", ".join(sorted(names)[:6])
                 if names else
                 f"{n:g} drive(s) suspect/faulty/quarantined")
        return True, cause, float(n)


class BackendRule:
    """Kernel dispatch backend collapse: any backend DOWN."""

    name = "kernel_backend_down"
    kind = "event"

    def evaluate(self, ctx: _EvalCtx):
        last = ctx.samples[-1] if ctx.samples else {}
        states = last.get("backendState") or {}
        down = sorted(b for b, v in states.items() if v >= 2)
        if not down:
            return False, "", 0.0
        from .kernprof import KERNPROF
        info = KERNPROF.snapshot().get("backends", {})
        # Only the exception CLASS rides into the cause: the full
        # lastError repr can carry filesystem paths / compiler output,
        # and causes are served on the UNAUTHENTICATED /v2/alerts
        # surface (same policy as DriveRule's redacted drive ids;
        # admin /kernel-health has the verbatim error).
        bits = []
        for b in down:
            err = str(info.get(b, {}).get("lastError") or "down")
            bits.append(f"{b} ({err.split('(', 1)[0].strip() or 'down'})")
        # mtpu-lint: disable=R13 -- hand-sanitized above: only the exception CLASS (split before the first paren) rides into the cause, never the repr body; the taint engine cannot see through the split
        return (True, "kernel backend down: " + ", ".join(bits),
                float(len(down)))


class MrfRule:
    """MRF heal-queue depth growing monotonically: healing is falling
    behind the failure rate, the precursor of redundancy loss."""

    name = "mrf_backlog"
    kind = "event"
    GROW_TICKS = 5     # consecutive samples the depth must not shrink
    MIN_DEPTH = 16     # and the latest depth must reach this

    def evaluate(self, ctx: _EvalCtx):
        tail = [s.get("mrfDepth", 0) or 0
                for s in ctx.samples[-(self.GROW_TICKS + 1):]]
        if len(tail) < self.GROW_TICKS + 1 \
                or tail[-1] < self.MIN_DEPTH:
            return False, "", 0.0
        if not (all(b >= a for a, b in zip(tail, tail[1:]))
                and tail[-1] > tail[0]):
            return False, "", 0.0
        cause = (f"MRF heal backlog growing {tail[0]:g} -> {tail[-1]:g} "
                 f"over {self.GROW_TICKS} samples")
        return True, cause, float(tail[-1])


class RecoveryRule:
    """Durable MRF journal backlog growing monotonically: crash-
    journaled repairs (erasure/mrfjournal.py) are accumulating faster
    than heal retires them — replay after the NEXT crash will re-queue
    an ever-larger debt, and the sweep/journal loop is not converging.
    Extends the in-memory ``mrf_backlog`` pattern to the durable
    queue: the memory rule catches a stalled worker, this one catches
    repairs that keep FAILING (each failed heal keeps its journal
    entry; see MRFQueue._heal)."""

    name = "recovery_backlog"
    kind = "event"
    GROW_TICKS = 5    # consecutive samples the backlog must not shrink
    MIN_DEPTH = 8     # and the latest backlog must reach this

    def evaluate(self, ctx: _EvalCtx):
        tail = [s.get("mrfJournal", 0) or 0
                for s in ctx.samples[-(self.GROW_TICKS + 1):]]
        if len(tail) < self.GROW_TICKS + 1 \
                or tail[-1] < self.MIN_DEPTH:
            return False, "", 0.0
        if not (all(b >= a for a, b in zip(tail, tail[1:]))
                and tail[-1] > tail[0]):
            return False, "", 0.0
        cause = (f"durable MRF journal backlog growing "
                 f"{tail[0]:g} -> {tail[-1]:g} over "
                 f"{self.GROW_TICKS} samples (repairs journaled "
                 "faster than heal retires them)")
        return True, cause, float(tail[-1])


class CacheRule:
    """Hot-cache hit-ratio collapse: a cache that WAS serving (slow
    window healthy) suddenly missing everything — invalidation storm,
    eviction thrash, or a key-space shift the tier can't absorb."""

    name = "cache_collapse"
    kind = "event"
    MIN_LOOKUPS = 20       # fast-window volume floor
    COLLAPSE_RATIO = 0.1   # fast-window hit ratio below this...
    HEALTHY_RATIO = 0.5    # ...while the slow window shows it worked

    def evaluate(self, ctx: _EvalCtx):
        wd = ctx.wd

        def ratio(window_s):
            hits = window_scalar(ctx.samples, "cacheHits", ctx.now,
                                 window_s)
            misses = window_scalar(ctx.samples, "cacheMisses", ctx.now,
                                   window_s)
            total = hits + misses
            return (hits / total if total else None), total

        fast, fast_total = ratio(wd.fast_s)
        slow, _ = ratio(wd.slow_s)
        if (fast is None or slow is None
                or fast_total < self.MIN_LOOKUPS
                or fast >= self.COLLAPSE_RATIO
                or slow < self.HEALTHY_RATIO):
            return False, "", 0.0
        cause = (f"cache hit ratio collapsed to {fast:.2f} "
                 f"(fast {wd.fast_s:g}s) from {slow:.2f} "
                 f"(slow {wd.slow_s:g}s)")
        return True, cause, round(fast, 4)


class ResetRule:
    """Counter-reset storm: the sampler re-based this many deltas in
    the fast window — crash-looping process, racing scrapers, or a
    registry being reset under live traffic."""

    name = "counter_resets"
    kind = "event"
    STORM = 8

    def evaluate(self, ctx: _EvalCtx):
        n = window_scalar(ctx.samples, "resets", ctx.now, ctx.wd.fast_s)
        if n < self.STORM:
            return False, "", 0.0
        return (True, f"{n:g} counter resets in the fast window "
                "(restart/registry-reset storm)", float(n))


class NoisyNeighborRule:
    """Workload-attribution rule (obs/usage.py): ONE bucket or tenant
    carrying more than ``usage noisy_share`` of a QoS class's admitted
    requests — or of its sheds — over BOTH usage windows (fast reacts,
    slow confirms, same two-window discipline as the burn rules),
    while the class is actually SHEDDING and at least one other
    entity shares it (skew without contention, or a class with a
    single tenant, is a workload shape, not an incident).
    The cause names the tenant by its REDACTED identity (stable
    ``_redact_name`` digest — same policy as DriveRule's drive ids,
    because causes are served on the unauthenticated /v2/alerts
    surface); firing freezes the usage snapshot with the verbatim
    names into the incident bundle (obs/incidents.py carries a
    ``usage`` section), which is where the per-class QoS caps or a
    future per-tenant throttle look up who it actually was."""

    name = "noisy_neighbor"
    kind = "event"

    def evaluate(self, ctx: _EvalCtx):
        from .usage import USAGE, _redact_name
        if not USAGE.enabled:
            return False, "", 0.0
        fast = USAGE.class_shares(USAGE.fast_s, ctx.now)
        slow = USAGE.class_shares(USAGE.slow_s, ctx.now)
        share_min = USAGE.noisy_share
        vol_min = USAGE.noisy_min_requests
        worst = None  # (share, cause)
        for cls, fdoc in fast.items():
            sdoc = slow.get(cls) or {}
            # Two gates before any share matters: the class must be
            # SHEDDING in the fast window (a dominant tenant in an
            # uncontended class harms nobody — and healthy one-bucket
            # traffic must never page), and there must be >= 2
            # distinct entities (no neighbor, no noisy neighbor).
            if fdoc.get("shed", 0) <= 0:
                continue
            for key, denom, count_key, what in (
                    ("topBucket", "admitted", "bucketCount",
                     "admitted requests"),
                    ("topTenant", "admitted", "tenantCount",
                     "admitted requests"),
                    ("topShedBucket", "shed", "bucketCount", "sheds"),
                    ("topShedTenant", "shed", "tenantCount", "sheds")):
                f = fdoc.get(key)
                s = sdoc.get(key)
                if (f is None or s is None
                        or f.get("name") != s.get("name")
                        or fdoc.get(count_key, 0) < 2
                        or fdoc.get(denom, 0) < vol_min
                        or f.get("share", 0.0) < share_min
                        or s.get("share", 0.0) < share_min):
                    continue
                kind = "tenant" if "Tenant" in key else "bucket"
                # REDACTED identity, same policy as DriveRule's drive
                # ids: causes are served on the unauthenticated
                # /v2/alerts surface; the incident bundle (admin)
                # freezes the usage snapshot with the verbatim name.
                cause = (f"{kind} {_redact_name(f['name'])!r} carries "
                         f"{f['share']:.2f} of {cls} {what} "
                         f"(fast {USAGE.fast_s:g}s) / "
                         f"{s['share']:.2f} (slow {USAGE.slow_s:g}s)"
                         f" >= {share_min:g}")
                if worst is None or f["share"] >= worst[0]:
                    worst = (f["share"], cause)
        if worst is None:
            return False, "", 0.0
        return True, worst[1], round(worst[0], 4)


class LoopStallRule:
    """Event-loop stall (obs/loopmon.py flight recorder): a heartbeat
    missed by more than ``obs.loop_stall_ms`` produced a stack capture
    naming the frame that held the loop.  Breaches while any capture
    is younger than the recorder's recent window — a ONE-SHOT block
    (e.g. a 400ms faultinject ``loop_block``) still crosses the
    pending_ticks hysteresis on 1s sampler ticks, then resolves once
    the window drains.  The cause NAMES loop and blamed frame, and
    firing freezes the capture ring into the incident bundle
    (obs/incidents.py ``loops`` section)."""

    name = "loop_stall"
    kind = "event"

    def evaluate(self, ctx: _EvalCtx):
        from .loopmon import LOOPMON
        events = LOOPMON.recent_stalls(now=ctx.now)
        if not events:
            return False, "", 0.0
        worst = max(events, key=lambda e: e.get("overdueMs", 0.0))
        cause = (f"loop {worst['loop']} stalled "
                 f"{worst['overdueMs']:.0f}ms in {worst['topFrame']}"
                 + (f" (+{len(events) - 1} more stall(s) in the "
                    "window)" if len(events) > 1 else ""))
        return True, cause, round(float(worst["overdueMs"]), 1)


class ThresholdRule:
    """User-defined threshold over any registered metrics-v2 series
    (config-KV ``alerts rules``): sum of every series of ``metric``
    whose labels are a superset of ``labels``, compared ``op``
    ``value`` — either the current value (gauges/levels) or the rate
    per second over ``window`` (counters), with the same counter-reset
    re-basing discipline as the timeline."""

    kind = "user"

    def __init__(self, doc: dict):
        self.name = doc["name"]
        self.metric = doc["metric"]
        self.labels = dict(doc.get("labels") or {})
        self.mode = doc.get("mode", "value")
        self.op = doc.get("op", ">")
        self.threshold = float(doc["value"])
        self.window_s = float(doc.get("window_s", 60.0))
        self._last: float | None = None
        self._deltas: deque = deque()  # (t, delta)

    def _series_total(self, registry: dict) -> float:
        metric = (registry or {}).get(self.metric) or {}
        total = 0.0
        for s in metric.get("series", []):
            sl = s.get("labels", {})
            if all(sl.get(k) == v for k, v in self.labels.items()):
                total += s.get("value", s.get("count", 0)) or 0
        return total

    def evaluate(self, ctx: _EvalCtx):
        cur = self._series_total(ctx.registry)
        if self.mode == "rate":
            if self._last is None:
                self._last = cur
                return False, "", 0.0
            d = cur - self._last
            if d < 0:      # counter reset: re-base, never negative
                d = cur
            self._last = cur
            self._deltas.append((ctx.now, d))
            lo = ctx.now - self.window_s
            while self._deltas and self._deltas[0][0] <= lo:
                self._deltas.popleft()
            value = sum(d for _, d in self._deltas) / self.window_s
        else:
            value = cur
        breach = value > self.threshold if self.op == ">" \
            else value < self.threshold
        if not breach:
            return False, "", 0.0
        what = "rate/s" if self.mode == "rate" else "value"
        cause = (f"{self.metric}"
                 f"{json.dumps(self.labels) if self.labels else ''} "
                 f"{what} {value:.4g} {self.op} {self.threshold:g}")
        return True, cause, round(value, 4)


def validate_user_rules(raw: str) -> list[dict]:
    """Parse + validate the ``alerts rules`` JSON document; raises
    AlertRuleError (a ValueError, so the config validator rejects the
    write BEFORE it persists). Returns the normalized rule docs."""
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        raise AlertRuleError(f"alerts rules: {e}")
    if not isinstance(doc, list):
        raise AlertRuleError("alerts rules: must be a JSON array")
    from .metrics2 import METRICS2
    registered = METRICS2.registered_names()
    builtin = {name for name, _, _ in BURN_SIGNALS} | {
        DriveRule.name, BackendRule.name, MrfRule.name,
        RecoveryRule.name, CacheRule.name, ResetRule.name,
        NoisyNeighborRule.name, LoopStallRule.name}
    seen: set[str] = set()
    out: list[dict] = []
    for i, r in enumerate(doc):
        if not isinstance(r, dict):
            raise AlertRuleError(f"rule {i}: not an object")
        name = r.get("name")
        if not name or not isinstance(name, str):
            raise AlertRuleError(f"rule {i}: missing name")
        if name in builtin:
            raise AlertRuleError(
                f"rule {i}: {name!r} shadows a built-in rule")
        if name in seen:
            raise AlertRuleError(f"rule {i}: duplicate name {name!r}")
        seen.add(name)
        metric = r.get("metric")
        if metric not in registered:
            raise AlertRuleError(
                f"rule {i}: metric {metric!r} is not registered in "
                "minio_tpu/obs/metrics2.py")
        if r.get("mode", "value") not in ("value", "rate"):
            raise AlertRuleError(
                f"rule {i}: mode must be value|rate")
        if r.get("op", ">") not in (">", "<"):
            raise AlertRuleError(f"rule {i}: op must be > or <")
        labels = r.get("labels") or {}
        if not isinstance(labels, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in labels.items()):
            raise AlertRuleError(
                f"rule {i}: labels must map strings to strings")
        try:
            value = float(r["value"])
            window_s = float(r.get("window_s", 60.0))
        except (KeyError, TypeError, ValueError):
            raise AlertRuleError(
                f"rule {i}: numeric value (and optional window_s) "
                "required")
        if window_s <= 0:
            raise AlertRuleError(f"rule {i}: window_s must be positive")
        unknown = set(r) - {"name", "metric", "labels", "mode", "op",
                            "value", "window_s"}
        if unknown:
            raise AlertRuleError(
                f"rule {i}: unknown fields {sorted(unknown)}")
        out.append({"name": name, "metric": metric, "labels": labels,
                    "mode": r.get("mode", "value"),
                    "op": r.get("op", ">"), "value": value,
                    "window_s": window_s})
    return out


# -- webhook delivery -------------------------------------------------------


class AlertWebhook:
    """Bounded queue + worker POSTing alert transition JSON to the
    configured target.  Delivery is async and lossy-on-overflow (the
    watchdog tick never blocks on the sink), and each item gets a
    BOUNDED retry with exponential backoff — an unreachable endpoint
    costs RETRIES posts per alert, never a retry storm (lint R6)."""

    QUEUE_MAX = 256
    RETRIES = 3
    BACKOFF_S = 0.25

    def __init__(self, endpoint: str, auth_token: str = "",
                 queue_size: int | None = None):
        self.endpoint = endpoint
        self.auth_token = auth_token
        self._q: queue.Queue = queue.Queue(
            maxsize=queue_size or self.QUEUE_MAX)
        self._closed = False
        self._stats_mu = threading.Lock()
        self.sent = 0
        self.failed = 0
        self.dropped = 0
        # mtpu-lint: disable=R1 -- alert delivery daemon: transitions from many sampler ticks share one worker
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="alert-webhook")
        self._worker.start()

    def send(self, doc: dict) -> None:
        if self._closed:
            return
        try:
            self._q.put_nowait(doc)
        except queue.Full:
            with self._stats_mu:
                self.dropped += 1
            from .metrics2 import METRICS2
            METRICS2.inc("minio_tpu_v2_alert_webhook_total",
                         {"result": "dropped"})

    def _run(self) -> None:
        from .metrics2 import METRICS2
        while True:
            item = self._q.get()
            if item is None and not self._closed:
                return
            if self._closed:
                # Replaced mid-incident (endpoint/token rotate): stop
                # delivering, but every queued alert that will never
                # be posted COUNTS as dropped — sent+failed+dropped
                # must keep summing to submissions, and notifications
                # must not vanish without a metric trace. Drain
                # without blocking, then exit (no thread parked on
                # get() forever).
                drops = 0 if item is None else 1
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is not None:
                        drops += 1
                if drops:
                    with self._stats_mu:
                        self.dropped += drops
                    METRICS2.inc("minio_tpu_v2_alert_webhook_total",
                                 {"result": "dropped"}, drops)
                return
            delivered = False
            for attempt in range(self.RETRIES):  # bounded (R6)
                try:
                    req = urllib.request.Request(
                        self.endpoint, data=json.dumps(item).encode(),
                        headers={"Content-Type": "application/json",
                                 **({"Authorization":
                                     f"Bearer {self.auth_token}"}
                                    if self.auth_token else {})})
                    urllib.request.urlopen(req, timeout=5).read()
                    delivered = True
                    break
                except Exception:  # noqa: BLE001 - endpoint's problem
                    if attempt + 1 < self.RETRIES:
                        time.sleep(self.BACKOFF_S * (2 ** attempt))
            with self._stats_mu:
                if delivered:
                    self.sent += 1
                else:
                    self.failed += 1
            METRICS2.inc("minio_tpu_v2_alert_webhook_total",
                         {"result": "sent" if delivered else "failed"})

    def stats(self) -> dict:
        # No endpoint here: this rides the UNAUTHENTICATED /v2/alerts
        # snapshot, and webhook URLs can embed credentials — the
        # admin-only config dump is where the target lives.
        with self._stats_mu:
            return {"sent": self.sent, "failed": self.failed,
                    "dropped": self.dropped,
                    "queued": self._q.qsize()}

    def close(self) -> None:
        self._closed = True  # checked per item; wake via sentinel
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # worker exits at its next item via the flag


# -- the engine -------------------------------------------------------------


class _Alert:
    __slots__ = ("rule", "state", "alert_id", "breach_streak",
                 "clear_streak", "since", "fired_at", "cause", "value")

    def __init__(self, rule: str):
        self.rule = rule
        self.state = OK
        self.alert_id = ""
        self.breach_streak = 0
        self.clear_streak = 0
        self.since = 0.0
        self.fired_at = 0.0
        self.cause = ""
        self.value = 0.0


class Watchdog:
    """Process-wide alert engine (singleton ``WATCHDOG``), ticked by
    the timeline sampler."""

    # Minimum fast-window request volume per class before a burn
    # fraction is meaningful.
    MIN_REQUESTS = 5
    # Resolved episodes stay visible on the snapshot this long.
    RESOLVED_KEEP_S = 600.0

    def __init__(self):
        self.enabled = True
        self._mu = threading.Lock()
        self.fast_s = 60.0
        self.slow_s = 900.0
        self.burn_threshold = 0.10
        self.pending_ticks = 2
        self.resolve_ticks = 3
        self._user_docs: list[dict] = []
        self._rules: dict[str, object] = self._build_rules(())
        self._alerts: dict[str, _Alert] = {}
        self._recent: deque = deque(maxlen=32)  # resolved episodes
        self._webhook: AlertWebhook | None = None
        self._seq = 0
        # Firing transitions since the last reset() — the bench's
        # per-config ``alerts_fired`` tripwire.
        self.fired_total = 0

    @staticmethod
    def _build_rules(user_docs) -> dict[str, object]:
        rules: dict[str, object] = {}
        for name, key, what in BURN_SIGNALS:
            rules[name] = BurnRule(name, key, what)
        for r in (DriveRule(), BackendRule(), MrfRule(),
                  RecoveryRule(), CacheRule(), ResetRule(),
                  NoisyNeighborRule(), LoopStallRule()):
            rules[r.name] = r
        for doc in user_docs:
            r = ThresholdRule(doc)
            rules[r.name] = r
        return rules

    # -- configuration (config-KV ``alerts`` apply hook) ---------------

    def configure(self, enable: bool = True, fast_s: float = 60.0,
                  slow_s: float = 900.0, burn_threshold: float = 0.10,
                  pending_ticks: int = 2, resolve_ticks: int = 3,
                  user_rules=(), webhook_endpoint: str = "",
                  webhook_auth_token: str = "") -> None:
        with self._mu:
            self.enabled = bool(enable)
            self.fast_s = max(1.0, float(fast_s))
            self.slow_s = max(self.fast_s, float(slow_s))
            self.burn_threshold = min(1.0, max(1e-6,
                                               float(burn_threshold)))
            self.pending_ticks = max(1, int(pending_ticks))
            self.resolve_ticks = max(1, int(resolve_ticks))
            self._user_docs = list(user_rules)
            self._rules = self._build_rules(self._user_docs)
            # Alert state for rules that no longer exist dies with
            # them — but the firing gauge must not: it is only ever
            # written on transitions, so a deleted-while-firing rule
            # would read 1 on /v2/metrics forever.
            dropped = [k for k in self._alerts if k not in self._rules]
            self._alerts = {k: v for k, v in self._alerts.items()
                            if k in self._rules}
            wh = self._webhook
        if dropped:
            from .metrics2 import METRICS2
            for name in dropped:
                METRICS2.set_gauge("minio_tpu_v2_alerts_firing",
                                   {"rule": name}, 0)
        # Webhook lifecycle OUTSIDE the engine lock: close() touches
        # the queue and a swap must never block an evaluation tick.
        if webhook_endpoint:
            if (wh is None or wh.endpoint != webhook_endpoint
                    or wh.auth_token != webhook_auth_token):
                if wh is not None:
                    wh.close()
                self._webhook = AlertWebhook(webhook_endpoint,
                                             webhook_auth_token)
        elif wh is not None:
            wh.close()
            self._webhook = None

    # -- evaluation ----------------------------------------------------

    def tick(self, now: float | None = None,
             samples: list[dict] | None = None) -> list[dict]:
        """One evaluation pass (sampler thread; tests pass synthetic
        samples).  Returns the transitions it announced."""
        if not self.enabled:
            return []
        now = time.time() if now is None else now
        if samples is None:
            from .timeline import TIMELINE
            samples = TIMELINE.samples()
        with self._mu:
            rules = list(self._rules.values())
        registry = None
        if any(getattr(r, "kind", "") == "user" for r in rules):
            from .metrics2 import METRICS2
            registry = METRICS2.snapshot()
        ctx = _EvalCtx(samples, now, self, registry)
        results = []
        for r in rules:
            try:
                results.append((r.name, *r.evaluate(ctx)))
            except Exception:  # noqa: BLE001 - one bad rule must not kill the tick
                from ..logger import Logger
                Logger.get().log_once(
                    f"watchdog: rule {r.name} evaluation failed",
                    "watchdog")
        transitions: list[dict] = []
        with self._mu:
            for name, breach, cause, value in results:
                transitions.extend(
                    self._advance(name, breach, cause, value, now))
        for tr in transitions:
            self._announce(tr)
        return transitions

    # -- lifecycle state machine (caller holds self._mu) ---------------

    def _advance(self, name: str, breach: bool, cause: str,
                 value: float, now: float) -> list[dict]:
        a = self._alerts.get(name)
        if a is None:
            a = self._alerts[name] = _Alert(name)
        out: list[dict] = []

        def tr(old: str, new: str) -> dict:
            return {"rule": name, "alertId": a.alert_id, "old": old,
                    "new": new, "cause": a.cause, "value": a.value,
                    "at": now}

        if breach:
            a.clear_streak = 0
            a.cause, a.value = cause, value
            if a.state == OK:
                self._seq += 1
                a.alert_id = f"{name}-{self._seq}"
                a.state = PENDING
                a.since = now
                a.breach_streak = 1
                out.append(tr(OK, PENDING))
            elif a.state == PENDING:
                a.breach_streak += 1
            if a.state == PENDING \
                    and a.breach_streak >= self.pending_ticks:
                a.state = FIRING
                a.fired_at = now
                self.fired_total += 1
                out.append(tr(PENDING, FIRING))
        else:
            if a.state == PENDING:
                # Cleared below the hysteresis bar: the episode ends
                # quietly — a sub-threshold flap must not page or log.
                a.state = OK
                a.breach_streak = 0
                a.alert_id = ""
            elif a.state == FIRING:
                a.clear_streak += 1
                if a.clear_streak >= self.resolve_ticks:
                    out.append(tr(FIRING, "resolved"))
                    self._recent.append({
                        "rule": name, "alertId": a.alert_id,
                        "cause": a.cause, "value": a.value,
                        "firedAt": a.fired_at, "resolvedAt": now})
                    a.state = OK
                    a.breach_streak = 0
                    a.clear_streak = 0
                    a.alert_id = ""
        return out

    # -- transition fan-out (outside the engine lock) ------------------

    def _announce(self, tr: dict) -> None:
        from ..logger import Logger
        from .metrics2 import METRICS2
        from .span import current_span
        line = (f"watchdog: alert {tr['rule']} {tr['old']} -> "
                f"{tr['new']} ({tr['cause']})")
        log = Logger.get()
        # Join keys ride as structured fields so the JSON log mode
        # correlates alert lines the way audit entries carry trace_id.
        if tr["new"] == FIRING:
            log.warn(line, "watchdog", alert_id=tr["alertId"],
                     rule=tr["rule"])
        else:
            log.info(line, "watchdog", alert_id=tr["alertId"],
                     rule=tr["rule"])
        METRICS2.set_gauge("minio_tpu_v2_alerts_firing",
                           {"rule": tr["rule"]},
                           1 if tr["new"] == FIRING else 0)
        METRICS2.inc("minio_tpu_v2_alert_transitions_total",
                     {"rule": tr["rule"], "state": tr["new"]})
        span = current_span()
        if span is not None:
            span.add_event("alert", rule=tr["rule"],
                           alert_id=tr["alertId"], old=tr["old"],
                           new=tr["new"], cause=tr["cause"][:256])
        # Capture BEFORE the webhook post so the payload can carry the
        # bundle id: an external pager needs the join key to link a
        # firing alert to its frozen diagnosis (admin /incidents).
        if tr["new"] == FIRING:
            from .incidents import INCIDENTS
            try:
                bundle = INCIDENTS.capture(tr)
                tr["bundleId"] = bundle.get("id", "")
            except Exception:  # noqa: BLE001 - diagnosis must not break alerting
                Logger.get().log_once(
                    f"watchdog: incident capture failed for "
                    f"{tr['rule']}", "watchdog")
        elif tr["new"] == "resolved" and tr.get("alertId"):
            # The bundle frozen at firing is keyed by the alert id —
            # the resolve notification joins to the same bundle.
            tr["bundleId"] = tr["alertId"]
        wh = self._webhook
        if wh is not None and tr["new"] in (FIRING, "resolved"):
            wh.send(dict(tr, node="local"))

    # -- reads ---------------------------------------------------------

    def state_of(self, rule: str) -> str:
        a = self._alerts.get(rule)
        return a.state if a is not None else OK

    def counts(self) -> tuple[int, int, str]:
        """(firing, pending, worst firing rule) — the timeline's
        per-sample alerts census."""
        with self._mu:
            firing = pending = 0
            worst, worst_v = "", -1.0
            for a in self._alerts.values():
                if a.state == FIRING:
                    firing += 1
                    if a.value >= worst_v:
                        worst, worst_v = a.rule, a.value
                elif a.state == PENDING:
                    pending += 1
            return firing, pending, worst

    def snapshot(self) -> dict:
        """JSON-ready node view (`/minio-tpu/v2/alerts`; the cluster
        endpoint fan-in merges these via merge_alerts)."""
        now = time.time()
        with self._mu:
            active = []
            for name in sorted(self._alerts):
                a = self._alerts[name]
                if a.state == OK:
                    continue
                active.append({"rule": a.rule, "state": a.state,
                               "alertId": a.alert_id,
                               "since": a.since,
                               "firedAt": a.fired_at,
                               "cause": a.cause, "value": a.value})
            resolved = [dict(ep) for ep in self._recent
                        if now - ep["resolvedAt"]
                        <= self.RESOLVED_KEEP_S]
            doc = {
                "enabled": self.enabled,
                "alerts": active,
                "resolved": resolved,
                "firing": sum(1 for x in active
                              if x["state"] == FIRING),
                "pending": sum(1 for x in active
                               if x["state"] == PENDING),
                "rules": sorted(self._rules),
                "windows": {"fastS": self.fast_s,
                            "slowS": self.slow_s,
                            "burnThreshold": self.burn_threshold},
            }
            wh = self._webhook
        if wh is not None:
            doc["webhook"] = wh.stats()
        return doc

    def reset(self) -> None:
        """Clear alert state + episode counters; configuration (and
        the webhook) survive — bench calls this per config attempt."""
        with self._mu:
            stale = [a.rule for a in self._alerts.values()
                     if a.state != OK]
            self._alerts.clear()
            self._recent.clear()
            self.fired_total = 0
            # User rules carry rate history; rebuild for a clean slate.
            self._rules = self._build_rules(self._user_docs)
        # The firing gauge is transition-written; discarded episodes
        # must not leave it stuck at 1.
        if stale:
            from .metrics2 import METRICS2
            for name in stale:
                METRICS2.set_gauge("minio_tpu_v2_alerts_firing",
                                   {"rule": name}, 0)


def merge_alerts(named_snaps: list[tuple[str, dict]]) -> dict:
    """Merge per-node alert snapshots into one cluster view: one row
    per rule, worst state across nodes, the count of nodes firing it,
    and the worst cause — with an HONEST ``nodes`` count (only nodes
    that actually answered; the endpoint reports unreachable peers
    separately, so a lost node never reads as 'no alerts')."""
    rules: dict[str, dict] = {}
    for node, snap in named_snaps:
        for a in snap.get("alerts", []):
            cur = rules.setdefault(a["rule"], {
                "rule": a["rule"], "state": OK, "nodes": [],
                "nodesFiring": 0, "cause": "", "value": 0.0})
            if _STATE_RANK.get(a.get("state", OK), 0) > \
                    _STATE_RANK.get(cur["state"], 0):
                cur["state"] = a["state"]
            if a.get("state") == FIRING:
                cur["nodesFiring"] += 1
            cur["nodes"].append(node)
            if not cur["cause"] or a.get("value", 0) >= cur["value"]:
                cur["cause"] = a.get("cause", "")
                cur["value"] = a.get("value", 0)
    alerts = [rules[k] for k in sorted(rules)]
    return {"nodes": len(named_snaps),
            "alerts": alerts,
            "firing": sum(1 for a in alerts if a["state"] == FIRING),
            "pending": sum(1 for a in alerts
                           if a["state"] == PENDING)}


# The process-wide watchdog the timeline sampler ticks.
WATCHDOG = Watchdog()
