"""Tenant & workload attribution: who is the traffic?

The signal planes built so far answer *what* is slow (spans, slowlog
blame), *which component* is failing (drivemon, kernprof) and *when*
SLOs burn (watchdog) — but nothing attributes load to a bucket, an
access key, an object key or a client.  That is the first question an
operator asks when a shared deployment browns out, and the reference
ships exactly this surface (the data-usage census, ``mc admin top``,
per-bucket bandwidth).  The workload reality motivating it is the same
Zipfian skew behind the ``hot_get`` bench and the hot-data placement
literature (Pertin et al., arXiv:1504.07038): a handful of tenants and
keys carry most of the bytes, and the plane that names them must cost
O(K), not O(keyspace).

Two tiers, both fixed-memory, fed from ``S3Server._finish_request``
(both front doors share that core):

- **Exact rolling accounts** per bucket and per access key over a
  fast and a slow window (requests, rx/tx bytes, error and shed
  counts), kept in a ring of coarse time slots.  Cardinality is
  bounded: past ``cardinality_cap`` distinct names per slot, new names
  fold into ``_other`` and the fold is counted — the same guard the
  metrics2 registry applies to the ``usage_*`` label values.

- **Space-bounded heavy-hitter sketches** (SpaceSaving top-K with a
  count-min backing on deterministic seeds) over object keys and
  client addresses, one per QoS class, so "which 10 keys are 80% of
  GET traffic" is answerable at O(K) memory regardless of keyspace.
  Sketches MERGE across peers: absent keys substitute the peer's
  count-min estimate (clamped by its SpaceSaving floor), so the merged
  count error stays <= N/K.

Surfaces: ``/minio-tpu/v2/usage`` (node) + ``/usage/cluster`` (peer
RPC fan-in, honest node counts), admin ``/top`` (full detail, joined
with the crawler's stored-bytes census and worst-request trace-id
exemplars that resolve in the slowlog), ``usage_*`` metrics2
series, per-class top-bucket shares in every timeline sample, a
``tenants:`` row in ``tools/mtpu_top.py``, and the watchdog's
``noisy_neighbor`` built-in rule (obs/watchdog.py), which turns
attribution into the input the QoS caps act on.

Unauthenticated surfaces redact access keys and client addresses the
way drivemon redacts drive endpoints; admin ``/top`` is root-only and
serves them whole.

The port's own copy of ``minio_tpu/obs/usage.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque

# Account array layout (one list per bucket/tenant per slot).
_REQ, _RX, _TX, _ERR, _SHED = range(5)

OTHER = "_other"

# Count-min geometry: depth rows sliced out of ONE blake2b digest per
# key, so a sketch offer costs a single short hash.  Width is a power
# of two (the digest slices index by mask).
CM_DEPTH = 4
CM_WIDTH = 512

def claimed_access_key(auth_header: str,
                       params: dict | None = None) -> str:
    """The access key the request CLAIMS (SigV4 `Credential=AK/...`,
    legacy `AWS AK:sig`, or a presigned URL's `X-Amz-Credential`
    query parameter), for attribution of requests that never reached
    authentication — admission sheds happen before SigV4
    verification, and a noisy tenant's sheds are exactly the signal
    that must not degrade to anonymous.  Attribution-only: nothing
    trusts this value, and the cardinality cap bounds what a spoofer
    can pollute."""
    if auth_header:
        i = auth_header.find("Credential=")
        if i >= 0:
            return auth_header[i + len("Credential="):].split("/",
                                                              1)[0]
        if auth_header.startswith("AWS "):
            return auth_header[4:].split(":", 1)[0]
    if params:
        cred = params.get("X-Amz-Credential", "")
        if cred:
            return cred.split("/", 1)[0]
    return ""


def _digest_indices(key: str) -> list[int]:
    """CM_DEPTH deterministic row indices for one key — same on every
    node (seedless digest), which is what makes sketches merge-able."""
    d = hashlib.blake2b(key.encode("utf-8", "replace"),
                        digest_size=2 * CM_DEPTH).digest()
    return [int.from_bytes(d[2 * i:2 * i + 2], "big") % CM_WIDTH
            for i in range(CM_DEPTH)]


class TopKSketch:
    """SpaceSaving top-K with a count-min backing.

    SpaceSaving keeps exactly ``k`` counters; the canonical guarantees
    hold per node: every key with true count > N/k is tracked, and a
    tracked key's count overestimates its true count by at most its
    recorded ``err`` (<= N/k).  The count-min rows (deterministic
    seeds, element-wise merge-able) refine CROSS-NODE estimates for
    keys one node tracked and another did not."""

    def __init__(self, k: int = 10):
        self.k = max(1, int(k))
        self.total = 0
        self._counters: dict[str, list] = {}   # key -> [count, err]
        self._cm = [[0] * CM_WIDTH for _ in range(CM_DEPTH)]

    def offer(self, key: str, weight: int = 1) -> None:
        self.total += weight
        for row, idx in zip(self._cm, _digest_indices(key)):
            row[idx] += weight
        c = self._counters.get(key)
        if c is not None:
            c[0] += weight
            return
        if len(self._counters) < self.k:
            self._counters[key] = [weight, 0]
            return
        # Evict the minimum counter; the newcomer inherits its count
        # as both floor and error (the SpaceSaving replacement rule).
        mk = min(self._counters, key=lambda x: self._counters[x][0])
        mc = self._counters.pop(mk)[0]
        self._counters[key] = [mc + weight, mc]

    def cm_estimate(self, key: str) -> int:
        return min(row[idx] for row, idx
                   in zip(self._cm, _digest_indices(key)))

    def min_count(self) -> int:
        """The SpaceSaving floor: an UNtracked key's true count cannot
        exceed this (else it would have displaced the minimum)."""
        if len(self._counters) < self.k:
            return 0
        return min(c[0] for c in self._counters.values())

    def top(self, n: int | None = None) -> list[dict]:
        rows = sorted(((key, c[0], c[1])
                       for key, c in self._counters.items()),
                      key=lambda r: (-r[1], r[0]))
        total = self.total or 1
        return [{"key": key, "count": count, "err": err,
                 "share": round(count / total, 4)}
                for key, count, err in rows[:n or self.k]]

    def snapshot(self) -> dict:
        return {"k": self.k, "total": self.total,
                "counters": self.top(self.k),
                "cm": [list(row) for row in self._cm]}


def merge_topk(snapshots: list[dict], k: int | None = None) -> dict:
    """Merge per-node sketch snapshots into one cluster top-K.

    Candidates are the union of every node's tracked keys.  A node
    that tracked the key contributes its SpaceSaving count (err rides
    along); a node that did not contributes min(count-min estimate,
    SpaceSaving floor) — both are overestimates of the true count and
    the floor is <= N_node/k, so the merged count error stays
    <= sum(N_node)/k = N/k."""
    snaps = [s for s in snapshots if isinstance(s, dict)]
    if not snaps:
        return {"k": k or 0, "total": 0, "counters": [], "cm": []}
    k = k or max(s.get("k", 0) for s in snaps) or 1
    total = sum(s.get("total", 0) for s in snaps)
    candidates: set[str] = set()
    for s in snaps:
        candidates.update(c["key"] for c in s.get("counters", []))
    merged: list[tuple[str, int, int]] = []
    for key in candidates:
        count = err = 0
        idx = _digest_indices(key)
        for s in snaps:
            tracked = {c["key"]: c for c in s.get("counters", [])}
            hit = tracked.get(key)
            if hit is not None:
                count += hit["count"]
                err += hit.get("err", 0)
                continue
            if len(tracked) < s.get("k", 1):
                # A not-full SpaceSaving sketch tracks EVERY key the
                # node saw: absent means true count 0 — substituting
                # the (collision-inflated) cm estimate here would add
                # phantom counts and break the <= N/k bound.
                continue
            floor = min(c["count"] for c in tracked.values())
            cm = s.get("cm") or []
            if cm:
                floor = min(floor,
                            min(row[i] for row, i in zip(cm, idx)))
            count += floor
            err += floor
        merged.append((key, count, err))
    merged.sort(key=lambda r: (-r[1], r[0]))
    out_total = total or 1
    cm_rows: list[list[int]] = []
    for s in snaps:
        for i, row in enumerate(s.get("cm") or []):
            if i >= len(cm_rows):
                cm_rows.append(list(row))
            else:
                cm_rows[i] = [a + b for a, b in zip(cm_rows[i], row)]
    return {"k": k, "total": total,
            "counters": [{"key": key, "count": count, "err": err,
                          "share": round(count / out_total, 4)}
                         for key, count, err in merged[:k]],
            "cm": cm_rows}


class _Slot:
    """One coarse time window of exact accounts."""

    __slots__ = ("t0", "buckets", "tenants", "classes", "worst")

    def __init__(self, t0: float):
        self.t0 = t0
        self.buckets: dict[str, list] = {}
        self.tenants: dict[str, list] = {}
        # class -> prefixed name ("b:<bucket>" / "t:<tenant>") ->
        # [admitted, shed] — the noisy-neighbor numerators.
        self.classes: dict[str, dict[str, list]] = {}
        # bucket -> (duration_ms, trace_id): the window's worst
        # request per bucket, admin /top's slowlog join key.
        self.worst: dict[str, tuple] = {}


class UsageAccountant:
    """Process-wide attribution plane (singleton ``USAGE``)."""

    def __init__(self):
        self.enabled = True
        self._mu = threading.Lock()
        self.top_k = 10
        self.cardinality_cap = 64
        self.fast_s = 60.0
        self.slow_s = 900.0
        # noisy_neighbor thresholds (read by the watchdog rule).
        self.noisy_share = 0.5
        self.noisy_min_requests = 20
        self.folded_total = 0
        self._gran = 5.0
        self._slots: deque = deque()
        self._sketches: dict[tuple[str, str], TopKSketch] = {}
        self._totals = [0, 0, 0, 0, 0]

    # -- configuration (config-KV ``usage`` apply hook) -----------------

    def configure(self, enable: bool = True, top_k: int = 10,
                  cardinality_cap: int = 64, fast_s: float = 60.0,
                  slow_s: float = 900.0, noisy_share: float = 0.5,
                  noisy_min_requests: int = 20) -> None:
        with self._mu:
            self.enabled = bool(enable)
            rebuild = int(top_k) != self.top_k
            self.top_k = max(1, int(top_k))
            self.cardinality_cap = max(1, int(cardinality_cap))
            self.fast_s = max(0.25, float(fast_s))
            self.slow_s = max(self.fast_s, float(slow_s))
            self.noisy_share = min(1.0, max(1e-6, float(noisy_share)))
            self.noisy_min_requests = max(1, int(noisy_min_requests))
            # Slot granularity scales with the fast window so short
            # test/bench windows still resolve; the ring stays bounded
            # at ~(slow/gran) slots regardless of config.
            self._gran = min(5.0, max(0.25, self.fast_s / 4.0))
            if rebuild:
                self._sketches = {}
        # The usage_* label guard follows the SAME cap (metrics2
        # folds what this plane folds).
        from .metrics2 import METRICS2
        for name, label in (
                ("minio_tpu_v2_usage_requests_total", "bucket"),
                ("minio_tpu_v2_usage_rx_bytes_total", "bucket"),
                ("minio_tpu_v2_usage_tx_bytes_total", "bucket"),
                ("minio_tpu_v2_usage_errors_total", "bucket"),
                ("minio_tpu_v2_usage_shed_total", "bucket"),
                ("minio_tpu_v2_usage_tenant_requests_total", "tenant")):
            METRICS2.set_label_cap(name, label, self.cardinality_cap)

    # -- recording (one call per finished S3 request) -------------------

    def _slot(self, now: float) -> _Slot:
        """Current slot, rotating the ring (caller holds the lock)."""
        t0 = int(now / self._gran) * self._gran
        if not self._slots or self._slots[-1].t0 < t0:
            self._slots.append(_Slot(t0))
            lo = now - self.slow_s - self._gran
            while self._slots and self._slots[0].t0 < lo:
                self._slots.popleft()
        return self._slots[-1]

    def _fold(self, table: dict, name: str) -> str:
        if name in table or len(table) < self.cardinality_cap:
            return name
        self.folded_total += 1
        return OTHER

    def record(self, *, bucket: str, access_key: str, qos_class: str,
               rx: int, tx: int, status: int, shed: bool,
               key: str = "", client: str = "",
               duration_ms: float = 0.0, trace_id: str = "",
               now: float | None = None) -> None:
        if not self.enabled:
            return
        now = time.time() if now is None else now
        bucket = bucket or "-"
        tenant = access_key or "-"
        cls = qos_class or "read"
        err = status >= 500 and not shed
        with self._mu:
            slot = self._slot(now)
            bname = self._fold(slot.buckets, bucket)
            tname = self._fold(slot.tenants, tenant)
            for table, name in ((slot.buckets, bname),
                                (slot.tenants, tname)):
                row = table.get(name)
                if row is None:
                    row = table[name] = [0, 0, 0, 0, 0]
                row[_REQ] += 1
                row[_RX] += rx
                row[_TX] += tx
                if err:
                    row[_ERR] += 1
                if shed:
                    row[_SHED] += 1
            ctab = slot.classes.setdefault(cls, {})
            # bname/tname are post-fold, so this table is bounded at
            # 2 * cardinality_cap (+2 folds) entries by construction.
            for pref, name in (("b:", bname), ("t:", tname)):
                crow = ctab.get(pref + name)
                if crow is None:
                    crow = ctab[pref + name] = [0, 0]
                crow[0 if not shed else 1] += 1
            if trace_id and bname != OTHER:
                w = slot.worst.get(bname)
                if w is None or duration_ms > w[0]:
                    slot.worst[bname] = (duration_ms, trace_id)
            self._totals[_REQ] += 1
            self._totals[_RX] += rx
            self._totals[_TX] += tx
            if err:
                self._totals[_ERR] += 1
            if shed:
                self._totals[_SHED] += 1
            if key:
                sk = self._sketch("key", cls)
                sk.offer(f"{bucket}/{key}")
            if client:
                self._sketch("client", cls).offer(client)
        from .metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_usage_requests_total",
                     {"bucket": bucket, "class": cls})
        # Tenant label REDACTED: the whole registry renders on the
        # unauthenticated /v2/metrics/node page, and raw access-key
        # ids must not be enumerable there (same policy as the /usage
        # endpoint; admin /top has the real names).
        METRICS2.inc("minio_tpu_v2_usage_tenant_requests_total",
                     {"tenant": _redact_name(tenant), "class": cls})
        if rx:
            METRICS2.inc("minio_tpu_v2_usage_rx_bytes_total",
                         {"bucket": bucket}, rx)
        if tx:
            METRICS2.inc("minio_tpu_v2_usage_tx_bytes_total",
                         {"bucket": bucket}, tx)
        if err:
            METRICS2.inc("minio_tpu_v2_usage_errors_total",
                         {"bucket": bucket})
        if shed:
            METRICS2.inc("minio_tpu_v2_usage_shed_total",
                         {"bucket": bucket})

    def _sketch(self, dim: str, cls: str) -> TopKSketch:
        sk = self._sketches.get((dim, cls))
        if sk is None:
            sk = self._sketches[(dim, cls)] = TopKSketch(self.top_k)
        return sk

    # -- window reads ---------------------------------------------------

    def _window_slots(self, window_s: float,
                      now: float) -> list[_Slot]:
        lo = now - window_s
        # A slot straddling the window edge counts whole: exactness at
        # slot granularity, the documented resolution of the accounts.
        return [s for s in self._slots if s.t0 + self._gran > lo
                and s.t0 <= now]

    def window_accounts(self, kind: str, window_s: float,
                        now: float | None = None) -> dict[str, dict]:
        """{name: {requests, rxBytes, txBytes, errors, shed}} for
        ``kind`` in ("buckets", "tenants") over the trailing window."""
        now = time.time() if now is None else now
        out: dict[str, list] = {}
        with self._mu:
            for slot in self._window_slots(window_s, now):
                for name, row in getattr(slot, kind).items():
                    acc = out.get(name)
                    if acc is None:
                        acc = out[name] = [0, 0, 0, 0, 0]
                    for i in range(5):
                        acc[i] += row[i]
        return {name: {"requests": a[_REQ], "rxBytes": a[_RX],
                       "txBytes": a[_TX], "errors": a[_ERR],
                       "shed": a[_SHED]}
                for name, a in out.items()}

    def class_shares(self, window_s: float,
                     now: float | None = None) -> dict[str, dict]:
        """Per QoS class over the window: total admitted/shed counts
        and the top bucket/tenant by each — the noisy-neighbor
        numerators.  ``_other`` never tops (a fold is not a tenant)."""
        now = time.time() if now is None else now
        agg: dict[str, dict[str, list]] = {}
        with self._mu:
            for slot in self._window_slots(window_s, now):
                for cls, tab in slot.classes.items():
                    cagg = agg.setdefault(cls, {})
                    for name, row in tab.items():
                        cur = cagg.get(name)
                        if cur is None:
                            cur = cagg[name] = [0, 0]
                        cur[0] += row[0]
                        cur[1] += row[1]
        out: dict[str, dict] = {}
        for cls, tab in agg.items():
            doc: dict = {"admitted": 0, "shed": 0}
            for pref, akey, skey in (("b:", "topBucket", "topShedBucket"),
                                     ("t:", "topTenant", "topShedTenant")):
                rows = [(name[len(pref):], row) for name, row
                        in tab.items() if name.startswith(pref)]
                adm = sum(r[0] for _, r in rows)
                shed = sum(r[1] for _, r in rows)
                if pref == "b:":
                    doc["admitted"], doc["shed"] = adm, shed
                # Distinct entities of this kind (a fold into _other
                # proves there were more): the noisy_neighbor rule
                # needs a NEIGHBOR before a dominant share means harm.
                # "-" (anonymous / bucket-less service requests) is
                # not an entity — counting it would let a genuinely
                # single-tenant box satisfy the >=2 gate.
                doc["bucketCount" if pref == "b:"
                    else "tenantCount"] = sum(
                    1 for n, _ in rows if n != "-")
                # _other (a fold) and "-" (anonymous / no credential)
                # are not NAMEABLE entities — a top rank must name
                # someone an operator can act on.
                named = [(n, r) for n, r in rows
                         if n not in (OTHER, "-")]
                if named and adm:
                    top = max(named, key=lambda x: x[1][0])
                    if top[1][0]:
                        doc[akey] = {"name": top[0],
                                     "count": top[1][0],
                                     "share": round(top[1][0] / adm, 4)}
                if named and shed:
                    stop = max(named, key=lambda x: x[1][1])
                    if stop[1][1]:
                        doc[skey] = {"name": stop[0],
                                     "count": stop[1][1],
                                     "share": round(stop[1][1] / shed,
                                                    4)}
            out[cls] = doc
        return out

    def class_top_shares(self, now: float | None = None) -> dict:
        """The timeline's per-sample census: {class: {name, share,
        kind}} for the fast window's top bucket per class."""
        out: dict = {}
        for cls, doc in self.class_shares(self.fast_s, now).items():
            top = doc.get("topBucket")
            if top is not None:
                out[cls] = {"kind": "bucket", "name": top["name"],
                            "share": top["share"]}
        return out

    # -- views ----------------------------------------------------------

    def snapshot(self) -> dict:
        now = time.time()
        with self._mu:
            sketches: dict[str, dict] = {}
            for (dim, cls), sk in self._sketches.items():
                sketches.setdefault(dim, {})[cls] = sk.snapshot()
            totals = list(self._totals)
            folded = self.folded_total
        return {
            "enabled": self.enabled,
            "nodes": 1,
            "topK": self.top_k,
            "cardinalityCap": self.cardinality_cap,
            "windows": {"fastS": self.fast_s, "slowS": self.slow_s},
            "totals": {"requests": totals[_REQ], "rxBytes": totals[_RX],
                       "txBytes": totals[_TX], "errors": totals[_ERR],
                       "shed": totals[_SHED]},
            "folded": folded,
            "buckets": {
                "fast": self.window_accounts("buckets", self.fast_s,
                                             now),
                "slow": self.window_accounts("buckets", self.slow_s,
                                             now)},
            "tenants": {
                "fast": self.window_accounts("tenants", self.fast_s,
                                             now),
                "slow": self.window_accounts("tenants", self.slow_s,
                                             now)},
            "classes": self.class_shares(self.fast_s, now),
            "sketches": sketches,
        }

    def top(self, n: int | None = None) -> dict:
        """Admin ``/top`` document: ranked buckets/tenants over the
        slow window with fast-window rates, per-class top-K keys and
        clients, worst-request trace-id exemplars per bucket."""
        now = time.time()
        n = n or self.top_k

        def ranked(kind: str) -> list[dict]:
            slow = self.window_accounts(kind, self.slow_s, now)
            fast = self.window_accounts(kind, self.fast_s, now)
            total = sum(v["requests"] for v in slow.values()) or 1
            rows = []
            for name, acc in slow.items():
                row = {"name": name, "share":
                       round(acc["requests"] / total, 4), **acc}
                f = fast.get(name)
                if f:
                    row["fastRequests"] = f["requests"]
                rows.append(row)
            rows.sort(key=lambda r: (-r["requests"], r["name"]))
            return rows[:n]

        buckets = ranked("buckets")
        with self._mu:
            worst: dict[str, tuple] = {}
            lo = now - self.slow_s - self._gran
            for slot in self._slots:
                if slot.t0 < lo:
                    continue
                for bname, w in slot.worst.items():
                    cur = worst.get(bname)
                    if cur is None or w[0] > cur[0]:
                        worst[bname] = w
            sketches: dict[str, dict] = {}
            for (dim, cls), sk in self._sketches.items():
                sketches.setdefault(dim, {})[cls] = sk.top(n)
        for row in buckets:
            w = worst.get(row["name"])
            if w is not None:
                row["worst"] = {"durationMs": round(w[0], 3),
                                "traceId": w[1]}
        return {"topK": n,
                "windows": {"fastS": self.fast_s, "slowS": self.slow_s},
                "buckets": buckets,
                "tenants": ranked("tenants"),
                "keys": sketches.get("key", {}),
                "clients": sketches.get("client", {})}

    def reset(self) -> None:
        with self._mu:
            self._slots.clear()
            self._sketches = {}
            self._totals = [0, 0, 0, 0, 0]
            self.folded_total = 0


# -- cluster merge ----------------------------------------------------------


def merge_usage(named_snaps: list[tuple[str, dict]]) -> dict:
    """Merge per-node usage snapshots into one cluster view: accounts
    sum per name, sketches merge (merge_topk), totals add — with an
    HONEST ``nodes`` count (only nodes that answered; the endpoint
    reports unreachable peers separately, so a lost node never reads
    as idle)."""
    snaps = [s for _, s in named_snaps
             if isinstance(s, dict) and "totals" in s]
    out: dict = {"nodes": len(snaps),
                 "topK": max([s.get("topK", 0) for s in snaps] or [0]),
                 "windows": (snaps[0].get("windows", {}) if snaps
                             else {}),
                 "totals": {"requests": 0, "rxBytes": 0, "txBytes": 0,
                            "errors": 0, "shed": 0},
                 "folded": 0,
                 "buckets": {"fast": {}, "slow": {}},
                 "tenants": {"fast": {}, "slow": {}},
                 "sketches": {}}
    for snap in snaps:
        for k, v in (snap.get("totals") or {}).items():
            out["totals"][k] = out["totals"].get(k, 0) + v
        out["folded"] += snap.get("folded", 0)
        for kind in ("buckets", "tenants"):
            for win in ("fast", "slow"):
                dst = out[kind][win]
                for name, acc in ((snap.get(kind) or {}).get(win)
                                  or {}).items():
                    cur = dst.setdefault(name, {})
                    for f, v in acc.items():
                        cur[f] = cur.get(f, 0) + v
    by_dim_cls: dict[str, dict[str, list]] = {}
    for snap in snaps:
        for dim, classes in (snap.get("sketches") or {}).items():
            for cls, sk in classes.items():
                by_dim_cls.setdefault(dim, {}).setdefault(
                    cls, []).append(sk)
    for dim, classes in by_dim_cls.items():
        out["sketches"][dim] = {
            cls: merge_topk(sks) for cls, sks in classes.items()}
    return out


# -- redaction for unauthenticated surfaces ---------------------------------


def _redact_name(name: str) -> str:
    """Short stable identity for access keys / client addresses on the
    UNAUTHENTICATED usage endpoints (same policy as drivemon's
    redacted_endpoint): enough to tell tenants apart and correlate
    with the root-only admin /top, without disclosing credentials or
    client topology to anonymous probes."""
    if name in (OTHER, "-", ""):
        return name
    digest = hashlib.sha256(name.encode("utf-8", "replace"))
    return f"{name[:2]}…#{digest.hexdigest()[:8]}"


def redact_usage(doc: dict) -> dict:
    """Copy of a usage snapshot (or cluster merge) with tenant names,
    client-sketch keys, and object-key tails redacted.  Bucket names
    stay: they already ride unauthenticated metric labels, like the
    reference's per-bucket Prometheus series."""
    out = dict(doc)
    tenants = doc.get("tenants")
    if isinstance(tenants, dict):
        out["tenants"] = {
            win: {_redact_name(name): acc for name, acc in accs.items()}
            for win, accs in tenants.items()}
    classes = doc.get("classes")
    if isinstance(classes, dict):
        red_classes = {}
        for cls, cdoc in classes.items():
            cdoc = dict(cdoc)
            for key in ("topTenant", "topShedTenant"):
                if isinstance(cdoc.get(key), dict):
                    cdoc[key] = dict(cdoc[key],
                                     name=_redact_name(
                                         cdoc[key].get("name", "")))
            red_classes[cls] = cdoc
        out["classes"] = red_classes
    sketches = doc.get("sketches")
    if isinstance(sketches, dict):
        red_sketches = dict(sketches)
        if "client" in sketches:
            red = {}
            for cls, sk in sketches["client"].items():
                sk = dict(sk)
                sk["counters"] = [
                    dict(c, key=_redact_name(c.get("key", "")))
                    for c in sk.get("counters", [])]
                sk.pop("cm", None)  # rows leak nothing; save bytes
                red[cls] = sk
            red_sketches["client"] = red
        if "key" in sketches:
            # Object-key names can embed user ids/filenames and never
            # ride metric labels — keep the bucket prefix (hot-bucket
            # shape stays readable), redact the key tail; admin /top
            # serves keys whole.
            red = {}
            for cls, sk in sketches["key"].items():
                sk = dict(sk)

                def _red_key(full: str) -> str:
                    bkt, sep, key = full.partition("/")
                    return bkt + sep + _redact_name(key) if sep \
                        else _redact_name(full)

                sk["counters"] = [
                    dict(c, key=_red_key(c.get("key", "")))
                    for c in sk.get("counters", [])]
                sk.pop("cm", None)
                red[cls] = sk
            red_sketches["key"] = red
        out["sketches"] = red_sketches
    return out


# The process-wide attribution plane the S3 front end records into.
USAGE = UsageAccountant()
