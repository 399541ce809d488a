"""Admin API + health checks + Prometheus metrics
(ref cmd/admin-router.go, cmd/admin-handlers.go, cmd/healthcheck-router.go,
cmd/metrics-v2.go).

Routes (same port as S3, non-S3 prefixes):
    /minio-tpu/admin/v1/...    root-credential SigV4 JSON API
    /minio-tpu/health/live     liveness (200 always once HTTP is up)
    /minio-tpu/health/ready    readiness (object layer attached)
    /minio-tpu/health/cluster  quorum-aware (every set readable)
    /minio-tpu/metrics         Prometheus text exposition

The port's own copy of ``minio_tpu/s3/admin.py``, with no change in
behaviour but one route of its own: ``kernel-launches``, K1's and K2's
launches on the card.
"""

from __future__ import annotations

import json
import threading
import time

from .. import __version__


class Metrics:
    """Request/error/byte counters (ref cmd/http-stats.go,
    metrics-v2 collectors)."""

    def __init__(self):
        self._mu = threading.Lock()
        self.start_time = time.time()
        self.requests: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.rx_bytes = 0
        self.tx_bytes = 0

    def record(self, api: str, status: int, rx: int, tx: int) -> None:
        with self._mu:
            self.requests[api] = self.requests.get(api, 0) + 1
            if status >= 400:
                key = f"{api}:{status}"
                self.errors[key] = self.errors.get(key, 0) + 1
            self.rx_bytes += rx
            self.tx_bytes += tx

    def prometheus(self, layer) -> str:
        lines = [
            "# HELP minio_tpu_uptime_seconds Server uptime.",
            "# TYPE minio_tpu_uptime_seconds gauge",
            f"minio_tpu_uptime_seconds "
            f"{time.time() - self.start_time:.1f}",
            "# TYPE minio_tpu_rx_bytes_total counter",
            f"minio_tpu_rx_bytes_total {self.rx_bytes}",
            "# TYPE minio_tpu_tx_bytes_total counter",
            f"minio_tpu_tx_bytes_total {self.tx_bytes}",
            "# TYPE minio_tpu_requests_total counter",
        ]
        with self._mu:
            for api, n in sorted(self.requests.items()):
                lines.append(
                    f'minio_tpu_requests_total{{api="{api}"}} {n}')
            lines.append("# TYPE minio_tpu_errors_total counter")
            for key, n in sorted(self.errors.items()):
                api, _, status = key.rpartition(":")
                lines.append(
                    f'minio_tpu_errors_total{{api="{api}",'
                    f'status="{status}"}} {n}')
        if layer is not None:
            lines.append("# TYPE minio_tpu_disk_online gauge")
            lines.append("# TYPE minio_tpu_disk_total_bytes gauge")
            lines.append("# TYPE minio_tpu_disk_free_bytes gauge")
            for p_i, pool in enumerate(_pools(layer)):
                for s_i, es in enumerate(pool.sets):
                    for d_i, disk in enumerate(es.disks):
                        lbl = (f'pool="{p_i}",set="{s_i}",'
                               f'disk="{d_i}"')
                        try:
                            info = disk.disk_info()
                            lines.append(
                                f"minio_tpu_disk_online{{{lbl}}} 1")
                            lines.append(
                                f"minio_tpu_disk_total_bytes{{{lbl}}} "
                                f"{info.get('total', 0)}")
                            lines.append(
                                f"minio_tpu_disk_free_bytes{{{lbl}}} "
                                f"{info.get('free', 0)}")
                        except Exception:
                            lines.append(
                                f"minio_tpu_disk_online{{{lbl}}} 0")
        # Codec dispatch honesty counters: which device actually did the
        # RS math and the bitrot hashing (ops/batching.STATS/HH_STATS).
        from ..ops import batching
        for prefix, stats in (("rs", batching.STATS),
                              ("bitrot", batching.HH_STATS)):
            snap = stats.snapshot()
            for key, val in sorted(snap.items()):
                lines.append(
                    f"# TYPE minio_tpu_{prefix}_{key} counter")
                lines.append(f"minio_tpu_{prefix}_{key} {val}")
        return "\n".join(lines) + "\n"


def _pools(layer):
    if hasattr(layer, "pools"):
        return layer.pools
    if hasattr(layer, "sets"):
        class _P:
            sets = layer.sets
        return [_P]
    class _S:
        sets = [layer]
    return [_S]


class AdminHandlers:
    """JSON admin API over the object layer + IAM (root only)."""

    def __init__(self, server):
        self.server = server  # S3Server
        self._heal_seqs: dict[str, dict] = {}

    def handle(self, method: str, path: str, params: dict,
               body: bytes, access_key: str) -> tuple[int, bytes]:
        if access_key != self.server.access_key:
            return 403, json.dumps({"error": "admin requires root"
                                    }).encode()
        route = path.removeprefix("/minio-tpu/admin/v1/")
        fn = getattr(self, f"h_{route.replace('-', '_')}", None)
        if fn is None:
            return 404, json.dumps({"error": f"unknown: {route}"}).encode()
        try:
            out = fn(params, body)
            return 200, json.dumps(out, default=str).encode()
        except KeyError as e:
            return 404, json.dumps({"error": f"not found: {e}"}).encode()
        except (ValueError, TypeError) as e:
            return 400, json.dumps({"error": str(e)}).encode()

    # -- info / usage ---------------------------------------------------

    def h_info(self, p, body):
        layer = self.server.layer
        pools = []
        for pool in _pools(layer):
            sets = []
            for es in pool.sets:
                online = 0
                total = free = 0
                for d in es.disks:
                    try:
                        info = d.disk_info()
                        online += 1
                        total += info.get("total", 0)
                        free += info.get("free", 0)
                    except Exception:
                        pass
                sets.append({"disks": len(es.disks), "online": online,
                             "data": es.k, "parity": es.m,
                             "totalBytes": total, "freeBytes": free})
            pools.append({"sets": sets})
        from ..ops import batching
        out = {"version": __version__, "mode": "erasure",
               "pools": pools,
               "uptime": time.time() - self.server.metrics.start_time,
               # Device-vs-host dispatch honesty counters for the two
               # halves of the TPU data plane (RS coding + bitrot).
               "tpu": {"rs": batching.STATS.snapshot(),
                       "bitrot": batching.HH_STATS.snapshot()}}
        notif = self.server.notification
        if notif is not None:
            out["peers"] = notif.server_info_all()
        return out

    def h_kernel_launches(self, p, body):
        """K1's and K2's launches on the card since the process started,
        counted by each kernel's wrapper where it launches: ``info``'s
        dispatch counters also count the torch-cpu lane."""
        from ..ops import hh256_gpu, rs_gpu
        return {"gf_apply": rs_gpu.gf_apply_cuda.launches,
                "hh256": hh256_gpu.hash_chunks_cuda.launches}

    def h_datausage(self, p, body):
        # Serve the crawler's persisted cache when scanning runs
        # (ref DataUsageInfoHandler reading dataUsageCache); buckets
        # newer than the last cycle (and the no-crawler fallback) get a
        # synchronous walk producing the SAME entry shape.
        layer = self.server.layer
        crawler = getattr(self.server, "crawler", None)
        cached = crawler.data_usage() if crawler is not None else {}
        buckets: dict[str, dict] = dict(cached.get("buckets", {}))
        for b in layer.list_buckets():
            if b["name"] in buckets:
                continue
            objs = layer.list_objects(b["name"], max_keys=1_000_000)
            buckets[b["name"]] = {
                "objects": len(objs),
                "versions": len(objs),
                "size": sum(o.size for o in objs),
                "histogram": {},
            }
        return {"lastUpdate": cached.get("lastUpdate", 0.0),
                "buckets": buckets}

    def h_top(self, p, body):
        """`mc admin top` analog (obs/usage.py): ranked buckets and
        tenants over the usage windows, per-class top-K object keys
        and client addresses from the heavy-hitter sketches — joined
        with the crawler's at-rest census (`storedBytes`, so live
        traffic and footprint land in one report) and with the
        slowlog: a bucket's worst-request trace-id exemplar is
        annotated with its slowlog blame when the capture ring still
        holds it.  Root-only, so tenants/clients are un-redacted
        (the anonymous /minio-tpu/v2/usage surface redacts them)."""
        from ..obs.slowlog import SLOWLOG
        from ..obs.usage import USAGE
        n = int(p.get("n", "0") or 0)
        doc = USAGE.top(n if n > 0 else None)
        crawler = getattr(self.server, "crawler", None)
        sizes = crawler.bucket_sizes() if crawler is not None else {}
        captured = {e.get("requestID"): e
                    for e in SLOWLOG.entries(n=SLOWLOG.RING_SIZE)}
        for row in doc["buckets"]:
            if row["name"] in sizes:
                row["storedBytes"] = sizes[row["name"]]
            worst = row.get("worst")
            if worst:
                hit = captured.get(worst.get("traceId"))
                if hit is not None:
                    worst["slowlog"] = {
                        "blamedLayer": hit.get("blamedLayer", ""),
                        "statusCode": hit.get("statusCode", 0)}
        return doc

    # -- users / policies ----------------------------------------------

    def _iam(self):
        if self.server.iam is None:
            raise ValueError("IAM not configured")
        return self.server.iam

    def h_add_user(self, p, body):
        doc = json.loads(body)
        self._iam().add_user(doc["accessKey"], doc["secretKey"],
                             doc.get("policies", []))
        return {"ok": True}

    def h_list_users(self, p, body):
        return {"users": self._iam().list_users()}

    def h_remove_user(self, p, body):
        self._iam().remove_user(p["accessKey"])
        return {"ok": True}

    def h_set_user_policy(self, p, body):
        self._iam().set_user_policy(p["accessKey"],
                                    p["policies"].split(","))
        return {"ok": True}

    def h_add_policy(self, p, body):
        self._iam().set_policy(p["name"], json.loads(body))
        return {"ok": True}

    def h_list_policies(self, p, body):
        return {"policies": self._iam().list_policies()}

    def h_remove_policy(self, p, body):
        self._iam().delete_policy(p["name"])
        return {"ok": True}

    def h_set_sts_policy_map(self, p, body):
        """Map an external identity (ldap:<dn> / oidc:<sub>) to canned
        policies (ref mc admin policy attach --ldap; PolicyDBSet).
        Empty policies clears the mapping."""
        doc = json.loads(body)
        self._iam().set_sts_policy_map(doc["identity"],
                                       doc.get("policies", []))
        return {"ok": True}

    def h_get_sts_policy_map(self, p, body):
        return {"map": dict(self._iam().sts_policy_map)}

    def h_add_group(self, p, body):
        doc = json.loads(body)
        self._iam().add_group(doc["group"], doc.get("members", []),
                              doc.get("policies"))
        return {"ok": True}

    # -- heal -----------------------------------------------------------

    @staticmethod
    def _heal_sweep(layer, bucket: str, prefix: str, dry: bool):
        """Yield one result dict per healed object — shared by the
        synchronous handler and async sequences (ref healSequence's
        traverseAndHeal)."""
        def as_dict(r, name):
            out = {"object": name, "beforeOk": r.before_ok,
                   "afterOk": r.after_ok,
                   "healedDisks": r.healed_disks,
                   "dangling": r.dangling}
            if getattr(r, "skipped_lock", False):
                # Contended object (long-lived stream holds its lock):
                # requeued via MRF; reported so operators see it.
                out["skipped"] = "lock timeout"
            return out
        if bucket:
            layer.healer.heal_bucket(bucket)
            for o in layer.list_objects(bucket, prefix=prefix,
                                        max_keys=1_000_000):
                yield as_dict(layer.healer.heal_object_or_queue(
                    bucket, o.name, dry_run=dry), o.name)
        else:
            for r in layer.healer.heal_all():
                yield as_dict(r, f"{r.bucket}/{r.object_name}")

    def h_heal(self, p, body):
        return {"items": list(self._heal_sweep(
            self.server.layer, p.get("bucket", ""), p.get("prefix", ""),
            p.get("dryRun") == "true"))}

    # -- bucket quota (ref PutBucketQuotaConfigHandler,
    # cmd/admin-bucket-handlers.go) ------------------------------------

    def h_set_bucket_quota(self, p, body):
        doc = json.loads(body) if body else {}
        bm = self.server.bucket_meta
        if not doc.get("quota"):
            bm.update(p["bucket"], quota=None)  # clear
        else:
            bm.update(p["bucket"], quota={
                "quota": int(doc["quota"]),
                "quotaType": doc.get("quotaType", "hard")})
        return {"ok": True}

    def h_get_bucket_quota(self, p, body):
        return self.server.bucket_meta.get(p["bucket"]).quota or {}

    # -- replication remote targets (ref SetRemoteTargetHandler etc.,
    # cmd/admin-bucket-handlers.go) ------------------------------------

    def _replication(self):
        return self.server.handlers.replication

    def h_set_remote_target(self, p, body):
        doc = json.loads(body)
        arn = self._replication().targets.set_target(
            p["bucket"], doc["endpoint"], doc["target_bucket"],
            doc["access_key"], doc["secret_key"],
            bandwidth_limit=int(doc.get("bandwidth_limit") or 0))
        return {"arn": arn}

    def h_set_target_bandwidth(self, p, body):
        """Edit a target's replication rate cap (bytes/sec, 0 lifts
        it) — `mc admin bucket remote edit --bandwidth` analog (ref
        pkg/bandwidth LimitInBytesPerSecond)."""
        doc = json.loads(body)
        self._replication().targets.set_target_bandwidth(
            p["bucket"], doc["arn"], int(doc["bandwidth_limit"]))
        return {"ok": True}

    def h_list_remote_targets(self, p, body):
        targets = self._replication().targets.list_targets(p["bucket"])
        # Never return secrets over the wire (parity with madmin's
        # redacted listing).
        return {"targets": [{k: v for k, v in t.items()
                             if k != "secret_key"} for t in targets]}

    def h_remove_remote_target(self, p, body):
        self._replication().targets.remove_target(p["bucket"], p["arn"])
        return {"ok": True}

    def h_replication_stats(self, p, body):
        return dict(self._replication().stats)

    # -- heal sequences (ref healSequence state machine,
    # cmd/admin-heal-ops.go:353, allHealState:89) -----------------------

    MAX_HEAL_SEQS = 16          # finished sequences kept around
    MAX_SEQ_ITEMS = 10_000      # per-sequence result ring

    def _prune_heal_seqs(self) -> None:
        """Drop the oldest FINISHED sequences over the cap (the
        reference purges after keepHealSeqStateDuration)."""
        done = [(seq["finished"], tok) for tok, seq in
                self._heal_seqs.items() if seq["status"] != "running"]
        done.sort()
        while len(self._heal_seqs) > self.MAX_HEAL_SEQS and done:
            _, tok = done.pop(0)
            self._heal_seqs.pop(tok, None)

    def h_heal_start(self, p, body):
        """Kick off an async heal sweep; poll with heal-status?token=.
        The reference's POST /heal/... returns a clientToken the same
        way (ref cmd/admin-heal-ops.go:353)."""
        import threading
        import uuid as _uuid
        self._prune_heal_seqs()
        token = _uuid.uuid4().hex[:12]
        seq = {"status": "running", "items": [], "error": "",
               "scanned": 0, "healed": 0,
               "started": time.time(), "finished": 0.0}
        self._heal_seqs[token] = seq
        layer = self.server.layer
        bucket, prefix = p.get("bucket", ""), p.get("prefix", "")
        dry = p.get("dryRun") == "true"

        def run():
            try:
                for item in self._heal_sweep(layer, bucket, prefix, dry):
                    seq["scanned"] += 1
                    if item["healedDisks"]:
                        seq["healed"] += 1
                    seq["items"].append(item)
                    if len(seq["items"]) > self.MAX_SEQ_ITEMS:
                        del seq["items"][:self.MAX_SEQ_ITEMS // 2]
                seq["status"] = "done"
            except Exception as e:  # noqa: BLE001
                seq["status"] = "failed"
                seq["error"] = str(e)
            seq["finished"] = time.time()

        # mtpu-lint: disable=R1 -- heal sequence outlives the admin request that started it (polled via clientToken)
        threading.Thread(target=run, daemon=True,
                         name=f"heal-seq-{token}").start()
        return {"clientToken": token}

    def h_heal_status(self, p, body):
        seq = self._heal_seqs[p["token"]]  # KeyError -> 404
        return {"status": seq["status"], "error": seq["error"],
                "itemsScanned": seq["scanned"],
                "itemsHealed": seq["healed"],
                "items": seq["items"][-1000:]}

    # -- OBD / health info (ref cmd/healthinfo.go, admin /obdinfo;
    # pkg/smart, pkg/disk) ---------------------------------------------

    def h_obd_info(self, p, body):
        """Hardware + perf diagnostics bundle: cpu/mem/os plus a small
        per-disk write+read latency probe (ref the drive perf section
        of the OBD handler)."""
        import os as _os
        import platform

        info = {
            "os": {"platform": platform.platform(),
                   "python": platform.python_version()},
            "cpu": {"count": _os.cpu_count(),
                    "loadavg": list(_os.getloadavg())},
            "mem": self._meminfo(),
            "drives": [],
        }
        layer = self.server.layer
        probe = p.get("drivePerf") == "true"
        for pool in _pools(layer):
            for es in pool.sets:
                for d in es.disks:
                    ent = {"endpoint": getattr(d, "root",
                                               str(d))}
                    try:
                        ent.update(d.disk_info())
                        ent["online"] = True
                        if probe:
                            ent["perf"] = self._drive_perf(d)
                    except Exception as e:  # noqa: BLE001
                        ent["online"] = False
                        ent["error"] = str(e)
                    info["drives"].append(ent)
        return info

    @staticmethod
    def _meminfo() -> dict:
        out = {}
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    if k in ("MemTotal", "MemAvailable"):
                        out[k] = int(v.strip().split()[0]) * 1024
        except OSError:
            pass
        return out

    @staticmethod
    def _drive_perf(disk) -> dict:
        """4KiB write+read latency probe on one drive (ref the
        dperf-style measurement in the OBD drive section)."""
        payload = b"\0" * 4096
        path = "obd-perf-probe"
        t0 = time.perf_counter()
        disk.write_all(".minio.sys", f"tmp/{path}", payload)
        w_ms = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        disk.read_all(".minio.sys", f"tmp/{path}")
        r_ms = (time.perf_counter() - t0) * 1000
        try:
            disk.delete(".minio.sys", f"tmp/{path}")
        except Exception:
            pass
        return {"writeLatencyMs": round(w_ms, 3),
                "readLatencyMs": round(r_ms, 3)}

    # -- profiling (ref admin /profiling/start, cmd/utils.go:230
    # globalProfiler — Python analog: cProfile) ------------------------

    def h_profiling_start(self, p, body):
        from ..utils.profiler import SamplingProfiler
        if getattr(self, "_profiler", None) is not None:
            raise ValueError("profiling already running")
        prof = SamplingProfiler(
            interval=float(p.get("intervalMs", "5")) / 1000.0)
        prof.start()
        self._profiler = prof
        out = {"ok": True}
        notif = self.server.notification
        if p.get("cluster") == "true" and notif is not None:
            # Cluster-wide profiling (ref peerRESTMethodStartProfiling).
            # A raising fan-out must not strand the local profiler in a
            # stuck "profiling already running" state: per-peer errors
            # degrade inside profiling_start_all, so anything RAISING
            # here is a caller-side fault — undo the local start.
            try:
                out["peers"] = notif.profiling_start_all(
                    float(p.get("intervalMs", "5")))
            except BaseException:
                prof.stop()
                self._profiler = None
                raise
        return out

    def h_profiling_stop(self, p, body):
        prof = getattr(self, "_profiler", None)
        if prof is None:
            raise ValueError("profiling not running")
        self._profiler = None
        out = {"profile": prof.stop()}
        notif = self.server.notification
        if p.get("cluster") == "true" and notif is not None:
            out["peers"] = notif.profiling_stop_all()
        return out

    def h_profile(self, p, body):
        """Continuous profiler (obs/loopmon.py): the always-on ~1%
        duty-cycle sampler's per-minute aggregate — top-N self-time
        rows plus pprof-style folded stacks ("f1;f2;f3 N", feed
        straight to flamegraph.pl), and the loopmon per-loop health
        census so a loop-stall investigation starts from ONE page.
        ``?n=`` rows (default 50), ``?minutes=`` window (default 5)."""
        from ..obs.loopmon import LOOPMON, ContinuousProfiler
        n = min(500, max(1, int(p.get("n", "50") or 50)))
        minutes = min(ContinuousProfiler.MINUTES_KEPT,
                      max(1, int(p.get("minutes", "5") or 5)))
        out = LOOPMON.profiler.report(top=n, minutes=minutes)
        out["loops"] = LOOPMON.snapshot()
        return out

    # -- bandwidth (ref pkg/bandwidth, admin /bandwidth route,
    # cmd/admin-router.go:217) -----------------------------------------

    def h_bandwidth(self, p, body):
        report = self.server.bandwidth.report()
        bucket = p.get("bucket", "")
        if bucket:
            report = {bucket: report.get(bucket, {
                "rxBytesWindow": 0, "txBytesWindow": 0,
                "rxRateBps": 0.0, "txRateBps": 0.0})}
        return {"buckets": report, "windowSeconds": 60}

    # -- remote tiers (ref admin tier APIs, cmd/tier.go) ---------------

    def _tiers(self):
        return self.server.handlers.tiers

    def h_add_tier(self, p, body):
        from ..bucket.tiering import TierError
        doc = json.loads(body)
        try:
            self._tiers().add(doc["name"], doc["endpoint"],
                              doc["bucket"], doc["access_key"],
                              doc["secret_key"],
                              doc.get("prefix", ""))
        except TierError as e:
            raise ValueError(str(e))
        return {"ok": True}

    def h_list_tiers(self, p, body):
        return {"tiers": self._tiers().list()}

    def h_remove_tier(self, p, body):
        from ..bucket.tiering import TierError
        try:
            self._tiers().remove(p["name"], layer=self.server.layer)
        except TierError as e:
            raise ValueError(str(e))
        return {"ok": True}

    # -- hot-object cache ----------------------------------------------

    def h_cache_stats(self, p, body):
        """Hot-object serving tier stats (cache/hotcache.py): tier
        occupancy, hit ratio, fill/invalidation counters."""
        from ..cache.hotcache import HOTCACHE
        return HOTCACHE.snapshot()

    # -- config KV (ref admin config APIs, cmd/admin-handlers-config-kv.go)

    def _config(self):
        if self.server.config is None:
            raise ValueError("config system not ready")
        return self.server.config

    def h_get_config(self, p, body):
        return {"config": self._config().dump()}

    def h_set_config_kv(self, p, body):
        # Unknown names / rejected values raise ValueError subclasses,
        # which handle() maps to 400.
        self._config().set_kv(body.decode("utf-8"))
        return {"ok": True, "restart": False}

    def h_del_config_kv(self, p, body):
        self._config().del_kv(body.decode("utf-8").strip())
        return {"ok": True}

    def h_config_history(self, p, body):
        return {"entries": self._config().history_ids()}

    def h_restore_config(self, p, body):
        self._config().restore(p["id"])
        return {"ok": True}

    # -- trace / console log (ref admin /trace streaming,
    # cmd/admin-router.go:199; console cmd/consolelogger.go) -----------

    def h_trace(self, p, body):
        """Long-poll: subscribe to the request-trace hub and collect
        entries for up to `timeout` seconds (default 3, cap 30). The
        reference streams indefinitely over chunked HTTP; a bounded
        collect keeps the admin API request/response.

        cluster=true additionally collects from every peer over the
        same window (ref peerRESTMethodTrace fan-in,
        cmd/admin-router.go:199)."""
        import threading as _threading
        timeout = min(float(p.get("timeout", "3") or 3), 30.0)
        notif = self.server.notification
        peer_entries: list = []
        collector = None
        if p.get("cluster") == "true" and notif is not None:
            # mtpu-lint: disable=R1 -- trace collection window is its own explicit timeout, not the request budget
            collector = _threading.Thread(
                target=lambda: peer_entries.extend(
                    notif.trace_all(timeout)), daemon=True)
            collector.start()
        entries = self.server.trace_hub.collect(timeout)
        if collector is not None:
            collector.join(timeout=timeout + 5)
            entries.extend(peer_entries)
            entries.sort(key=lambda e: e.get("time", 0)
                         if isinstance(e, dict) else 0)
        return {"entries": entries}

    def h_console_log(self, p, body):
        from ..logger import Logger
        n = min(int(p.get("n", "100") or 100), 10_000)
        return {"entries": [
            {"level": e.level, "time": e.time, "message": e.message,
             "source": e.source} for e in Logger.get().ring.tail(n)]}

    def h_audit_status(self, p, body):
        a = self.server.audit
        if a is None:
            return {"configured": False}
        return {"configured": True, "endpoint": a.endpoint,
                "sent": a.sent, "failed": a.failed,
                "dropped": a.dropped,
                "queued": a.queued() if hasattr(a, "queued") else 0}

    # -- slow-request log (obs/slowlog.py) ------------------------------

    def h_slowlog(self, p, body):
        """Tail the slow-request capture ring, filtered by blamed
        layer (`blame=disk`) and/or API class or name (`api=write`,
        `api=PUT-object`). Each entry carries the request's full span
        tree, its QoS admission/deadline data, and the per-layer blame
        breakdown — plus the last profile-on-slow burst when one ran."""
        from ..obs.slowlog import SLOWLOG
        # Clamp below too: n=0 would slice [-0:] (the whole ring) and
        # negative n an oldest-first head slice.
        n = min(max(1, int(p.get("n", "50") or 50)), SLOWLOG.RING_SIZE)
        out = {
            "entries": SLOWLOG.entries(n=n, blame=p.get("blame", ""),
                                       api=p.get("api", "")),
            "total": SLOWLOG.total,
            "thresholdsMs": SLOWLOG.thresholds(),
            "profileOnSlow": SLOWLOG.profile_on_slow,
        }
        if SLOWLOG.last_profile is not None:
            out["profile"] = SLOWLOG.last_profile
        return out

    def h_kernel_health(self, p, body):
        """Kernel dispatch health (obs/kernprof.py): per-backend state
        machine (device/native/xla-cpu/host with fail streaks + last
        failure cause) and cumulative dispatch/byte mix.  ``?probe=
        true`` runs one recovery probe per backend first — the manual
        'is the relay back yet?' lever (probes are tiny real
        dispatches; root-only surface, so no amplification risk)."""
        from ..obs.kernprof import KERNPROF
        out: dict = {}
        if p.get("probe") == "true":
            out["probed"] = KERNPROF.probe_all()
        out.update(KERNPROF.snapshot())
        return out

    def h_codec_plan(self, p, body):
        """Codec dispatch planner (ops/autotune.py): the live plan per
        (kernel, batch-size bucket), the measured per-lane crossover
        table (GiB/s + sample counts), probe-ladder results, backend
        health states, and the per-set device-affinity map with its
        per-device dispatch census (parallel/mesh.py).  ``?probe=
        true`` re-runs the probe ladder synchronously first — the
        manual 'is the crossover still right?' lever (probes are tiny
        real dispatches; root-only surface, no amplification risk)."""
        from ..ops.autotune import AUTOTUNE
        out: dict = {}
        if p.get("probe") == "true":
            # Keyed apart from snapshot()'s boolean "probed" flag.
            out["probeResults"] = AUTOTUNE.probe_ladder()
        out.update(AUTOTUNE.snapshot())
        try:
            from ..parallel.mesh import MESH_AFFINITY
            out["affinity"] = MESH_AFFINITY.snapshot()
        except Exception:
            out["affinity"] = {"nDevices": 1, "assignments": {},
                               "dispatches": {}}
        return out

    def h_incidents(self, p, body):
        """Incident bundles (obs/incidents.py): auto-frozen diagnosis
        state for every alert that reached firing.  Bare GET lists the
        ring (id + headline); ``?id=`` fetches one full JSON bundle —
        timeline window, slowlog entries + worst span tree, drive/MRF/
        backend census, fault plan, effective (redacted) config.
        Root-only, so drive endpoints stay un-redacted here."""
        from ..obs.incidents import INCIDENTS
        if p.get("id"):
            return INCIDENTS.get(p["id"])  # KeyError -> 404
        return {"incidents": INCIDENTS.list(),
                "captured": INCIDENTS.captured_total}

    def h_drive_health(self, p, body):
        """Admin view of the drive-health monitor (same shape as the
        unauthenticated /minio-tpu/v2/health/drives node endpoint, but
        with FULL drive endpoints — this surface is root-only)."""
        from ..obs.drivemon import DRIVEMON
        out = DRIVEMON.snapshot()
        out["mrf"] = self.server._mrf_stats()
        return out

    def h_recovery(self, p, body):
        """Boot-time crash-recovery report (storage/recovery.py): per
        erasure set, the staging residue found/cleaned, objects
        requeued for heal, MRF journal entries replayed, and the sweep
        duration — plus the journal's live census so an operator can
        see the durable backlog draining."""
        journals = []
        if self.server.layer is not None:
            for pool in _pools(self.server.layer):
                for es in pool.sets:
                    mrf = getattr(es, "mrf", None)
                    if mrf is not None and hasattr(mrf, "journal"):
                        journals.append(mrf.journal.stats())
        # Heal repair-traffic ledger: bytes moved per repair mode
        # (rs vs regen) and source (disk vs net) since boot — the
        # paired counters behind the REGEN class's bandwidth claim.
        from ..erasure.regen.repair import REPAIR_BYTES
        return {"sweeps": getattr(self.server, "recovery_reports", []),
                "journals": journals,
                "repair": REPAIR_BYTES.snapshot()}

    # -- runtime fault injection (minio_tpu/faultinject) ---------------

    def h_fault_inject(self, p, body):
        """Manage the runtime fault-injection plan.

        POST with a JSON plan body loads (replaces) the plan;
        ``?clear=true`` clears it; a bare GET/POST returns the active
        plan with per-rule seen/fired counters — the scenario
        matrices in tests/test_fault_harness.py drive exactly this
        surface."""
        from ..faultinject import FAULTS, FaultPlanError
        if p.get("clear") == "true":
            FAULTS.clear()
            return {"ok": True, "active": False}
        if body:
            try:
                doc = json.loads(body)
            except json.JSONDecodeError as e:
                raise ValueError(f"fault plan: {e}")
            try:
                FAULTS.load_plan(doc)
            except FaultPlanError as e:
                raise ValueError(str(e))
            return {"ok": True, "active": FAULTS.enabled,
                    "rules": len(doc.get("rules", []))}
        return FAULTS.snapshot()

    # -- locks ----------------------------------------------------------

    def h_top_locks(self, p, body):
        out = []
        reg = self.server.rpc_registry
        if reg is not None:
            svc = reg._services.get("lock")
            if svc is not None:
                out = svc.locker.top_locks()
        return {"locks": out}
