"""Bucket replication: remote-target registry + async replication pool.

The reference implements active CRR as a background worker pool that
re-PUTs each eligible object to a remote S3 target registered via the
admin API, tracking per-version replication status in object metadata
(ref cmd/bucket-replication.go: mustReplicate:100, replicateObject:428,
replicateDelete:215, worker pool replicationState:571-625; target
registry cmd/bucket-targets.go).

Here the decision + status protocol is the same — PENDING on write,
worker flips it to COMPLETED/FAILED, incoming replica writes carry
REPLICA — but transport is our own SigV4 S3Client and the pool is a
thread queue. Status updates are metadata-only xl.meta rewrites
(ErasureObjects.update_object_metadata), never a data rewrite.

The port's own copy of ``minio_tpu/bucket/replication.py``, with no change in
behaviour.
"""

from __future__ import annotations

import queue
import threading
import urllib.parse
import uuid
from dataclasses import dataclass, field

from ..s3.xmlutil import parse

# Replication status values (ref replication.StatusType,
# pkg/bucket/replication/replication.go)
PENDING = "PENDING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
REPLICA = "REPLICA"

# Stored in object metadata / surfaced as the S3 response header.
META_REPLICATION_STATUS = "x-amz-replication-status"


class ReplicationError(Exception):
    pass


# ---------------------------------------------------------------------------
# Replication configuration (<ReplicationConfiguration> XML)
# ---------------------------------------------------------------------------


@dataclass
class ReplicationRule:
    """One <Rule> (ref pkg/bucket/replication/rule.go)."""
    rule_id: str = ""
    status: str = "Enabled"
    priority: int = 0
    prefix: str = ""
    delete_marker_replication: bool = False
    destination_arn: str = ""  # <Destination><Bucket> ARN

    def matches(self, key: str) -> bool:
        return self.status == "Enabled" and key.startswith(self.prefix)


@dataclass
class ReplicationConfig:
    """Parsed <ReplicationConfiguration> (ref
    pkg/bucket/replication/replication.go ParseConfig)."""
    role: str = ""
    rules: list[ReplicationRule] = field(default_factory=list)

    @classmethod
    def from_xml(cls, raw: str | bytes) -> "ReplicationConfig":
        doc = parse(raw if isinstance(raw, bytes) else raw.encode())
        cfg = cls(role=doc.findtext("Role") or "")
        for r in doc.findall("Rule"):
            rule = ReplicationRule(
                rule_id=r.findtext("ID") or "",
                status=r.findtext("Status") or "Enabled",
                priority=int(r.findtext("Priority") or "0"),
            )
            # Prefix may live at top level (legacy) or under Filter /
            # Filter.And (ref rule.Prefix()).
            for path in ("Prefix", "Filter/Prefix", "Filter/And/Prefix"):
                v = r.findtext(path)
                if v:
                    rule.prefix = v
                    break
            dmr = r.find("DeleteMarkerReplication")
            if dmr is not None and (dmr.findtext("Status") == "Enabled"):
                rule.delete_marker_replication = True
            dest = r.find("Destination")
            if dest is not None:
                rule.destination_arn = dest.findtext("Bucket") or ""
            cfg.rules.append(rule)
        # Highest priority first (ref FilterActionableRules sort).
        cfg.rules.sort(key=lambda r: -r.priority)
        return cfg

    def rule_for(self, key: str) -> ReplicationRule | None:
        for rule in self.rules:
            if rule.matches(key):
                return rule
        return None


# ---------------------------------------------------------------------------
# Remote-target registry
# ---------------------------------------------------------------------------


class BucketTargetSys:
    """Per-bucket remote replication targets, persisted in bucket
    metadata (ref BucketTargetSys, cmd/bucket-targets.go:470 — targets
    live in `.metadata.bin` and are addressed by ARN)."""

    def __init__(self, bucket_meta):
        self.bucket_meta = bucket_meta

    @staticmethod
    def normalize_endpoint(endpoint: str) -> str:
        """Accept `host:port` or `http(s)://host[:port]`; store
        `host:port`. Rejecting junk HERE surfaces config mistakes at
        registration, not as silent worker failures."""
        ep = endpoint
        if "://" in ep:
            u = urllib.parse.urlparse(ep)
            if u.scheme not in ("http", "https") or not u.hostname:
                raise ValueError(f"invalid endpoint: {endpoint!r}")
            port = u.port or (443 if u.scheme == "https" else 80)
            return f"{u.hostname}:{port}"
        host, _, port = ep.partition(":")
        if not host or not port.isdigit():
            raise ValueError(f"invalid endpoint: {endpoint!r} "
                             "(want host:port)")
        return ep

    def set_target(self, bucket: str, endpoint: str, target_bucket: str,
                   access_key: str, secret_key: str,
                   bandwidth_limit: int = 0) -> str:
        """Register a target, returns its ARN (ref SetBucketTarget +
        generateTargetArn). bandwidth_limit: replication bytes/sec cap
        toward this target, 0 = unlimited (ref BucketBandwidth /
        pkg/bandwidth LimitInBytesPerSecond)."""
        endpoint = self.normalize_endpoint(endpoint)
        if bandwidth_limit < 0:
            raise ValueError("bandwidth_limit must be >= 0")
        arn = f"arn:minio:replication::{uuid.uuid4().hex[:8]}:{target_bucket}"
        targets = list(self.bucket_meta.get(bucket).replication_targets)
        targets.append({
            "arn": arn, "endpoint": endpoint,
            "target_bucket": target_bucket,
            "access_key": access_key, "secret_key": secret_key,
            "bandwidth_limit": int(bandwidth_limit),
        })
        self.bucket_meta.update(bucket, replication_targets=targets)
        return arn

    def set_target_bandwidth(self, bucket: str, arn: str,
                             bandwidth_limit: int) -> None:
        """Update a registered target's replication rate cap (0 lifts
        it) — the `mc admin bucket remote edit --bandwidth` analog."""
        if bandwidth_limit < 0:
            raise ValueError("bandwidth_limit must be >= 0")
        targets = list(self.bucket_meta.get(bucket).replication_targets)
        for t in targets:
            if t["arn"] == arn:
                t["bandwidth_limit"] = int(bandwidth_limit)
                self.bucket_meta.update(bucket,
                                        replication_targets=targets)
                return
        raise KeyError(f"no such target {arn}")

    def list_targets(self, bucket: str) -> list[dict]:
        return list(self.bucket_meta.get(bucket).replication_targets)

    def remove_target(self, bucket: str, arn: str) -> None:
        targets = [t for t in self.bucket_meta.get(
            bucket).replication_targets if t["arn"] != arn]
        self.bucket_meta.update(bucket, replication_targets=targets)

    def target_for_arn(self, bucket: str, arn: str) -> dict | None:
        """Resolve a destination ARN; a plain `arn:aws:s3:::b` matches
        the registered target whose bucket is b (convenience parity
        with the reference's legacy-ARN handling)."""
        targets = self.bucket_meta.get(bucket).replication_targets
        for t in targets:
            if t["arn"] == arn:
                return t
        if arn.startswith("arn:aws:s3:::"):
            tb = arn[len("arn:aws:s3:::"):]
            for t in targets:
                if t["target_bucket"] == tb:
                    return t
        return None


# ---------------------------------------------------------------------------
# Async replication pool
# ---------------------------------------------------------------------------


@dataclass
class ReplicationTask:
    bucket: str
    key: str
    version_id: str
    op: str  # "put" | "delete"


class ReplicationPool:
    """Worker pool draining a queue of replication tasks (ref
    replicationState worker pool, cmd/bucket-replication.go:571-625).

    `reader(bucket, key, version_id) -> (plain_bytes, ObjectInfo)` is
    supplied by the API layer and yields the logical object (after
    SSE-S3 decrypt + decompression) plus its metadata; SSE-C objects
    are unreadable server-side and are skipped, as in the reference.
    """

    def __init__(self, bucket_meta, reader, layer, workers: int = 2):
        self.bucket_meta = bucket_meta
        self.targets = BucketTargetSys(bucket_meta)
        self.reader = reader
        self.layer = layer
        self._q: queue.Queue[ReplicationTask | None] = queue.Queue()
        self.stats = {"replicated_count": 0, "replicated_bytes": 0,
                      "failed_count": 0, "throttled_count": 0}
        self._cfg_cache: dict[str, ReplicationConfig] = {}
        self._limiters: dict[str, tuple[int, object]] = {}  # arn->(bps, bucket)
        self._stats_mu = threading.Lock()
        self._workers = [
            # mtpu-lint: disable=R1 -- replication drain daemons outlive the mutating requests that enqueue work
            threading.Thread(target=self._work, daemon=True,
                             name=f"replication-{i}")
            for i in range(workers)]
        for w in self._workers:
            w.start()

    # -- decision (ref mustReplicate, cmd/bucket-replication.go:100) ----

    def config(self, bucket: str) -> ReplicationConfig | None:
        raw = self.bucket_meta.get(bucket).replication_xml
        if not raw:
            return None
        hit = self._cfg_cache.get(raw)
        if hit is not None:
            return hit
        try:
            cfg = ReplicationConfig.from_xml(raw)
        except Exception:
            return None
        if len(self._cfg_cache) > 64:  # per-bucket configs; tiny
            self._cfg_cache.clear()
        self._cfg_cache[raw] = cfg
        return cfg

    def must_replicate(self, bucket: str, key: str) -> bool:
        cfg = self.config(bucket)
        return cfg is not None and cfg.rule_for(key) is not None

    def replicates_deletes(self, bucket: str, key: str) -> bool:
        cfg = self.config(bucket)
        if cfg is None:
            return False
        rule = cfg.rule_for(key)
        return rule is not None and rule.delete_marker_replication

    # -- queueing -------------------------------------------------------

    def queue_task(self, bucket: str, key: str, version_id: str,
                   op: str = "put") -> None:
        self._q.put(ReplicationTask(bucket, key, version_id, op))

    def close(self) -> None:
        for _ in self._workers:
            self._q.put(None)

    # -- worker ---------------------------------------------------------

    def _work(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                self._q.task_done()
                return
            try:
                self._replicate(task)
            except Exception:
                with self._stats_mu:
                    self.stats["failed_count"] += 1
                self._set_status(task, FAILED)
            finally:
                self._q.task_done()

    def _client_for(self, target: dict):
        from ..s3.client import S3Client
        host, _, port = target["endpoint"].partition(":")
        return S3Client(host, int(port or 80), target["access_key"],
                        target["secret_key"])

    def _resolve(self, task: ReplicationTask) -> tuple[dict, str] | None:
        cfg = self.config(task.bucket)
        if cfg is None:
            return None
        rule = cfg.rule_for(task.key)
        if rule is None:
            return None
        target = self.targets.target_for_arn(task.bucket,
                                             rule.destination_arn)
        if target is None:
            return None
        return target, target["target_bucket"]

    def _replicate(self, task: ReplicationTask) -> None:
        resolved = self._resolve(task)
        if resolved is None:
            return
        target, dest_bucket = resolved
        client = self._client_for(target)
        enc_key = urllib.parse.quote(task.key, safe="/-_.~")

        if task.op == "delete":
            # Delete-marker replication: plain DELETE creates the
            # marker on the target (ref replicateDelete,
            # cmd/bucket-replication.go:215).
            resp = client.request("DELETE", f"/{dest_bucket}/{enc_key}")
            if resp.status not in (200, 204):
                raise ReplicationError(f"delete -> {resp.status}")
            return

        data, info = self.reader(task.bucket, task.key, task.version_id)
        self._throttle(target, len(data))
        headers = {META_REPLICATION_STATUS: REPLICA}
        headers["content-type"] = info.metadata.get(
            "content-type", "application/octet-stream")
        for k, v in info.metadata.items():
            if k.startswith("x-amz-meta-") or k == "x-amz-tagging":
                headers[k] = v
        resp = client.put_object(dest_bucket, task.key, data,
                                 headers=headers)
        if resp.status != 200:
            raise ReplicationError(f"put -> {resp.status}")
        with self._stats_mu:
            self.stats["replicated_count"] += 1
            self.stats["replicated_bytes"] += len(data)
        self._set_status(task, COMPLETED)

    def _throttle(self, target: dict, nbytes: int) -> None:
        """Per-target token-bucket pacing (ref pkg/bandwidth
        LimitInBytesPerSecond wired into replication transfers): a
        capped target drains at ~its limit while uncapped targets
        proceed at full speed; workers on other targets are unaffected
        because each ARN has its own bucket."""
        limit = int(target.get("bandwidth_limit") or 0)
        if limit <= 0:
            return
        from ..utils.bandwidth import TokenBucket
        arn = target["arn"]
        with self._stats_mu:
            cur = self._limiters.get(arn)
            if cur is None or cur[0] != limit:
                cur = (limit, TokenBucket(limit))
                self._limiters[arn] = cur
        # A capped-but-idle target passes without sleeping; only count
        # a throttle when the token bucket actually stalled the worker.
        waited = cur[1].throttle(nbytes)
        if waited > 0:
            with self._stats_mu:
                self.stats["throttled_count"] += 1

    def _set_status(self, task: ReplicationTask, status: str) -> None:
        if task.op == "delete":
            return
        try:
            self.layer.update_object_metadata(
                task.bucket, task.key,
                {META_REPLICATION_STATUS: status}, task.version_id)
        except Exception:
            pass  # source version vanished meanwhile; nothing to mark
