"""Bucket metadata subsystem.

The reference persists one `.metadata.bin` per bucket under
`.minio.sys/buckets/<bucket>/` holding every bucket-scoped config —
policy, notification, lifecycle, SSE, tagging, quota, object-lock,
versioning, replication — loaded at startup and peer-invalidated on
change (ref cmd/bucket-metadata-sys.go, cmd/bucket-metadata.go).

Here the same document is canonical JSON stored through the quorum
ConfigStore on the system's own disks; reads are cached with a short
TTL so cross-node updates converge without a peer-notification channel
(same trade the IAM store makes).

The port's own copy of ``minio_tpu/bucket/metadata.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..iam.iam import ConfigStore

BUCKET_META_PREFIX = "buckets"

VERSIONING_ENABLED = "Enabled"
VERSIONING_SUSPENDED = "Suspended"


@dataclass
class BucketMetadata:
    """All bucket-scoped configs (ref BucketMetadata,
    cmd/bucket-metadata.go:71-94 — which likewise stores each config as
    its raw serialized document)."""
    name: str = ""
    created: float = 0.0
    versioning: str = ""            # "", Enabled, Suspended
    policy: dict | None = None      # bucket policy JSON document
    tagging_xml: str = ""           # <Tagging> config
    lifecycle_xml: str = ""         # <LifecycleConfiguration>
    notification_xml: str = ""      # <NotificationConfiguration>
    sse_xml: str = ""               # <ServerSideEncryptionConfiguration>
    object_lock_xml: str = ""       # <ObjectLockConfiguration>
    replication_xml: str = ""       # <ReplicationConfiguration>
    quota: dict | None = None       # {"quota": bytes, "quotaType": "hard"}
    replication_targets: list = field(default_factory=list)
    cors_xml: str = ""              # <CORSConfiguration>

    _FIELDS = ("name", "created", "versioning", "policy", "tagging_xml",
               "lifecycle_xml", "notification_xml", "sse_xml",
               "object_lock_xml", "replication_xml", "quota",
               "replication_targets", "cors_xml")

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._FIELDS}

    @classmethod
    def from_dict(cls, d: dict) -> "BucketMetadata":
        return cls(**{k: d[k] for k in cls._FIELDS if k in d})

    def versioning_enabled(self) -> bool:
        return self.versioning == VERSIONING_ENABLED

    def versioning_suspended(self) -> bool:
        return self.versioning == VERSIONING_SUSPENDED


class BucketMetadataSys:
    """Registry of per-bucket metadata (ref BucketMetadataSys,
    cmd/bucket-metadata-sys.go:36)."""

    CACHE_TTL = 1.0

    def __init__(self, store: ConfigStore):
        self.store = store
        self._mu = threading.RLock()
        self._cache: dict[str, tuple[float, BucketMetadata]] = {}
        # Peer push: set to NotificationSys.load_bucket_metadata /
        # delete_bucket_metadata in distributed mode so other nodes
        # drop their cache immediately instead of waiting out CACHE_TTL
        # (ref peerRESTMethodLoadBucketMetadata).
        self.notify_update = None
        self.notify_delete = None

    @classmethod
    def for_layer(cls, layer) -> "BucketMetadataSys":
        """Config store on the first erasure set's disks — the same
        place `.minio.sys` system config lives (works for a bare
        engine, ErasureSets, or ErasureServerPools)."""
        if hasattr(layer, "pools"):
            disks = layer.pools[0].sets[0].disks
        elif hasattr(layer, "sets"):
            disks = layer.sets[0].disks
        elif hasattr(layer, "meta_disk"):  # FS backend: single root
            disks = [layer.meta_disk]
        else:
            disks = layer.disks
        return cls(ConfigStore(disks))

    def _path(self, bucket: str) -> str:
        return f"{BUCKET_META_PREFIX}/{bucket}/bucket-metadata.json"

    def _load(self, bucket: str) -> BucketMetadata:
        doc = self.store.load(self._path(bucket))
        return (BucketMetadata.from_dict(doc) if doc
                else BucketMetadata(name=bucket, created=time.time()))

    def get(self, bucket: str) -> BucketMetadata:
        with self._mu:
            hit = self._cache.get(bucket)
            if hit and time.time() - hit[0] < self.CACHE_TTL:
                return hit[1]
        meta = self._load(bucket)
        with self._mu:
            self._cache[bucket] = (time.time(), meta)
        return meta

    def invalidate(self, bucket: str) -> None:
        """Drop the cache entry (peer-push target: next get() re-reads
        the quorum-stored document)."""
        with self._mu:
            self._cache.pop(bucket, None)

    def save(self, meta: BucketMetadata) -> None:
        self.store.save(self._path(meta.name), meta.to_dict())
        with self._mu:
            self._cache[meta.name] = (time.time(), meta)
        if self.notify_update is not None:
            self.notify_update(meta.name)

    def update(self, bucket: str, **fields) -> BucketMetadata:
        """Atomic read-modify-write of one or more config sections: the
        lock serializes concurrent updaters (no lost fields), the copy
        keeps a failed quorum save from polluting the read cache."""
        with self._mu:
            meta = BucketMetadata.from_dict(self._load(bucket).to_dict())
            for k, v in fields.items():
                if not hasattr(meta, k):
                    raise AttributeError(f"unknown bucket config: {k}")
                setattr(meta, k, v)
            meta.name = bucket
            self.store.save(self._path(bucket), meta.to_dict())
            self._cache[bucket] = (time.time(), meta)
        if self.notify_update is not None:
            self.notify_update(bucket)
        return meta

    def delete(self, bucket: str) -> None:
        self.store.delete(self._path(bucket))
        with self._mu:
            self._cache.pop(bucket, None)
        if self.notify_delete is not None:
            self.notify_delete(bucket)

    # -- convenience ----------------------------------------------------

    def versioning_enabled(self, bucket: str) -> bool:
        return self.get(bucket).versioning_enabled()

    def versioning_suspended(self, bucket: str) -> bool:
        return self.get(bucket).versioning_suspended()
