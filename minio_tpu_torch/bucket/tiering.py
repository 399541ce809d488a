"""Remote tiers: ILM transition targets + transitioned-object IO (ref
cmd/tier.go TierConfigMgr, cmd/bucket-lifecycle.go transition flow,
admin `mc ilm tier add`).

A tier is a remote S3 endpoint + bucket + prefix. Transition moves an
object's STORED bytes (post-SSE/compression, so the envelope stays
intact) to the tier and leaves a zero-byte local stub whose metadata
carries the tier name + remote key; reads stream back through the tier
transparently (the reference's GetObjectNInfo does the same for
transitioned objects). RestoreObject re-materializes the data locally.

The port's own copy of ``minio_tpu/bucket/tiering.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
import time
import urllib.parse
import uuid

# Stub metadata keys (ref the xl.meta transition fields
# TransitionStatus/TransitionedObjName/TransitionTier).
META_TRANSITION_TIER = "x-minio-internal-transition-tier"
META_TRANSITION_KEY = "x-minio-internal-transition-key"
META_TRANSITION_SIZE = "x-minio-internal-transition-size"
META_TRANSITION_ETAG = "x-minio-internal-transition-etag"
META_RESTORE = "x-amz-restore"
META_RESTORE_EXPIRY = "x-minio-internal-restore-expiry"

TIERS_CONFIG_PATH = "tiers/config.json"


class TierError(Exception):
    pass


class TierManager:
    """Registry of remote tiers, persisted in the quorum ConfigStore
    (ref globalTierConfigMgr, cmd/tier.go)."""

    def __init__(self, store):
        self.store = store
        self._mu = threading.Lock()
        doc = store.load(TIERS_CONFIG_PATH)
        self._tiers: dict[str, dict] = doc["tiers"] if doc else {}

    # -- registry -------------------------------------------------------

    def add(self, name: str, endpoint: str, bucket: str,
            access_key: str, secret_key: str, prefix: str = "") -> None:
        from .replication import BucketTargetSys
        name = name.upper()
        if not name or not name.replace("-", "").replace(
                "_", "").isalnum():
            raise TierError(f"bad tier name {name!r}")
        endpoint = BucketTargetSys.normalize_endpoint(endpoint)
        with self._mu:
            if name in self._tiers:
                raise TierError(f"tier {name} already exists")
            self._tiers[name] = {
                "name": name, "endpoint": endpoint, "bucket": bucket,
                "access_key": access_key, "secret_key": secret_key,
                "prefix": prefix.strip("/"),
            }
            self._persist()

    def remove(self, name: str, layer=None) -> None:
        """Refuses removal while any object still references the tier
        (ref the in-use check of RemoveTier) when a layer is given."""
        name = name.upper()
        if layer is not None and self.get(name) is not None:
            for b in layer.list_buckets():
                for o in layer.list_objects(b["name"],
                                            max_keys=1_000_000):
                    if o.metadata.get(META_TRANSITION_TIER) == name:
                        raise TierError(
                            f"tier {name} is in use by "
                            f"{b['name']}/{o.name}")
        with self._mu:
            if self._tiers.pop(name, None) is not None:
                self._persist()

    def list(self) -> list[dict]:
        with self._mu:
            return [{k: v for k, v in t.items() if k != "secret_key"}
                    for t in self._tiers.values()]

    def get(self, name: str) -> dict | None:
        return self._tiers.get(name.upper())

    def _persist(self) -> None:
        self.store.save(TIERS_CONFIG_PATH, {"tiers": self._tiers})

    # -- remote IO ------------------------------------------------------

    def _client(self, tier: dict):
        from ..s3.client import S3Client
        host, _, port = tier["endpoint"].partition(":")
        return S3Client(host, int(port or 80), tier["access_key"],
                        tier["secret_key"])

    @staticmethod
    def _remote_key(tier: dict, bucket: str, key: str) -> str:
        # Unique remote name (ref TransitionedObjName uses a uuid).
        base = f"{bucket}/{key}/{uuid.uuid4().hex[:12]}"
        return f"{tier['prefix']}/{base}" if tier["prefix"] else base

    def upload(self, tier_name: str, bucket: str, key: str,
               data: bytes) -> str:
        """Push stored bytes to the tier; returns the remote key."""
        tier = self.get(tier_name)
        if tier is None:
            raise TierError(f"no such tier {tier_name!r}")
        remote_key = self._remote_key(tier, bucket, key)
        r = self._client(tier).put_object(tier["bucket"], remote_key,
                                          data)
        if r.status != 200:
            raise TierError(f"tier upload failed: {r.status}")
        return remote_key

    def read(self, meta: dict) -> bytes:
        """Stored bytes of a transitioned object, from its stub
        metadata."""
        tier = self.get(meta.get(META_TRANSITION_TIER, ""))
        if tier is None:
            raise TierError("tier vanished for transitioned object")
        r = self._client(tier).get_object(
            tier["bucket"], meta[META_TRANSITION_KEY])
        if r.status != 200:
            raise TierError(f"tier read failed: {r.status}")
        return r.body

    def delete_remote(self, meta: dict) -> None:
        tier = self.get(meta.get(META_TRANSITION_TIER, ""))
        if tier is None:
            return
        try:
            self._client(tier).delete_object(tier["bucket"],
                                             meta[META_TRANSITION_KEY])
        except Exception:
            pass  # best-effort GC; the tier bucket can be swept later


def is_transitioned(meta: dict) -> bool:
    """Object's data lives (also) on a tier."""
    return META_TRANSITION_TIER in meta


def restore_active(meta: dict, now: float | None = None) -> bool:
    raw = meta.get(META_RESTORE_EXPIRY)
    if raw is None:
        return False
    now = time.time() if now is None else now
    try:
        return float(raw) > now
    except ValueError:
        return False


def needs_tier_read(meta: dict, now: float | None = None) -> bool:
    """Reads must go to the tier: transitioned and no live restored
    copy (a restored object serves its LOCAL bytes until expiry, ref
    the restore semantics of GetObjectNInfo)."""
    return is_transitioned(meta) and not restore_active(meta, now)


def transition_object(layer, tiers: TierManager, bucket: str, key: str,
                      tier_name: str,
                      versioned: bool = False) -> bool:
    """Move one object's data to a tier, leaving a stub (ref
    transitionObject, cmd/bucket-lifecycle.go). Returns False when the
    object is not eligible (already transitioned / multipart /
    versioned bucket — a stub cannot replace a version in place)."""
    if versioned:
        return False
    info = layer.get_object_info(bucket, key)
    if is_transitioned(info.metadata):
        return False
    if len(info.parts) > 1:
        # Multipart SSE decryption needs per-part geometry the stub
        # wouldn't keep; skip (same effect as the reference's
        # restrictions on what a tier admits).
        return False
    data, info = layer.get_object(bucket, key)
    remote_key = tiers.upload(tier_name, bucket, key, data)

    meta = dict(info.metadata)
    meta[META_TRANSITION_TIER] = tier_name.upper()
    meta[META_TRANSITION_KEY] = remote_key
    meta[META_TRANSITION_SIZE] = str(info.size)
    meta[META_TRANSITION_ETAG] = info.etag
    meta["x-amz-storage-class"] = tier_name.upper()
    # Close the read-then-overwrite window: if anything re-wrote the
    # object since we read it, abandon the transition (the fresh data
    # wins) and GC the remote upload. The final race remains narrower
    # than one metadata read; a full fix needs an ns-lock spanning the
    # upload, which would stall the data path for the whole transfer.
    try:
        now_info = layer.get_object_info(bucket, key)
    except Exception:
        now_info = None
    if (now_info is None or now_info.etag != info.etag
            or now_info.mod_time != info.mod_time):
        tiers.delete_remote(meta)
        return False
    layer.put_object(bucket, key, b"", metadata=meta)
    try:
        layer.update_object_metadata(bucket, key,
                                     {"etag": info.etag})
    except Exception:
        pass
    return True


def restore_object(layer, tiers: TierManager, bucket: str, key: str,
                   days: int) -> None:
    """Re-materialize a transitioned object locally for `days`; the
    tier pointer stays so the crawler can re-stub after expiry and the
    remote copy is never duplicated (ref RestoreTransitionedObject /
    PostRestoreObjectHandler + restore-expiry handling)."""
    info = layer.get_object_info(bucket, key)
    meta = dict(info.metadata)
    if not is_transitioned(meta):
        raise TierError("object is not transitioned")
    data = tiers.read(meta)
    expiry = time.time() + days * 86400
    expiry_s = time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                             time.gmtime(expiry))
    restored = dict(meta)
    restored[META_RESTORE] = (f'ongoing-request="false", '
                              f'expiry-date="{expiry_s}"')
    restored[META_RESTORE_EXPIRY] = str(expiry)
    orig_etag = meta.get(META_TRANSITION_ETAG, info.etag)
    layer.put_object(bucket, key, data, metadata=restored)
    try:
        layer.update_object_metadata(bucket, key, {"etag": orig_etag})
    except Exception:
        pass


def restub_if_restore_expired(layer, bucket: str, key: str, meta: dict,
                              now: float | None = None) -> bool:
    """Turn an EXPIRED restored copy back into a stub (the crawler's
    restore-expiry sweep; the remote bytes never moved)."""
    now = time.time() if now is None else now
    if not (is_transitioned(meta) and META_RESTORE_EXPIRY in meta
            and not restore_active(meta, now)):
        return False
    stub = {k: v for k, v in meta.items()
            if k not in (META_RESTORE, META_RESTORE_EXPIRY)}
    orig_etag = stub.get(META_TRANSITION_ETAG, "")
    layer.put_object(bucket, key, b"", metadata=stub)
    if orig_etag:
        try:
            layer.update_object_metadata(bucket, key,
                                         {"etag": orig_etag})
        except Exception:
            pass
    return True
