"""S3-compatible HTTP server: router + object/bucket handlers.

The analog of the reference's L1/L2 (ref cmd/routers.go:86 middleware
chain, cmd/api-router.go:82 route table, cmd/object-handlers.go,
cmd/bucket-handlers.go), over Python stdlib http.server (threaded) with
the erasure object engine as the ObjectLayer.

The port's own copy of ``minio_tpu/s3/server.py``, with no change in
behaviour but the device seam: SelectObjectContent scans on the object
layer's device (``layer.device``: the card for a card-built stack, the
CPU for a CPU-built one), never on a device of its own choosing; and
``stop`` releases the loop monitor, whose last release stops its threads;
and a server started without a layer reads ``codec probe_on_boot`` from
``MINIO_CODEC_PROBE_ON_BOOT`` (the reference always probes then).
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..erasure.engine import (BucketExists, BucketNotFound, ErasureObjects,
                              MethodNotAllowed, ObjectInfo, ObjectNotFound)
from ..fs.backend import ParentIsObject
from ..parallel.quorum import QuorumError
from . import errors as s3err
from . import sigv4
from .errors import APIError
from .xmlutil import S3_XMLNS, Element, parse

MAX_OBJECT_SIZE = 5 * 1024 * 1024 * 1024  # single-PUT cap (5 GiB)


def _drain_stream(stream) -> bytes:
    """Fully buffer a body stream (paths that still need whole-body
    transforms: SSE, compression, signature fallback)."""
    parts = []
    while chunk := stream.read(1 << 20):
        parts.append(chunk)
    return b"".join(parts)


def _trim_iter(it, skip: int, limit: int):
    """Yield exactly `limit` bytes of `it` after dropping `skip`."""
    for chunk in it:
        if skip:
            if len(chunk) <= skip:
                skip -= len(chunk)
                continue
            chunk = chunk[skip:]
            skip = 0
        if limit <= 0:
            break
        if len(chunk) > limit:
            chunk = chunk[:limit]
        yield chunk
        limit -= len(chunk)
        if limit <= 0:
            break


def _mime_for(key: str) -> str:
    """Content type from the key's extension (ref pkg/mimedb — the
    reference ships a 4.6k-line codegen table; Python's mimetypes
    covers the same registry)."""
    import mimetypes
    return mimetypes.guess_type(key)[0] or "application/octet-stream"


def _iso8601(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(t))


def _http_date(t: float) -> str:
    return email.utils.formatdate(t, usegmt=True)


def _parse_range(header: str, size: int) -> tuple[int, int] | None:
    """Parse 'bytes=a-b' -> (offset, length); None = whole object.
    Raises InvalidRange when unsatisfiable (ref cmd/httprange.go)."""
    if not header:
        return None
    if not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):]
    if "," in spec:  # multiple ranges unsupported, serve whole object
        return None
    start_s, _, end_s = spec.partition("-")
    try:
        if start_s == "":
            n = int(end_s)  # suffix: last n bytes
            if n <= 0:
                raise s3err.ERR_INVALID_RANGE
            n = min(n, size)
            return size - n, n
        start = int(start_s)
        if end_s == "":
            if start >= size:
                raise s3err.ERR_INVALID_RANGE
            return start, size - start
        end = int(end_s)
        if start > end or start >= size:
            raise s3err.ERR_INVALID_RANGE
        return start, min(end, size - 1) - start + 1
    except ValueError:
        return None


class S3Request:
    """Parsed request context."""

    def __init__(self, method: str, raw_path: str, query: str,
                 headers: dict[str, str], body: bytes):
        self.method = method
        self.raw_path = raw_path
        self.query = query
        self.headers = headers  # lowercase keys
        self.body = body
        # Large object PUTs arrive as a chunk reader instead of bytes
        # (body stays b""): the handler pipes it into the engine's
        # block pipeline without ever buffering the object.
        self.body_stream = None
        self.content_length = len(body)
        self.params = dict(urllib.parse.parse_qsl(
            query, keep_blank_values=True))
        path = urllib.parse.unquote(raw_path)
        parts = path.lstrip("/").split("/", 1)
        self.bucket = parts[0] if parts[0] else ""
        self.key = parts[1] if len(parts) > 1 else ""
        self.request_id = uuid.uuid4().hex[:16].upper()
        # QoS/slowlog annotations, stamped by route_qos: admission
        # class, measured queue wait, opened budget, and whether this
        # request was DELIBERATE backpressure (shed / burnt deadline)
        # — exempt from slow-request capture by design.
        self.qos_class = ""
        self.qos_wait_ms = 0.0
        self.qos_deadline_s = 0.0
        self.slowlog_exempt = False


class S3Response:
    def __init__(self, status: int = 200, body: bytes = b"",
                 headers: dict[str, str] | None = None):
        self.status = status
        self.body = body
        self.headers = headers or {}


def check_preconditions(req: "S3Request", info: "ObjectInfo",
                        prefix: str = "") -> int:
    """Evaluate conditional headers against the object; returns 0 (ok),
    304 or 412 (ref checkPreconditions, cmd/object-handlers-common.go;
    copy-source variants use the x-amz-copy-source-if-* names)."""
    h = req.headers
    etag = info.etag
    not_modified = (304 if req.method in ("GET", "HEAD") and not prefix
                    else 412)
    if_match = h.get(f"{prefix}if-match", "")
    if if_match:
        if if_match.strip('"') != etag and if_match != "*":
            return 412
        # A passing If-Match supersedes If-Unmodified-Since (RFC 7232
        # §6 / ref checkPreconditions ordering).
    elif (ius := h.get(f"{prefix}if-unmodified-since", "")):
        try:
            t = email.utils.parsedate_to_datetime(ius).timestamp()
            if info.mod_time > t:
                return 412
        except (TypeError, ValueError):
            pass
    if_none = h.get(f"{prefix}if-none-match", "")
    if if_none:
        if if_none == "*" or if_none.strip('"') == etag:
            return not_modified
        # If-None-Match present: If-Modified-Since is IGNORED.
    elif (ims := h.get(f"{prefix}if-modified-since", "")):
        try:
            t = email.utils.parsedate_to_datetime(ims).timestamp()
            if info.mod_time <= t:
                return not_modified
        except (TypeError, ValueError):
            pass
    return 0


class S3ApiHandlers:
    """S3 operations over an ObjectLayer (duck-typed ErasureObjects)."""

    def __init__(self, layer: ErasureObjects, region: str = "us-east-1",
                 bucket_meta=None, notifier=None):
        self.layer = layer
        self.region = region
        self.server = None  # S3Server backref (set by set_layer)
        if bucket_meta is None:
            from ..bucket.metadata import BucketMetadataSys
            bucket_meta = BucketMetadataSys.for_layer(layer)
        self.bucket_meta = bucket_meta
        import os as _os
        self.compress_enabled = _os.environ.get(
            "MINIO_COMPRESS", "") == "on"
        if notifier is None:
            from ..event.notifier import NotificationSys
            notifier = NotificationSys(bucket_meta, region)
        self.notifier = notifier
        from ..crypto.sse import LocalKMS
        self.kms = LocalKMS.from_env()
        # External KMS (KES): SSE-S3 object keys seal under per-object
        # data keys the KMS generates; the local master is then unused
        # (ref cmd/crypto/kms.go KES integration).
        from ..crypto.kms import KESClient
        self.kes = KESClient.from_env()
        from ..bucket.replication import ReplicationPool
        self.replication = ReplicationPool(
            self.bucket_meta, self.read_for_replication, layer)
        from ..bucket.tiering import TierManager
        self.tiers = TierManager(self.bucket_meta.store)
        from ..config.storageclass import StorageClassConfig
        self.storage_class = StorageClassConfig.from_env()
        self._usage_cache: dict[str, tuple[float, int]] = {}
        self._usage_mu = threading.Lock()
        # Federation (ref globalDNSConfig): BucketDNS + this cluster's
        # public address, set by server boot when etcd is configured.
        self.bucket_dns = None
        self.public_addr: tuple[str, int] | None = None

    # ---------------- storage class / quota ----------------

    def _parity_for_request(self, req: S3Request) -> int | None:
        """Parity override from x-amz-storage-class (ref the
        GetParityForSC call in putObject, cmd/erasure-object.go:597);
        None = layer default (also for FS, which has no shards)."""
        from ..config import storageclass as sc
        sc_hdr = req.headers.get("x-amz-storage-class", "")
        n = getattr(self.layer, "k", 0) + getattr(self.layer, "m", 0)
        if n < 2:
            # FS layer: REGEN needs erasure shards, so it is invalid
            # here just like any unknown class.
            if sc_hdr and sc_hdr not in (sc.STANDARD, sc.RRS):
                raise s3err.ERR_INVALID_STORAGE_CLASS
            return None
        try:
            return self.storage_class.parity_for(
                sc_hdr, n, getattr(self.layer, "m", 0))
        except sc.InvalidStorageClass:
            raise s3err.ERR_INVALID_STORAGE_CLASS

    def _regen_algorithm_for_request(self, req: S3Request) -> str | None:
        """The erasure algorithm stamp for this PUT: pm-mbr-rbt when
        the REGEN class applies (per-request header or the bucket's
        regen_buckets config default), None otherwise.  Only erasure
        layers qualify; multipart uploads stay plain-RS (the part
        pipeline re-splits on byte boundaries the regen stripe layout
        does not honor)."""
        n = getattr(self.layer, "k", 0) + getattr(self.layer, "m", 0)
        if n < 2:
            return None
        sc_hdr = req.headers.get("x-amz-storage-class", "")
        if self.storage_class.use_regen(sc_hdr, req.bucket):
            from ..storage.metadata import REGEN_ALGORITHM
            return REGEN_ALGORITHM
        return None

    # A full listing re-baselines a bucket's usage counter at most
    # this often; between reconciles the counter moves incrementally
    # with each write/delete, so quota PUT latency is independent of
    # object count (ref enforceBucketQuota's
    # crawler dataUsageCache, cmd/bucket-quota.go).
    USAGE_RECONCILE_TTL = 300.0

    def _usage_baseline(self, bucket: str, newer_than: float = 0.0,
                        ) -> int:
        """Authoritative re-count: the crawler's usage tree when it has
        scanned this bucket SINCE the previous baseline (an older crawl
        would erase writes the counter already tracked), else one full
        listing."""
        crawler = getattr(self.server, "crawler", None)
        if crawler is not None:
            cached = crawler.data_usage()
            entry = cached.get("buckets", {}).get(bucket)
            if entry is not None and cached.get("lastUpdate",
                                                0) >= newer_than:
                return int(entry.get("size", 0))
        meta = self.bucket_meta.get(bucket)
        if meta.versioning:  # every stored version consumes quota
            infos = self.layer.list_object_versions(bucket,
                                                    max_keys=1_000_000)
        else:
            infos = self.layer.list_objects(bucket, max_keys=1_000_000)
        return sum(i.size for i in infos)

    def _bucket_usage(self, bucket: str) -> int:
        """Incrementally tracked total stored bytes: baseline once (or
        after the reconcile TTL / a version-state change), then moved
        by _usage_add on every handler write/delete."""
        with self._usage_mu:
            hit = self._usage_cache.get(bucket)
            if hit and time.time() - hit[0] < self.USAGE_RECONCILE_TTL:
                return hit[1]
        total = self._usage_baseline(bucket,
                                     newer_than=hit[0] if hit else 0.0)
        with self._usage_mu:
            self._usage_cache[bucket] = (time.time(), total)
        return total

    def _usage_add(self, bucket: str, delta: int) -> None:
        """Move the tracked counter; no-op until the baseline exists
        (quota-less buckets never pay for tracking)."""
        with self._usage_mu:
            hit = self._usage_cache.get(bucket)
            if hit is not None:
                self._usage_cache[bucket] = (hit[0],
                                             max(0, hit[1] + delta))

    def _usage_replaced_size(self, bucket: str, key: str,
                             versioned: bool) -> int:
        """Bytes an unversioned overwrite is about to free (0 when the
        counter is inactive, the bucket versions writes, or the key is
        new) — overwrites must not inflate tracked usage."""
        if versioned or self._usage_cache.get(bucket) is None:
            return 0
        try:
            return self.layer.get_object_info(bucket, key).size
        except Exception:
            return 0

    def _check_quota(self, bucket: str, incoming: int) -> None:
        q = self.bucket_meta.get(bucket).quota
        if not q or not q.get("quota"):
            return
        if q.get("quotaType", "hard") != "hard":
            return  # FIFO/soft quotas don't reject writes
        if self._bucket_usage(bucket) + incoming > int(q["quota"]):
            raise s3err.ERR_QUOTA_EXCEEDED

    # ---------------- replication plumbing ----------------

    def read_for_replication(self, bucket: str, key: str,
                             version_id: str = ""):
        """Logical object bytes + info for the replication worker —
        SSE-S3 decrypts under the local KMS, SSE-C is unreadable
        server-side (the reference likewise skips SSE-C sources)."""
        from ..crypto import sse
        from ..utils import compress
        info = self.layer.get_object_info(bucket, key, version_id)
        mode = sse.is_encrypted(info.metadata)
        if mode == sse.SSE_C:
            raise ValueError("SSE-C objects cannot be replicated")
        from ..bucket import tiering as tier_mod
        if tier_mod.needs_tier_read(info.metadata):
            fake = S3Request("GET", f"/{bucket}", "", {}, b"")
            return self._transitioned_plain(fake, info), info
        if mode:
            okey = sse.unseal_key(
                self._sse_s3_master(info.metadata, bucket, key),
                info.metadata[sse.META_SEALED_KEY], mode, bucket, key)
            data = self._sse_decrypt_read(version_id, info, okey, 0,
                                          info.size)
        else:
            data, info = self.layer.get_object(bucket, key,
                                               version_id=version_id)
        if info.metadata.get(compress.META_COMPRESSION):
            data = compress.decompress_stream(data)
        return data, info

    def _replication_decision(self, req: S3Request, meta: dict) -> None:
        """Stamp the new object's replication status before the write:
        REPLICA for incoming replica traffic, PENDING when a rule
        matches (ref mustReplicate, cmd/bucket-replication.go:100)."""
        from ..bucket.replication import (META_REPLICATION_STATUS,
                                          PENDING, REPLICA)
        if req.headers.get(META_REPLICATION_STATUS) == REPLICA:
            meta[META_REPLICATION_STATUS] = REPLICA
        elif self.replication.must_replicate(req.bucket, req.key):
            meta[META_REPLICATION_STATUS] = PENDING

    def _queue_replication(self, req: S3Request, info: ObjectInfo,
                           meta: dict) -> None:
        from ..bucket.replication import META_REPLICATION_STATUS, PENDING
        if meta.get(META_REPLICATION_STATUS) == PENDING:
            self.replication.queue_task(req.bucket, req.key,
                                        info.version_id, "put")

    def _notify(self, event_name: str, bucket: str, key: str,
                info: ObjectInfo | None = None,
                user: str = "") -> None:
        """Fire a bucket event (ref sendEvent calls at the end of every
        object handler, cmd/object-handlers.go)."""
        from ..event.event import Event
        self.notifier.send(Event(
            event_name=event_name, bucket=bucket, key=key,
            size=info.size if info else 0,
            etag=info.etag if info else "",
            version_id=info.version_id if info else "",
            region=self.region, user_identity=user))

    def _versioned(self, bucket: str) -> bool:
        return self.bucket_meta.versioning_enabled(bucket)

    @staticmethod
    def _version_param(req: S3Request) -> str:
        """The literal 'null' addresses the null (unversioned) version,
        which is the empty id internally (ref nullVersionID handling)."""
        vid = req.params.get("versionId", "")
        return "" if vid == "null" else vid

    # ---------------- service ----------------

    def list_buckets(self, req: S3Request) -> S3Response:
        root = Element("ListAllMyBucketsResult", S3_XMLNS)
        owner = root.child("Owner")
        owner.child("ID", "minio-tpu")
        owner.child("DisplayName", "minio-tpu")
        buckets = root.child("Buckets")
        for b in self.layer.list_buckets():
            e = buckets.child("Bucket")
            e.child("Name", b["name"])
            e.child("CreationDate", _iso8601(b["created"]))
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    # ---------------- bucket ----------------

    def make_bucket(self, req: S3Request) -> S3Response:
        if not (3 <= len(req.bucket) <= 63) or not all(
                c.islower() or c.isdigit() or c in ".-"
                for c in req.bucket):
            raise s3err.ERR_INVALID_BUCKET_NAME
        if self.bucket_dns is not None:
            # Federation namespace is GLOBAL: refuse names another
            # cluster already owns (ref initFederatorBackend +
            # MakeBucket DNS check, cmd/bucket-handlers.go).
            try:
                owners = self.bucket_dns.lookup(req.bucket,
                                                cached=False)
            except Exception:
                owners = []
            if any(o != self.public_addr for o in owners):
                raise s3err.ERR_BUCKET_ALREADY_EXISTS
        try:
            self.layer.make_bucket(req.bucket)
        except BucketExists:
            raise s3err.ERR_BUCKET_ALREADY_EXISTS
        if req.headers.get(
                "x-amz-bucket-object-lock-enabled", "").lower() == "true":
            # Lock can only be enabled at creation; it force-enables
            # versioning (ref MakeBucketWithObjectLock,
            # cmd/bucket-handlers.go).
            if not getattr(self.layer, "supports_versioning", True):
                self.layer.delete_bucket(req.bucket)
                raise s3err.ERR_NOT_IMPLEMENTED  # FS: no versioning
            from ..bucket import objectlock as ol
            self.bucket_meta.update(req.bucket,
                                    object_lock_xml=ol.ENABLED_XML,
                                    versioning="Enabled")
        if self.bucket_dns is not None and self.public_addr:
            # Federation: advertise this bucket cluster-wide (ref
            # bucket DNS add on MakeBucket, cmd/bucket-handlers.go).
            try:
                self.bucket_dns.register(req.bucket, *self.public_addr)
            except Exception:
                from ..logger import Logger
                Logger.get().log_once(
                    f"bucket DNS register failed for {req.bucket}",
                    "bucket-dns")
        return S3Response(200, headers={"Location": f"/{req.bucket}"})

    def head_bucket(self, req: S3Request) -> S3Response:
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET
        return S3Response(200)

    def delete_bucket(self, req: S3Request) -> S3Response:
        try:
            self.layer.delete_bucket(req.bucket)
        except BucketNotFound:
            raise s3err.ERR_NO_SUCH_BUCKET
        except BucketExists:
            raise s3err.ERR_BUCKET_NOT_EMPTY
        # Drop every bucket-scoped config with the bucket — a later
        # bucket of the same name must start clean (ref deleteBucket
        # metadata cleanup, cmd/bucket-metadata-sys.go).
        self.bucket_meta.delete(req.bucket)
        if self.bucket_dns is not None:
            try:
                self.bucket_dns.unregister(req.bucket)
            except Exception:
                pass
        return S3Response(204)

    def get_location(self, req: S3Request) -> S3Response:
        # us-east-1 renders as an empty LocationConstraint.
        body = (b'<?xml version="1.0" encoding="UTF-8"?>'
                b'<LocationConstraint xmlns="' + S3_XMLNS.encode() +
                b'"></LocationConstraint>')
        return S3Response(200, body,
                          {"Content-Type": "application/xml"})

    def list_objects(self, req: S3Request) -> S3Response:
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET
        v2 = req.params.get("list-type") == "2"
        prefix = req.params.get("prefix", "")
        delimiter = req.params.get("delimiter", "")
        max_keys = min(int(req.params.get("max-keys", "1000") or "1000"),
                       1000)
        marker = (req.params.get("continuation-token")
                  or req.params.get("start-after")
                  or req.params.get("marker", ""))
        if req.params.get("continuation-token"):
            marker = base64.b64decode(marker).decode()

        infos = self.layer.list_objects(req.bucket, prefix=prefix,
                                        max_keys=1_000_000)
        contents: list[ObjectInfo] = []
        common: list[str] = []
        seen_prefix: set[str] = set()
        truncated = False
        next_marker = ""
        for info in infos:
            name = info.name
            if marker and name <= marker:
                continue
            if delimiter:
                rest = name[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp not in seen_prefix:
                        if len(contents) + len(seen_prefix) >= max_keys:
                            truncated = True
                            break
                        seen_prefix.add(cp)
                        common.append(cp)
                        next_marker = cp.rstrip(delimiter)
                    continue
            if len(contents) + len(seen_prefix) >= max_keys:
                truncated = True
                break
            contents.append(info)
            next_marker = name

        root = Element("ListBucketResult", S3_XMLNS)
        root.child("Name", req.bucket)
        root.child("Prefix", prefix)
        root.child("MaxKeys", max_keys)
        root.child("Delimiter", delimiter)
        root.child("IsTruncated", truncated)
        if v2:
            root.child("KeyCount", len(contents) + len(common))
            if truncated and next_marker:
                root.child("NextContinuationToken",
                           base64.b64encode(
                               next_marker.encode()).decode())
        elif truncated and next_marker:
            root.child("NextMarker", next_marker)
        for info in contents:
            c = root.child("Contents")
            c.child("Key", info.name)
            c.child("LastModified", _iso8601(info.mod_time))
            c.child("ETag", f'"{info.etag}"')
            c.child("Size", self._actual_size(info))
            c.child("StorageClass", info.metadata.get(
                "x-amz-storage-class", "STANDARD"))
        for cp in common:
            p = root.child("CommonPrefixes")
            p.child("Prefix", cp)
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def delete_multiple(self, req: S3Request) -> S3Response:
        try:
            doc = parse(req.body)
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        quiet = doc.findtext("Quiet") == "true"
        versioned = self._versioned(req.bucket)
        root = Element("DeleteResult", S3_XMLNS)
        for obj in doc.findall("Object"):
            key = obj.findtext("Key") or ""
            vid = obj.findtext("VersionId") or ""
            if vid == "null":
                vid = ""
            try:
                self._check_version_delete_allowed(
                    req.bucket, key, vid,
                    self._can_bypass_governance(req))
                freed = 0
                if (self._usage_cache.get(req.bucket) is not None
                        and not (versioned and not vid)):
                    try:
                        freed = self.layer.get_object_info(
                            req.bucket, key, vid).size
                    except Exception:
                        freed = 0
                deleted = self.layer.delete_object(req.bucket, key, vid,
                                                   versioned=versioned)
                if not deleted.delete_marker and freed:
                    self._usage_add(req.bucket, -freed)
                from ..event import event as ev
                self._notify(
                    ev.OBJECT_REMOVED_DELETE_MARKER
                    if deleted.delete_marker else ev.OBJECT_REMOVED_DELETE,
                    req.bucket, key, deleted)
                if not quiet:
                    d = root.child("Deleted")
                    d.child("Key", key)
                    if vid:
                        d.child("VersionId", vid)
                    if deleted.delete_marker:
                        d.child("DeleteMarker", True)
                        if deleted.version_id:
                            d.child("DeleteMarkerVersionId",
                                    deleted.version_id)
            except ObjectNotFound:
                if not quiet:  # S3 treats missing keys as deleted
                    d = root.child("Deleted")
                    d.child("Key", key)
            except APIError as e2:
                e = root.child("Error")
                e.child("Key", key)
                e.child("Code", e2.code)
            except Exception:
                e = root.child("Error")
                e.child("Key", key)
                e.child("Code", "InternalError")
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    # ---------------- object ----------------

    @staticmethod
    def _object_headers(info: ObjectInfo) -> dict[str, str]:
        h = {
            "ETag": f'"{info.etag}"',
            "Last-Modified": _http_date(info.mod_time),
            "Accept-Ranges": "bytes",
            "Content-Type": info.metadata.get(
                "content-type", "application/octet-stream"),
        }
        if info.version_id:
            h["x-amz-version-id"] = info.version_id
        if "x-amz-replication-status" in info.metadata:
            h["x-amz-replication-status"] = \
                info.metadata["x-amz-replication-status"]
        for k, v in info.metadata.items():
            if k.startswith("x-amz-meta-"):
                h[k] = v
        return h

    # ---------------- compression plumbing ----------------

    def _maybe_compress(self, key: str, body: bytes, meta: dict) -> bytes:
        """Transparent compression before erasure coding when enabled
        and the payload looks compressible (ref isCompressible gate +
        newS2CompressReader wrap, cmd/object-api-utils.go:436,898)."""
        from ..crypto import sse
        from ..utils import compress
        if not getattr(self.layer, "supports_transforms", True):
            return body  # gateway: upstream gets the raw payload
        if not self.compress_enabled:
            return body
        if not compress.is_compressible(
                key, meta.get("content-type", ""), len(body)):
            return body
        meta[compress.META_COMPRESSION] = compress.CODEC_TAG
        meta[sse.META_ACTUAL_SIZE] = str(len(body))
        return compress.compress_stream(body)

    def _wrap_transform_readers(self, req: S3Request, body,
                                meta: dict, size_hint: int):
        """Streaming PUT transform chain: plain -> [compress] ->
        [encrypt], each a Reader emitting the byte-identical format of
        its buffered counterpart. The readers stamp META_ACTUAL_SIZE
        into `meta` at EOF — the engine reads metadata only at commit,
        after the stream is fully consumed."""
        from ..crypto import sse
        from ..utils import compress
        if (self.compress_enabled
                and getattr(self.layer, "supports_transforms", True)
                and compress.is_compressible(
                    req.key, meta.get("content-type", ""), size_hint)):
            meta[compress.META_COMPRESSION] = compress.CODEC_TAG
            body = compress.CompressingReader(body, meta)
        picked = self._sse_mode_for_request(req)
        if picked is not None:
            okey = self._sse_seal_into_meta(req, *picked, meta)
            body = sse.EncryptingReader(body, okey, meta)
        return body

    # ---------------- SSE plumbing ----------------

    def _bucket_default_sse(self, bucket: str) -> bool:
        """Bucket default encryption config requests SSE-S3 (ref
        validateBucketSSEConfig + auto-encrypt on put)."""
        raw = self.bucket_meta.get(bucket).sse_xml
        return bool(raw) and "AES256" in raw

    def _sse_mode_for_request(self, req: S3Request,
                              ) -> tuple[str, bytes] | None:
        """(mode, master-key) the request asks for, None = plain.
        Single source of truth for both single-PUT and multipart."""
        from ..crypto import sse
        try:
            ckey = sse.parse_ssec_key(req.headers)
        except sse.SSEError:
            raise s3err.ERR_INVALID_SSE_PARAMS
        if not getattr(self.layer, "supports_transforms", True):
            if ckey is not None or req.headers.get(sse.H_SSE):
                # No local envelope through a gateway (the reference
                # rejects SSE in gateway mode without backend SSE).
                raise s3err.ERR_NOT_IMPLEMENTED
            return None
        if ckey is not None:
            return sse.SSE_C, ckey
        if (req.headers.get(sse.H_SSE) == "AES256"
                or self._bucket_default_sse(req.bucket)):
            if self.kes is not None:
                # External KMS: the per-object data key is generated at
                # seal time; no local master involved.
                return sse.SSE_S3, b""
            if not self.kms.configured:
                # Never encrypt under an ephemeral master — the data
                # would be unrecoverable after restart (the reference
                # refuses SSE-S3 without a configured KMS).
                raise s3err.ERR_INVALID_SSE_PARAMS
            return sse.SSE_S3, self.kms.master
        return None

    def _sse_seal_into_meta(self, req: S3Request, mode: str,
                            master: bytes, meta: dict) -> bytes:
        """Create the object key, record the envelope; returns the key."""
        from ..crypto import sse
        okey = sse.new_object_key()
        meta[sse.META_ALGORITHM] = mode
        if mode == sse.SSE_S3 and self.kes is not None:
            from ..crypto.kms import KMSError
            try:
                master, wrapped = self.kes.generate_key(req.bucket,
                                                        req.key)
            except KMSError:
                raise s3err.ERR_INTERNAL_ERROR
            meta[sse.META_KMS_DATA_KEY] = wrapped
            meta[sse.META_KMS_KEY_ID] = self.kes.key_id
        elif mode == sse.SSE_S3:
            meta[sse.META_KMS_KEY_ID] = self.kms.key_id
        meta[sse.META_SEALED_KEY] = sse.seal_key(
            master, okey, mode, req.bucket, req.key)
        if mode == sse.SSE_C:
            meta[sse.META_KEY_MD5] = req.headers[sse.H_SSEC_KEY_MD5]
        return okey

    def _sse_s3_master(self, metadata: dict, bucket: str,
                       key: str) -> bytes:
        """The key that sealed an SSE-S3 object's envelope: a KMS data
        key (unwrapped via KES) when the object carries one, else the
        local master."""
        from ..crypto import sse
        wrapped = metadata.get(sse.META_KMS_DATA_KEY, "")
        if wrapped:
            if self.kes is None:
                raise s3err.ERR_INVALID_SSE_PARAMS
            from ..crypto.kms import KMSError
            try:
                return self.kes.decrypt_key(wrapped, bucket, key)
            except KMSError:
                raise s3err.ERR_INTERNAL_ERROR
        return self.kms.master

    def _sse_encrypt_body(self, req: S3Request, body: bytes,
                          meta: dict) -> bytes:
        """Encrypt an incoming object body when the request (or the
        bucket default) asks for SSE; records the envelope in internal
        metadata (ref EncryptRequest, cmd/encryption-v1.go:228)."""
        from ..crypto import sse
        picked = self._sse_mode_for_request(req)
        if picked is None:
            return body
        okey = self._sse_seal_into_meta(req, *picked, meta)
        # Compression may already have recorded the ORIGINAL length.
        meta.setdefault(sse.META_ACTUAL_SIZE, str(len(body)))
        return sse.encrypt_stream(body, okey)

    def _sse_unseal_from_meta(self, req: S3Request, metadata: dict,
                              bucket: str, key: str,
                              copy_source: bool = False) -> bytes | None:
        """Object key from an SSE envelope in metadata (validating
        SSE-C credentials); None when not encrypted (ref
        DecryptObjectInfo, cmd/encryption-v1.go:780)."""
        from ..crypto import sse
        mode = sse.is_encrypted(metadata)
        if not mode:
            return None
        if mode == sse.SSE_C:
            try:
                ckey = sse.parse_ssec_key(req.headers, copy_source)
            except sse.SSEError:
                raise s3err.ERR_SSE_KEY_MISMATCH
            if ckey is None:
                raise s3err.ERR_SSE_KEY_REQUIRED
            master = ckey
        else:
            master = self._sse_s3_master(metadata, bucket, key)
        try:
            return sse.unseal_key(master, metadata[sse.META_SEALED_KEY],
                                  mode, bucket, key)
        except sse.KeyMismatch:
            raise s3err.ERR_SSE_KEY_MISMATCH

    def _sse_unseal_for_read(self, req: S3Request, info: ObjectInfo,
                             copy_source: bool = False) -> bytes | None:
        return self._sse_unseal_from_meta(req, info.metadata,
                                          info.bucket, info.name,
                                          copy_source)

    @staticmethod
    def _sse_response_headers(info: ObjectInfo) -> dict:
        from ..crypto import sse
        mode = sse.is_encrypted(info.metadata)
        if mode == sse.SSE_C:
            return {sse.H_SSEC_ALGO: "AES256",
                    sse.H_SSEC_KEY_MD5:
                        info.metadata.get(sse.META_KEY_MD5, "")}
        if mode == sse.SSE_S3:
            return {sse.H_SSE: "AES256"}
        return {}

    @staticmethod
    def _actual_size(info: ObjectInfo) -> int:
        from ..bucket import tiering
        from ..crypto import sse
        raw = info.metadata.get(sse.META_ACTUAL_SIZE)
        if raw is not None:
            return int(raw)
        tsize = info.metadata.get(tiering.META_TRANSITION_SIZE)
        if tsize is not None and info.size == 0:
            return int(tsize)  # stub: logical size lives in metadata
        return info.size

    def _transitioned_plain(self, req: S3Request, info: ObjectInfo,
                            okey: bytes | None = None,
                            okey_known: bool = False) -> bytes:
        """Full plaintext of a transitioned object, streamed back from
        its tier (ref the transitioned-object read path of
        GetObjectNInfo, cmd/bucket-lifecycle.go). Raises
        tiering.TierError when the tier is unreachable/removed."""
        from ..bucket import tiering
        from ..crypto import sse
        from ..utils import compress
        raw = self.tiers.read(info.metadata)
        if not okey_known:
            okey = self._sse_unseal_for_read(req, info)
        if okey is not None:
            def read_fn(off, ln):
                if off is None:
                    return len(raw)
                return raw[off:off + ln]
            raw = sse.decrypt_range(read_fn, okey, 0, len(raw))
        if info.metadata.get(compress.META_COMPRESSION):
            raw = compress.decompress_stream(raw)
        return raw

    def _sse_decrypt_read(self, version_id: str, info: ObjectInfo,
                          okey: bytes, offset: int,
                          length: int) -> bytes:
        """Read [offset, offset+length) of the PLAINTEXT, touching only
        the parts/packages that cover the range. Multipart ciphertexts
        are per-part DARE streams (per-part derived keys) stitched by
        part sizes (ref DecryptBlocksRequestR part-boundary walk,
        cmd/encryption-v1.go:356)."""
        from ..crypto import sse
        multipart = info.metadata.get(sse.META_SSE_MULTIPART) == "1"

        def ranged_read(base_off, size_limit):
            def read_fn(off, ln):
                if off is None:
                    return size_limit
                data, _ = self.layer.get_object(
                    info.bucket, info.name, offset=base_off + off,
                    length=min(ln, size_limit - off),
                    version_id=version_id)
                return data
            return read_fn

        try:
            if not multipart:
                return sse.decrypt_range(ranged_read(0, info.size),
                                         okey, offset, length)
            # Walk parts by PLAINTEXT offsets; decrypt only coverers.
            out = []
            plain_pos = ct_pos = 0
            want_end = offset + length
            for p in info.parts:
                plain_end = plain_pos + p.actual_size
                if plain_end <= offset:
                    plain_pos, ct_pos = plain_end, ct_pos + p.size
                    continue
                if plain_pos >= want_end:
                    break
                pkey = sse.derive_part_key(okey, p.number)
                sub_off = max(0, offset - plain_pos)
                sub_len = min(plain_end, want_end) - \
                    (plain_pos + sub_off)
                out.append(sse.decrypt_range(
                    ranged_read(ct_pos, p.size), pkey, sub_off,
                    sub_len))
                plain_pos, ct_pos = plain_end, ct_pos + p.size
            return b"".join(out)
        except sse.SSEError:
            raise s3err.ERR_INTERNAL_ERROR

    def put_object(self, req: S3Request) -> S3Response:
        from ..utils import compress, streams
        from ..utils.phasetimer import PUT as _PUT
        if "x-amz-copy-source" in req.headers:
            return self.copy_object(req)
        _t_start = time.perf_counter()
        size_hint = (req.content_length if req.body_stream is not None
                     else len(req.body))
        if size_hint > MAX_OBJECT_SIZE:
            raise s3err.ERR_ENTITY_TOO_LARGE
        meta = {"content-type": req.headers.get("content-type")
                or _mime_for(req.key)}
        # Only non-streaming layers (gateways) buffer the body; SSE and
        # compression run as streaming transform readers in the chain
        # below, so every PUT keeps O(batch) memory (ref sio/S2 reader
        # pipelines, cmd/encryption-v1.go:201,
        # cmd/object-api-utils.go:898).
        if req.body_stream is not None and not getattr(
                self.layer, "supports_streaming_put", False):
            req.body = _drain_stream(req.body_stream)
            req.body_stream = None
            req.content_length = len(req.body)
        md5_header = req.headers.get("content-md5", "")
        want_md5 = base64.b64decode(md5_header) if md5_header else None
        if req.body_stream is None and want_md5 is not None:
            if hashlib.md5(req.body).digest() != want_md5:
                raise s3err.ERR_BAD_DIGEST
        for k, v in req.headers.items():
            if k.startswith("x-amz-meta-"):
                meta[k] = v
        if "x-amz-tagging" in req.headers:
            meta["x-amz-tagging"] = req.headers["x-amz-tagging"]
        self._apply_lock_headers(req, meta)
        parity = self._parity_for_request(req)
        algorithm = self._regen_algorithm_for_request(req)
        if req.headers.get("x-amz-storage-class"):
            meta["x-amz-storage-class"] = req.headers[
                "x-amz-storage-class"]
        self._check_quota(req.bucket, max(size_hint, 0))
        if req.body_stream is not None:
            # Verify declared md5/sha256/length at stream end — a
            # mismatch aborts the engine write before commit (ref
            # pkg/hash/reader.go).
            sha_hdr = req.headers.get("x-amz-content-sha256", "")
            want_sha = sha_hdr if len(sha_hdr) == 64 else ""
            body = streams.HashingReader(
                req.body_stream, want_md5=want_md5,
                want_sha256=want_sha,
                expect_size=req.content_length)
            body = self._wrap_transform_readers(req, body, meta,
                                                max(size_hint, 0))
        else:
            body = self._maybe_compress(req.key, req.body, meta)
            body = self._sse_encrypt_body(req, body, meta)
        self._replication_decision(req, meta)
        versioned = self._versioned(req.bucket)
        replaced = self._usage_replaced_size(req.bucket, req.key,
                                             versioned)
        _PUT.record("transform",
                    (time.perf_counter() - _t_start) * 1e3)
        _t_layer = time.perf_counter()
        try:
            # algorithm only reaches erasure layers (the FS layer's
            # put_object has no such seam, and _regen_algorithm_for_
            # request answers None there).
            extra = {"algorithm": algorithm} if algorithm else {}
            info = self.layer.put_object(
                req.bucket, req.key, body, metadata=meta,
                versioned=versioned,
                parity_shards=parity, **extra)
        except streams.ChecksumError as e:
            if "MD5" in str(e):
                raise s3err.ERR_BAD_DIGEST
            raise s3err.ERR_SIGNATURE_DOES_NOT_MATCH
        except BucketNotFound:
            raise s3err.ERR_NO_SUCH_BUCKET
        except MethodNotAllowed:
            raise s3err.ERR_NOT_IMPLEMENTED
        except ParentIsObject:
            raise s3err.ERR_PARENT_IS_OBJECT
        _t_post = time.perf_counter()
        _PUT.record("layer_total", (_t_post - _t_layer) * 1e3)
        self._usage_add(req.bucket, info.size - replaced)
        h = {"ETag": f'"{info.etag}"'}
        h.update(self._sse_response_headers(info))
        if info.version_id:
            h["x-amz-version-id"] = info.version_id
        from ..event import event as ev
        self._notify(ev.OBJECT_CREATED_PUT, req.bucket, req.key, info)
        self._queue_replication(req, info, meta)
        _PUT.record("post", (time.perf_counter() - _t_post) * 1e3)
        return S3Response(200, headers=h)

    def copy_object(self, req: S3Request) -> S3Response:
        src = urllib.parse.unquote(req.headers["x-amz-copy-source"])
        src = src.lstrip("/")
        if "/" not in src:
            raise s3err.ERR_INVALID_ARGUMENT
        sbucket, skey = src.split("/", 1)
        from ..crypto import sse
        from ..utils import compress
        try:
            data, sinfo = self._read_object_plain(
                req, bucket=sbucket, key=skey, copy_source=True)
        except (ObjectNotFound, BucketNotFound):
            raise s3err.ERR_NO_SUCH_KEY
        if check_preconditions(req, sinfo,
                               prefix="x-amz-copy-source-"):
            raise s3err.ERR_PRECONDITION_FAILED
        meta = dict(sinfo.metadata)
        if req.headers.get("x-amz-metadata-directive") == "REPLACE":
            meta = {"content-type": req.headers.get(
                "content-type", "application/octet-stream")}
            for k, v in req.headers.items():
                if k.startswith("x-amz-meta-"):
                    meta[k] = v
        # The copy re-evaluates encryption/compression for the
        # destination; the source's envelope must never leak across.
        from ..bucket import objectlock as ol
        from ..bucket import tiering as tier_mod
        from ..bucket.replication import META_REPLICATION_STATUS
        for k in (sse.META_ALGORITHM, sse.META_SEALED_KEY,
                  sse.META_KEY_MD5, sse.META_KMS_KEY_ID,
                  sse.META_ACTUAL_SIZE, compress.META_COMPRESSION,
                  META_REPLICATION_STATUS, ol.META_MODE,
                  ol.META_RETAIN_UNTIL, ol.META_LEGAL_HOLD,
                  tier_mod.META_TRANSITION_TIER,
                  tier_mod.META_TRANSITION_KEY,
                  tier_mod.META_TRANSITION_SIZE,
                  tier_mod.META_TRANSITION_ETAG,
                  tier_mod.META_RESTORE, tier_mod.META_RESTORE_EXPIRY,
                  "etag"):
            meta.pop(k, None)
        self._apply_lock_headers(req, meta)
        self._check_quota(req.bucket, len(data))
        data = self._maybe_compress(req.key, data, meta)
        data = self._sse_encrypt_body(req, data, meta)
        self._replication_decision(req, meta)
        versioned = self._versioned(req.bucket)
        replaced = self._usage_replaced_size(req.bucket, req.key,
                                             versioned)
        info = self.layer.put_object(req.bucket, req.key, data,
                                     metadata=meta,
                                     versioned=versioned)
        self._usage_add(req.bucket, info.size - replaced)
        self._queue_replication(req, info, meta)
        root = Element("CopyObjectResult", S3_XMLNS)
        root.child("ETag", f'"{info.etag}"')
        root.child("LastModified", _iso8601(info.mod_time))
        from ..event import event as ev
        self._notify(ev.OBJECT_CREATED_COPY, req.bucket, req.key, info)
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def _read_object_plain(self, req: S3Request, version_id: str = "",
                           bucket: str | None = None,
                           key: str | None = None,
                           copy_source: bool = False,
                           ) -> tuple[bytes, "ObjectInfo"]:
        """Full object bytes after SSE decrypt + decompression — the
        shared tail of CopyObject's source read and SELECT's scan (ref
        the GetObjectNInfo pipeline both reuse)."""
        from ..utils import compress
        bucket = req.bucket if bucket is None else bucket
        key = req.key if key is None else key
        info = self.layer.get_object_info(bucket, key, version_id)
        from ..bucket import tiering as tier_mod
        if tier_mod.needs_tier_read(info.metadata):
            try:
                return self._transitioned_plain(req, info), info
            except tier_mod.TierError as e:
                raise s3err.APIError("XMinioTierError", str(e), 503)
        okey = self._sse_unseal_for_read(req, info,
                                         copy_source=copy_source)
        if okey is not None:
            data = self._sse_decrypt_read(version_id, info, okey, 0,
                                          info.size)
        else:
            data, info = self.layer.get_object(bucket, key,
                                               version_id=version_id)
        if info.metadata.get(compress.META_COMPRESSION):
            try:
                data = compress.decompress_stream(data)
            except ValueError:
                raise s3err.ERR_INTERNAL_ERROR
        return data, info

    def select_object_content(self, req: S3Request) -> S3Response:
        """POST /bucket/key?select&select-type=2 (ref
        SelectObjectContentHandler, cmd/object-handlers.go; routed
        cmd/api-router.go:161)."""
        from ..s3select.select import S3SelectError, parse_request, \
            run_select
        try:
            sel = parse_request(req.body)
        except S3SelectError as e:
            raise s3err.APIError(e.code, e.description, 400)
        version_id = self._version_param(req)
        try:
            data, info = self._read_object_plain(req, version_id)
        except BucketNotFound:
            raise s3err.ERR_NO_SUCH_BUCKET
        except MethodNotAllowed:
            raise s3err.ERR_METHOD_NOT_ALLOWED
        except ObjectNotFound:
            if version_id:
                raise s3err.ERR_NO_SUCH_VERSION
            raise s3err.ERR_NO_SUCH_KEY
        from ..event import event as ev
        self._notify(ev.OBJECT_ACCESSED_GET, req.bucket, req.key, info)
        # The scan runs where the object layer's kernels run: the card
        # for a card-built stack, the CPU for a CPU-built one.
        return S3Response(200, run_select(sel, data,
                                          device=self.layer.device),
                          {"Content-Type": "application/octet-stream"})

    def get_object(self, req: S3Request, head: bool = False) -> S3Response:
        version_id = self._version_param(req)
        try:
            from ..utils import compress
            info = self.layer.get_object_info(req.bucket, req.key,
                                              version_id)
            okey = self._sse_unseal_for_read(req, info)
            comp = info.metadata.get(compress.META_COMPRESSION)
            # Ranges address the PLAINTEXT for transformed objects (ref
            # DecryptObjectInfo size rewrite).
            size = self._actual_size(info)
            status = check_preconditions(req, info)
            if status == 304:
                return S3Response(304, b"",
                                  self._object_headers(info))
            if status == 412:
                raise s3err.ERR_PRECONDITION_FAILED
            rng = _parse_range(req.headers.get("range", ""), size)
            data = b""
            from ..bucket import tiering as tier_mod
            if not head and tier_mod.needs_tier_read(info.metadata):
                try:
                    plain = self._transitioned_plain(
                        req, info, okey=okey, okey_known=True)
                except tier_mod.TierError as e:
                    raise s3err.APIError("XMinioTierError", str(e), 503)
                data = (plain if rng is None
                        else plain[rng[0]:rng[0] + rng[1]])
            elif not head:
                stream_fn = getattr(self.layer, "get_object_stream",
                                    None)
                from ..crypto import sse as sse_mod
                # Multipart SSE streams are per-part stitched — the
                # ranged (buffered-per-package-window) path handles
                # them; single-part objects stream end-to-end.
                sse_streamable = (
                    okey is not None and stream_fn is not None
                    and len(info.parts) <= 1
                    and not info.metadata.get(sse_mod.META_SSE_MULTIPART))
                if comp:
                    # SSE's inner plaintext IS the compressed stream;
                    # its length <= stored size, so that bound reads all.
                    if okey is not None:
                        if sse_streamable and info.size > 0:
                            _, ct = stream_fn(req.bucket, req.key,
                                              offset=0,
                                              length=info.size,
                                              version_id=version_id)
                            plain_iter = sse_mod.iter_decrypt(
                                ct, okey, info.size)
                        else:
                            plain_iter = iter([self._sse_decrypt_read(
                                version_id, info, okey, 0, info.size)])
                    elif stream_fn is not None:
                        _, plain_iter = stream_fn(
                            req.bucket, req.key, version_id=version_id)
                    else:
                        blob, _ = self.layer.get_object(
                            req.bucket, req.key, version_id=version_id)
                        plain_iter = iter([blob])
                    try:
                        # Streaming decompress; errors mid-iteration
                        # surface when the response body is consumed.
                        if rng is None:
                            data = compress.iter_decompress(plain_iter)
                        else:
                            data = compress.iter_decompress_range(
                                plain_iter, rng[0], rng[1])
                        if stream_fn is None:
                            data = b"".join(data)
                    except ValueError:
                        raise s3err.ERR_INTERNAL_ERROR
                elif okey is not None:
                    off, ln = rng if rng is not None else (0, size)
                    if ln <= 0:
                        # Still authenticate package 0 (an empty object
                        # has one sealed empty final package — tampering
                        # must surface, not be skipped).
                        data = self._sse_decrypt_read(
                            version_id, info, okey, 0, 0)
                    elif sse_streamable:
                        # Package-aligned ciphertext range -> streaming
                        # decrypt -> trim to the requested plaintext
                        # window. O(package) memory for any size.
                        full = sse_mod.PKG_SIZE + sse_mod.PKG_OVERHEAD
                        first = off // sse_mod.PKG_SIZE
                        last = (off + ln - 1) // sse_mod.PKG_SIZE
                        base_blob, _ = self.layer.get_object(
                            req.bucket, req.key, offset=0, length=8,
                            version_id=version_id)
                        ct_off = 8 + first * full
                        ct_len = min(info.size - ct_off,
                                     (last - first + 1) * full)
                        _, ct = stream_fn(req.bucket, req.key,
                                          offset=ct_off, length=ct_len,
                                          version_id=version_id)
                        import itertools
                        plain = sse_mod.iter_decrypt(
                            itertools.chain([base_blob], ct), okey,
                            info.size, first_pkg=first, last_pkg=last)
                        data = _trim_iter(plain,
                                          off - first * sse_mod.PKG_SIZE,
                                          ln)
                    else:
                        data = self._sse_decrypt_read(
                            version_id, info, okey, off, ln)
                else:
                    # Plain object: stream decoded blocks straight to
                    # the socket when the layer supports it (O(group)
                    # memory for any object size).
                    off, ln = rng if rng is not None else (0, size)
                    stream_fn = getattr(self.layer, "get_object_stream",
                                        None)
                    if stream_fn is not None:
                        info, data = stream_fn(req.bucket, req.key,
                                               offset=off, length=ln,
                                               version_id=version_id)
                    else:
                        data, info = self.layer.get_object(
                            req.bucket, req.key, offset=off, length=ln,
                            version_id=version_id)
        except BucketNotFound:
            raise s3err.ERR_NO_SUCH_BUCKET
        except MethodNotAllowed:
            raise s3err.ERR_METHOD_NOT_ALLOWED
        except ObjectNotFound:
            if version_id:
                raise s3err.ERR_NO_SUCH_VERSION
            raise s3err.ERR_NO_SUCH_KEY

        headers = self._object_headers(info)
        headers.update(self._sse_response_headers(info))
        from ..event import event as ev
        self._notify(ev.OBJECT_ACCESSED_HEAD if head
                     else ev.OBJECT_ACCESSED_GET,
                     req.bucket, req.key, info)
        if head:
            headers["Content-Length"] = str(size)
            return S3Response(200, b"", headers)
        if not isinstance(data, (bytes, bytearray)):
            headers["Content-Length"] = str(
                rng[1] if rng is not None else size)
        if rng is not None:
            off, ln = rng
            headers["Content-Range"] = (
                f"bytes {off}-{off + ln - 1}/{size}")
            return S3Response(206, data, headers)
        return S3Response(200, data, headers)

    # ---------------- multipart ----------------

    def _sse_init_multipart(self, req: S3Request, meta: dict) -> None:
        """Create the upload's SSE envelope at initiate time; each part
        then encrypts under a key DERIVED from this object key by part
        number (ref newMultipartUpload + DerivePartKey)."""
        from ..crypto import sse
        picked = self._sse_mode_for_request(req)
        if picked is None:
            return
        self._sse_seal_into_meta(req, *picked, meta)
        meta[sse.META_SSE_MULTIPART] = "1"

    def _sse_part_key(self, req: S3Request,
                      part_number: int) -> bytes | None:
        """Per-part derived key for an encrypted upload; the per-part
        request must carry SSE-C credentials again (ref PutObjectPart
        SSE checks)."""
        from ..crypto import sse
        from ..erasure.multipart import UploadNotFound
        try:
            meta = self.layer.multipart.get_upload_meta(
                req.bucket, req.key, req.params["uploadId"])
        except UploadNotFound:
            raise s3err.ERR_NO_SUCH_UPLOAD
        okey = self._sse_unseal_from_meta(req, meta, req.bucket, req.key)
        if okey is None:
            return None
        return sse.derive_part_key(okey, part_number)

    def initiate_multipart(self, req: S3Request) -> S3Response:
        from ..erasure.engine import BucketNotFound as BNF
        meta = {"content-type": req.headers.get(
            "content-type", "application/octet-stream")}
        for k, v in req.headers.items():
            if k.startswith("x-amz-meta-"):
                meta[k] = v
        self._apply_lock_headers(req, meta)
        self._sse_init_multipart(req, meta)
        try:
            upload_id = self.layer.multipart.new_multipart_upload(
                req.bucket, req.key, meta)
        except BNF:
            raise s3err.ERR_NO_SUCH_BUCKET
        root = Element("InitiateMultipartUploadResult", S3_XMLNS)
        root.child("Bucket", req.bucket)
        root.child("Key", req.key)
        root.child("UploadId", upload_id)
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def upload_part_copy(self, req: S3Request) -> S3Response:
        """PUT ?partNumber&uploadId with x-amz-copy-source: source
        bytes (optionally x-amz-copy-source-range) become the part
        (ref CopyObjectPartHandler, cmd/object-handlers.go)."""
        from ..erasure.multipart import InvalidPart, UploadNotFound
        src = urllib.parse.unquote(req.headers["x-amz-copy-source"])
        src = src.lstrip("/")
        if "/" not in src:
            raise s3err.ERR_INVALID_ARGUMENT
        sbucket, skey = src.split("/", 1)
        try:
            data, sinfo = self._read_object_plain(
                req, bucket=sbucket, key=skey, copy_source=True)
        except (ObjectNotFound, BucketNotFound):
            raise s3err.ERR_NO_SUCH_KEY
        if check_preconditions(req, sinfo,
                               prefix="x-amz-copy-source-"):
            raise s3err.ERR_PRECONDITION_FAILED
        rng = req.headers.get("x-amz-copy-source-range", "")
        if rng:
            parsed = _parse_range(rng, len(data))
            if parsed is None:
                raise s3err.ERR_INVALID_ARGUMENT
            off, ln = parsed
            data = data[off:off + ln]
        if len(data) > MAX_OBJECT_SIZE:
            raise s3err.ERR_ENTITY_TOO_LARGE
        self._check_quota(req.bucket, len(data))
        part_number = int(req.params["partNumber"])
        body, actual = data, None
        pkey = self._sse_part_key(req, part_number)
        if pkey is not None:
            from ..crypto import sse
            body = sse.encrypt_stream(data, pkey)
            actual = len(data)
        try:
            part = self.layer.multipart.put_object_part(
                req.bucket, req.key, req.params["uploadId"],
                part_number, body, actual_size=actual)
        except UploadNotFound:
            raise s3err.ERR_NO_SUCH_UPLOAD
        except (InvalidPart, ValueError):
            raise s3err.ERR_INVALID_ARGUMENT
        root = Element("CopyPartResult", S3_XMLNS)
        root.child("ETag", f'"{part["etag"]}"')
        root.child("LastModified", _iso8601(time.time()))
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def put_part(self, req: S3Request) -> S3Response:
        from ..erasure.multipart import InvalidPart, UploadNotFound
        from ..utils import streams
        part_number = int(req.params["partNumber"])
        pkey = self._sse_part_key(req, part_number)
        if req.body_stream is not None and (
                pkey is not None
                or not getattr(self.layer, "supports_streaming_put",
                               False)):
            # Encrypted parts (whole-part DARE transform) and
            # non-streaming layers still buffer.
            req.body = _drain_stream(req.body_stream)
            req.body_stream = None
            req.content_length = len(req.body)
        size_hint = (req.content_length if req.body_stream is not None
                     else len(req.body))
        if size_hint > MAX_OBJECT_SIZE:
            raise s3err.ERR_ENTITY_TOO_LARGE
        md5_header = req.headers.get("content-md5", "")
        want_md5 = base64.b64decode(md5_header) if md5_header else None
        if req.body_stream is None and want_md5 is not None:
            if hashlib.md5(req.body).digest() != want_md5:
                raise s3err.ERR_BAD_DIGEST
        self._check_quota(req.bucket, max(size_hint, 0))
        actual = None
        if req.body_stream is not None:
            body = streams.HashingReader(
                req.body_stream, want_md5=want_md5,
                expect_size=req.content_length)
        else:
            body = req.body
            if pkey is not None:
                from ..crypto import sse
                body = sse.encrypt_stream(req.body, pkey)
                actual = len(req.body)
        try:
            part = self.layer.multipart.put_object_part(
                req.bucket, req.key, req.params["uploadId"],
                part_number, body, actual_size=actual)
        except streams.ChecksumError as e:
            if "MD5" in str(e):
                raise s3err.ERR_BAD_DIGEST
            raise s3err.ERR_SIGNATURE_DOES_NOT_MATCH
        except UploadNotFound:
            raise s3err.ERR_NO_SUCH_UPLOAD
        except (InvalidPart, ValueError):
            raise s3err.ERR_INVALID_ARGUMENT
        return S3Response(200, headers={"ETag": f'"{part["etag"]}"'})

    def complete_multipart(self, req: S3Request) -> S3Response:
        from ..erasure.multipart import (InvalidPart, PartTooSmall,
                                         UploadNotFound)
        try:
            doc = parse(req.body)
            parts = [(int(p.findtext("PartNumber")),
                      (p.findtext("ETag") or "").strip('"'))
                     for p in doc.findall("Part")]
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        try:
            staged = self.layer.multipart.list_parts(
                req.bucket, req.key, req.params["uploadId"])
            self._check_quota(req.bucket,
                              sum(p["size"] for p in staged))
            replaced = self._usage_replaced_size(
                req.bucket, req.key, self._versioned(req.bucket))
            info = self.layer.multipart.complete_multipart_upload(
                req.bucket, req.key, req.params["uploadId"], parts)
            self._usage_add(req.bucket, info.size - replaced)
        except UploadNotFound:
            raise s3err.ERR_NO_SUCH_UPLOAD
        except PartTooSmall:
            raise s3err.ERR_ENTITY_TOO_SMALL
        except InvalidPart as e:
            if "ascending" in str(e):
                raise s3err.ERR_INVALID_PART_ORDER
            raise s3err.ERR_INVALID_PART
        except ParentIsObject:
            raise s3err.ERR_PARENT_IS_OBJECT
        root = Element("CompleteMultipartUploadResult", S3_XMLNS)
        root.child("Location",
                   f"http://{req.headers.get('host', '')}"
                   f"/{req.bucket}/{req.key}")
        root.child("Bucket", req.bucket)
        root.child("Key", req.key)
        root.child("ETag", f'"{info.etag}"')
        from ..event import event as ev
        self._notify(ev.OBJECT_CREATED_COMPLETE_MULTIPART,
                     req.bucket, req.key, info)
        # Multipart metadata was fixed at initiate time; stamp + queue
        # the replication AFTER the stitch (ref CompleteMultipartUpload
        # replication hook, cmd/object-handlers.go).
        if self.replication.must_replicate(req.bucket, req.key):
            from ..bucket.replication import (META_REPLICATION_STATUS,
                                              PENDING)
            try:
                self.layer.update_object_metadata(
                    req.bucket, req.key,
                    {META_REPLICATION_STATUS: PENDING}, info.version_id)
            except Exception:
                pass
            self.replication.queue_task(req.bucket, req.key,
                                        info.version_id, "put")
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def abort_multipart(self, req: S3Request) -> S3Response:
        from ..erasure.multipart import UploadNotFound
        try:
            self.layer.multipart.abort_multipart_upload(
                req.bucket, req.key, req.params["uploadId"])
        except UploadNotFound:
            raise s3err.ERR_NO_SUCH_UPLOAD
        return S3Response(204)

    def list_parts(self, req: S3Request) -> S3Response:
        from ..erasure.multipart import UploadNotFound
        try:
            parts = self.layer.multipart.list_parts(
                req.bucket, req.key, req.params["uploadId"])
        except UploadNotFound:
            raise s3err.ERR_NO_SUCH_UPLOAD
        root = Element("ListPartsResult", S3_XMLNS)
        root.child("Bucket", req.bucket)
        root.child("Key", req.key)
        root.child("UploadId", req.params["uploadId"])
        root.child("IsTruncated", False)
        for p in parts:
            e = root.child("Part")
            e.child("PartNumber", p["number"])
            e.child("ETag", f'"{p["etag"]}"')
            # Logical (pre-SSE/compression) size, as AWS reports.
            e.child("Size", p.get("actualSize", p["size"]))
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def list_multipart_uploads(self, req: S3Request) -> S3Response:
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET
        uploads = self.layer.multipart.list_uploads(
            req.bucket, req.params.get("prefix", ""))
        root = Element("ListMultipartUploadsResult", S3_XMLNS)
        root.child("Bucket", req.bucket)
        root.child("IsTruncated", False)
        for u in uploads:
            e = root.child("Upload")
            e.child("Key", u["object"])
            e.child("UploadId", u["upload_id"])
            e.child("Initiated", _iso8601(u["created"]))
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    # ---------------- versioning ----------------

    def get_versioning(self, req: S3Request) -> S3Response:
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET
        status = self.bucket_meta.get(req.bucket).versioning
        root = Element("VersioningConfiguration", S3_XMLNS)
        if status:
            root.child("Status", status)
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def put_versioning(self, req: S3Request) -> S3Response:
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET
        try:
            doc = parse(req.body)
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        status = doc.findtext("Status") or ""
        if status not in ("Enabled", "Suspended"):
            raise s3err.ERR_MALFORMED_XML
        if not getattr(self.layer, "supports_versioning", True):
            # ref FS backend: versioning APIs -> NotImplemented
            raise s3err.ERR_NOT_IMPLEMENTED
        if status == "Suspended" and self._lock_config(req.bucket).enabled:
            # Suspension would turn plain deletes into data-destroying
            # deletes, voiding WORM (AWS: InvalidBucketState).
            raise s3err.ERR_INVALID_BUCKET_STATE
        self.bucket_meta.update(req.bucket, versioning=status)
        return S3Response(200)

    def list_object_versions(self, req: S3Request) -> S3Response:
        """GET /bucket?versions with key-marker/version-id-marker
        pagination (ref ListObjectVersionsHandler,
        cmd/bucket-listobjects-handlers.go)."""
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET
        prefix = req.params.get("prefix", "")
        delimiter = req.params.get("delimiter", "")
        key_marker = req.params.get("key-marker", "")
        vid_marker = req.params.get("version-id-marker", "")
        max_keys = min(int(req.params.get("max-keys", "1000") or "1000"),
                       1000)
        try:
            infos = self.layer.list_object_versions(
                req.bucket, prefix=prefix, max_keys=1_000_000)
        except MethodNotAllowed:
            raise s3err.ERR_NOT_IMPLEMENTED  # FS backend (ref fs-v1.go:1444)
        # Build the flat entry stream first: delimiter collapse, latest
        # flags; then cut one page out of it.
        latest_seen: set[str] = set()
        seen_prefix: set[str] = set()
        entries: list[tuple] = []  # (kind, info-or-prefix, is_latest)
        for info in infos:
            if delimiter:
                rest = info.name[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp not in seen_prefix:
                        seen_prefix.add(cp)
                        entries.append(("prefix", cp, False))
                    continue
            is_latest = info.name not in latest_seen
            latest_seen.add(info.name)
            entries.append(("version", info, is_latest))

        start = 0
        if key_marker:
            for i, (kind, item, _) in enumerate(entries):
                key = item if kind == "prefix" else item.name
                vid = "" if kind == "prefix" else (item.version_id
                                                   or "null")
                if key < key_marker:
                    start = i + 1
                elif key == key_marker:
                    # With a version-id-marker resume AFTER that exact
                    # version; without, skip the whole marker key.
                    start = i + 1
                    if vid_marker and vid == vid_marker:
                        break
                else:
                    break
        page = entries[start:start + max_keys]
        truncated = start + max_keys < len(entries)

        root = Element("ListVersionsResult", S3_XMLNS)
        root.child("Name", req.bucket)
        root.child("Prefix", prefix)
        if key_marker:
            root.child("KeyMarker", key_marker)
        if vid_marker:
            root.child("VersionIdMarker", vid_marker)
        root.child("MaxKeys", max_keys)
        if delimiter:
            root.child("Delimiter", delimiter)
        root.child("IsTruncated", truncated)
        if truncated and page:
            kind, item, _ = page[-1]
            root.child("NextKeyMarker",
                       item if kind == "prefix" else item.name)
            if kind != "prefix":
                root.child("NextVersionIdMarker",
                           item.version_id or "null")
        for kind, item, is_latest in page:
            if kind == "prefix":
                p = root.child("CommonPrefixes")
                p.child("Prefix", item)
                continue
            e = root.child("DeleteMarker" if item.delete_marker
                           else "Version")
            e.child("Key", item.name)
            e.child("VersionId", item.version_id or "null")
            e.child("IsLatest", is_latest)
            e.child("LastModified", _iso8601(item.mod_time))
            if not item.delete_marker:
                e.child("ETag", f'"{item.etag}"')
                e.child("Size", self._actual_size(item))
                e.child("StorageClass", "STANDARD")
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    # ---------------- bucket configs ----------------

    def _check_bucket_exists(self, req: S3Request) -> None:
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET

    def get_bucket_policy(self, req: S3Request) -> S3Response:
        self._check_bucket_exists(req)
        policy = self.bucket_meta.get(req.bucket).policy
        if not policy:
            raise s3err.ERR_NO_SUCH_BUCKET_POLICY
        import json as _json
        return S3Response(200, _json.dumps(policy).encode(),
                          {"Content-Type": "application/json"})

    def put_bucket_policy(self, req: S3Request) -> S3Response:
        self._check_bucket_exists(req)
        import json as _json
        try:
            policy = _json.loads(req.body)
            if not isinstance(policy, dict) or "Statement" not in policy:
                raise ValueError
        except ValueError:
            raise s3err.ERR_MALFORMED_POLICY
        self.bucket_meta.update(req.bucket, policy=policy)
        return S3Response(204)

    def delete_bucket_policy(self, req: S3Request) -> S3Response:
        self._check_bucket_exists(req)
        self.bucket_meta.update(req.bucket, policy=None)
        return S3Response(204)

    def _xml_config(self, req: S3Request, field: str, root_tag: str,
                    missing: s3err.APIError) -> S3Response:
        """Shared GET/PUT/DELETE plumbing for XML bucket configs
        (lifecycle, notification, sse, tagging, object-lock,
        replication — ref cmd/bucket-*-handlers.go)."""
        self._check_bucket_exists(req)
        if req.method == "GET":
            raw = getattr(self.bucket_meta.get(req.bucket), field)
            if not raw:
                raise missing
            return S3Response(200, raw.encode(),
                              {"Content-Type": "application/xml"})
        if req.method == "DELETE":
            self.bucket_meta.update(req.bucket, **{field: ""})
            return S3Response(204)
        # PUT: validate the XML parses and the root tag matches.
        try:
            doc = parse(req.body)
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        if root_tag not in doc.tag:
            raise s3err.ERR_MALFORMED_XML
        self.bucket_meta.update(req.bucket,
                                **{field: req.body.decode("utf-8")})
        return S3Response(200)

    def bucket_lifecycle(self, req: S3Request) -> S3Response:
        return self._xml_config(req, "lifecycle_xml",
                                "LifecycleConfiguration",
                                s3err.ERR_NO_SUCH_LIFECYCLE_CONFIG)

    def bucket_notification(self, req: S3Request) -> S3Response:
        # GET of an unset notification config returns an empty document,
        # not an error (ref GetBucketNotificationHandler).
        self._check_bucket_exists(req)
        if req.method == "GET" and not self.bucket_meta.get(
                req.bucket).notification_xml:
            root = Element("NotificationConfiguration", S3_XMLNS)
            return S3Response(200, root.tobytes(),
                              {"Content-Type": "application/xml"})
        return self._xml_config(req, "notification_xml",
                                "NotificationConfiguration",
                                s3err.ERR_MALFORMED_XML)

    def bucket_encryption(self, req: S3Request) -> S3Response:
        return self._xml_config(req, "sse_xml",
                                "ServerSideEncryptionConfiguration",
                                s3err.ERR_NO_SUCH_SSE_CONFIG)

    def bucket_tagging(self, req: S3Request) -> S3Response:
        return self._xml_config(req, "tagging_xml", "Tagging",
                                s3err.ERR_NO_SUCH_TAG_SET)

    def bucket_object_lock(self, req: S3Request) -> S3Response:
        """Lock config is append-only state: it can never be removed or
        disabled once set, or WORM would be trivially escapable (ref
        PutBucketObjectLockConfigHandler gating,
        cmd/bucket-object-lock.go)."""
        from ..bucket import objectlock as ol
        self._check_bucket_exists(req)
        if req.method == "GET":
            raw = self.bucket_meta.get(req.bucket).object_lock_xml
            if not raw:
                raise s3err.ERR_NO_SUCH_OBJECT_LOCK_CONFIG
            return S3Response(200, raw.encode(),
                              {"Content-Type": "application/xml"})
        if req.method == "DELETE":
            raise s3err.ERR_METHOD_NOT_ALLOWED
        if not self._lock_config(req.bucket).enabled:
            raise s3err.ERR_INVALID_BUCKET_STATE
        try:
            cfg = ol.ObjectLockConfig.from_xml(req.body)
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        if not cfg.enabled:
            raise s3err.ERR_MALFORMED_XML
        self.bucket_meta.update(req.bucket,
                                object_lock_xml=req.body.decode("utf-8"))
        return S3Response(200)

    def bucket_replication(self, req: S3Request) -> S3Response:
        return self._xml_config(req, "replication_xml",
                                "ReplicationConfiguration",
                                s3err.ERR_NO_SUCH_REPLICATION_CONFIG)

    def bucket_cors(self, req: S3Request) -> S3Response:
        return self._xml_config(req, "cors_xml", "CORSConfiguration",
                                s3err.ERR_NO_SUCH_CORS_CONFIG)

    # ---------------- CORS evaluation ----------------

    def cors_rules(self, bucket: str) -> list[dict]:
        raw = self.bucket_meta.get(bucket).cors_xml
        if not raw:
            return []
        try:
            doc = parse(raw.encode())
        except Exception:
            return []
        rules = []
        for r in doc.findall("CORSRule"):
            rules.append({
                "origins": [e.text or "" for e in
                            r.findall("AllowedOrigin")],
                "methods": [(e.text or "").upper() for e in
                            r.findall("AllowedMethod")],
                "headers": [(e.text or "").lower() for e in
                            r.findall("AllowedHeader")],
                "expose": [e.text or "" for e in
                           r.findall("ExposeHeader")],
                "max_age": r.findtext("MaxAgeSeconds") or "",
            })
        return rules

    @staticmethod
    def _origin_matches(pattern: str, origin: str) -> bool:
        if pattern == "*":
            return True
        if "*" in pattern:
            pre, _, post = pattern.partition("*")
            return (origin.startswith(pre) and origin.endswith(post)
                    and len(origin) >= len(pre) + len(post))
        return pattern == origin

    def cors_match(self, bucket: str, origin: str,
                   method: str) -> dict | None:
        """First rule allowing (origin, method), else None (ref the
        CORS filter the reference serves from bucket metadata)."""
        if not origin:
            return None
        for rule in self.cors_rules(bucket):
            if method.upper() not in rule["methods"]:
                continue
            if any(self._origin_matches(p, origin)
                   for p in rule["origins"]):
                return rule
        return None

    # ---------------- object tagging ----------------

    def object_tagging(self, req: S3Request) -> S3Response:
        version_id = self._version_param(req)
        if req.method == "GET":
            try:
                info = self.layer.get_object_info(req.bucket, req.key,
                                                  version_id)
            except MethodNotAllowed:
                raise s3err.ERR_METHOD_NOT_ALLOWED
            except (ObjectNotFound, BucketNotFound):
                raise s3err.ERR_NO_SUCH_KEY
            root = Element("Tagging", S3_XMLNS)
            tagset = root.child("TagSet")
            if hasattr(self.layer, "get_object_tags"):
                # Gateway layers fetch tags from the upstream.
                try:
                    raw = self.layer.get_object_tags(
                        req.bucket, req.key, version_id)
                except (ObjectNotFound, BucketNotFound):
                    raise s3err.ERR_NO_SUCH_KEY
                except MethodNotAllowed:
                    raise s3err.ERR_METHOD_NOT_ALLOWED
            else:
                raw = info.metadata.get("x-amz-tagging", "")
            for pair in raw.split("&") if raw else []:
                k, _, v = pair.partition("=")
                t = tagset.child("Tag")
                t.child("Key", urllib.parse.unquote_plus(k))
                t.child("Value", urllib.parse.unquote_plus(v))
            return S3Response(200, root.tobytes(),
                              {"Content-Type": "application/xml"})
        if req.method == "DELETE":
            self._set_object_tags(req, version_id, "")
            return S3Response(204)
        try:
            doc = parse(req.body)
            pairs = []
            for t in doc.find("TagSet").findall("Tag"):
                pairs.append(
                    f"{urllib.parse.quote_plus(t.findtext('Key') or '')}"
                    f"={urllib.parse.quote_plus(t.findtext('Value') or '')}")
            if len(pairs) > 10:
                raise s3err.ERR_INVALID_ARGUMENT
        except s3err.APIError:
            raise
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        self._set_object_tags(req, version_id, "&".join(pairs))
        return S3Response(200)

    def _set_object_tags(self, req: S3Request, version_id: str,
                         tags: str) -> None:
        try:
            self.layer.put_object_tags(req.bucket, req.key, tags,
                                       version_id)
        except MethodNotAllowed:
            raise s3err.ERR_METHOD_NOT_ALLOWED
        except (ObjectNotFound, BucketNotFound):
            raise s3err.ERR_NO_SUCH_KEY

    # ---------------- object lock ----------------

    def _lock_config(self, bucket: str):
        from ..bucket import objectlock as ol
        try:
            return ol.ObjectLockConfig.from_xml(
                self.bucket_meta.get(bucket).object_lock_xml)
        except ol.ObjectLockError:
            return ol.ObjectLockConfig()

    def _apply_lock_headers(self, req: S3Request, meta: dict) -> None:
        """Stamp retention/legal-hold metadata on a new object/upload
        from its headers or the bucket default."""
        from ..bucket import objectlock as ol
        cfg = self._lock_config(req.bucket)
        has_hdrs = (ol.META_MODE in req.headers
                    or ol.META_RETAIN_UNTIL in req.headers
                    or ol.META_LEGAL_HOLD in req.headers)
        if not cfg.enabled:
            if has_hdrs:
                raise s3err.ERR_INVALID_BUCKET_STATE
            return
        try:
            ol.apply_put_headers(req.headers, cfg, meta)
        except ol.PastRetainDate:
            raise s3err.ERR_PAST_OBJECT_LOCK_RETAIN_DATE
        except ol.BadLockDate:
            raise s3err.ERR_INVALID_ARGUMENT
        except ol.ObjectLockError:
            raise s3err.ERR_INVALID_RETENTION_MODE

    @staticmethod
    def _can_bypass_governance(req: S3Request) -> bool:
        """Header present; the s3:BypassGovernanceRetention grant is
        enforced by S3Server.authorize before dispatch."""
        from ..bucket import objectlock as ol
        return req.headers.get(ol.H_BYPASS_GOVERNANCE,
                               "").lower() == "true"

    def _check_version_delete_allowed(self, bucket: str, key: str,
                                      version_id: str,
                                      bypass: bool) -> None:
        """Versioned deletes destroy data: enforce WORM on the target
        version (plain deletes only write markers and pass)."""
        from ..bucket import objectlock as ol
        if not version_id:
            return
        if not self._lock_config(bucket).enabled:
            return
        try:
            info = self.layer.get_object_info(bucket, key, version_id)
        except (ObjectNotFound, BucketNotFound, MethodNotAllowed):
            return  # missing/marker version: nothing to protect
        if info.delete_marker:
            return
        try:
            ol.check_version_delete(info.metadata, bypass)
        except ol.ObjectLockError:
            raise s3err.ERR_OBJECT_LOCKED

    def object_retention(self, req: S3Request) -> S3Response:
        """GET/PUT /bucket/key?retention (ref
        PutObjectRetentionHandler, cmd/object-handlers.go)."""
        from ..bucket import objectlock as ol
        version_id = self._version_param(req)
        try:
            info = self.layer.get_object_info(req.bucket, req.key,
                                              version_id)
        except (ObjectNotFound, BucketNotFound):
            raise s3err.ERR_NO_SUCH_KEY
        except MethodNotAllowed:
            raise s3err.ERR_METHOD_NOT_ALLOWED
        if req.method == "GET":
            mode = info.metadata.get(ol.META_MODE, "")
            until = info.metadata.get(ol.META_RETAIN_UNTIL, "")
            if not mode:
                raise s3err.ERR_NO_SUCH_RETENTION
            root = Element("Retention", S3_XMLNS)
            root.child("Mode", mode)
            root.child("RetainUntilDate", until)
            return S3Response(200, root.tobytes(),
                              {"Content-Type": "application/xml"})
        if not self._lock_config(req.bucket).enabled:
            raise s3err.ERR_INVALID_BUCKET_STATE
        try:
            mode, ts = ol.parse_retention_xml(req.body)
        except ol.ObjectLockError:
            raise s3err.ERR_INVALID_RETENTION_MODE
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        import time as _time
        if ts <= _time.time():
            raise s3err.ERR_PAST_OBJECT_LOCK_RETAIN_DATE
        try:
            ol.check_retention_update(info.metadata, mode, ts,
                                      self._can_bypass_governance(req))
        except ol.ObjectLockError:
            raise s3err.ERR_OBJECT_LOCKED
        self.layer.update_object_metadata(
            req.bucket, req.key,
            {ol.META_MODE: mode, ol.META_RETAIN_UNTIL: ol.iso8601(ts)},
            version_id)
        return S3Response(200)

    def object_legal_hold(self, req: S3Request) -> S3Response:
        from ..bucket import objectlock as ol
        version_id = self._version_param(req)
        try:
            info = self.layer.get_object_info(req.bucket, req.key,
                                              version_id)
        except (ObjectNotFound, BucketNotFound):
            raise s3err.ERR_NO_SUCH_KEY
        except MethodNotAllowed:
            raise s3err.ERR_METHOD_NOT_ALLOWED
        if req.method == "GET":
            status = info.metadata.get(ol.META_LEGAL_HOLD, "")
            if not status:
                raise s3err.ERR_NO_SUCH_RETENTION
            root = Element("LegalHold", S3_XMLNS)
            root.child("Status", status)
            return S3Response(200, root.tobytes(),
                              {"Content-Type": "application/xml"})
        if not self._lock_config(req.bucket).enabled:
            raise s3err.ERR_INVALID_BUCKET_STATE
        try:
            status = ol.parse_legal_hold_xml(req.body)
        except ol.ObjectLockError:
            raise s3err.ERR_MALFORMED_XML
        except Exception:
            raise s3err.ERR_MALFORMED_XML
        self.layer.update_object_metadata(
            req.bucket, req.key, {ol.META_LEGAL_HOLD: status}, version_id)
        return S3Response(200)

    def post_policy_upload(self, req: S3Request, form,
                           key: str) -> S3Response:
        """Store a browser form upload through the SAME pipeline as a
        PUT — bucket-default SSE, object-lock defaults, compression,
        replication all apply (ref PostPolicyBucketHandler,
        cmd/api-router.go:304; policy checks already done)."""
        if not self.layer.bucket_exists(req.bucket):
            raise s3err.ERR_NO_SUCH_BUCKET
        if len(form.file_data) > MAX_OBJECT_SIZE:
            raise s3err.ERR_ENTITY_TOO_LARGE
        # Synthetic PUT view of the form: fields become headers so the
        # shared lock/SSE/storage-class helpers read them uniformly.
        sub = S3Request("PUT", req.raw_path, "", {
            k.lower(): v for k, v in form.fields.items()},
            form.file_data)
        sub.bucket, sub.key = req.bucket, key
        meta = {"content-type": form.file_content_type
                or form.fields.get("Content-Type",
                                   "application/octet-stream")}
        for k, v in form.fields.items():
            if k.lower().startswith("x-amz-meta-"):
                meta[k.lower()] = v
        self._apply_lock_headers(sub, meta)
        parity = self._parity_for_request(sub)
        self._check_quota(req.bucket, len(form.file_data))
        body = self._maybe_compress(key, form.file_data, meta)
        body = self._sse_encrypt_body(sub, body, meta)
        self._replication_decision(sub, meta)
        try:
            versioned = self._versioned(req.bucket)
            replaced = self._usage_replaced_size(req.bucket, key,
                                                 versioned)
            info = self.layer.put_object(
                req.bucket, key, body, metadata=meta,
                versioned=versioned,
                parity_shards=parity)
            self._usage_add(req.bucket, info.size - replaced)
        except ParentIsObject:
            raise s3err.ERR_PARENT_IS_OBJECT
        from ..event import event as ev
        self._notify(ev.OBJECT_CREATED_POST, req.bucket, key, info)
        self._queue_replication(sub, info, meta)
        h = {"ETag": f'"{info.etag}"',
             "Location": f"/{req.bucket}/{key}"}
        h.update(self._sse_response_headers(info))
        if info.version_id:
            h["x-amz-version-id"] = info.version_id
        redirect = form.fields.get("success_action_redirect", "")
        if redirect:
            sep = "&" if "?" in redirect else "?"
            h["Location"] = (f"{redirect}{sep}" + urllib.parse.urlencode(
                {"bucket": req.bucket, "key": key, "etag": info.etag}))
            return S3Response(303, b"", h)
        status = form.fields.get("success_action_status", "204")
        if status == "201":
            root = Element("PostResponse", S3_XMLNS)
            root.child("Location", h["Location"])
            root.child("Bucket", req.bucket)
            root.child("Key", key)
            root.child("ETag", h["ETag"])
            return S3Response(201, root.tobytes(), h)
        return S3Response(200 if status == "200" else 204, b"", h)

    def restore_object(self, req: S3Request) -> S3Response:
        """POST /bucket/key?restore (ref PostRestoreObjectHandler,
        cmd/bucket-lifecycle.go RestoreTransitionedObject)."""
        from ..bucket import tiering
        days = 1
        if req.body:
            try:
                doc = parse(req.body)
                days = int(doc.findtext("Days") or "1")
            except Exception:
                raise s3err.ERR_MALFORMED_XML
        try:
            tiering.restore_object(self.layer, self.tiers, req.bucket,
                                   req.key, days)
        except (ObjectNotFound, BucketNotFound):
            raise s3err.ERR_NO_SUCH_KEY
        except tiering.TierError as e:
            raise s3err.APIError("InvalidObjectState", str(e), 403)
        return S3Response(202)

    def _tier_meta_if_destroying(self, bucket: str, key: str,
                                 version_id: str,
                                 versioned: bool) -> dict | None:
        """Metadata of a transitioned object about to be DESTROYED
        (unversioned delete or versioned delete of the data version) —
        its remote copy must be GC'd (ref deleteTransitionedObject)."""
        from ..bucket import tiering as tier_mod
        if not self.tiers.list():
            return None
        if versioned and not version_id:
            return None  # marker write: data survives
        try:
            info = self.layer.get_object_info(bucket, key, version_id)
        except Exception:
            return None
        return (info.metadata
                if tier_mod.is_transitioned(info.metadata) else None)

    def delete_object(self, req: S3Request) -> S3Response:
        version_id = self._version_param(req)
        self._check_version_delete_allowed(
            req.bucket, req.key, version_id,
            self._can_bypass_governance(req))
        tier_meta = self._tier_meta_if_destroying(
            req.bucket, req.key, version_id,
            self._versioned(req.bucket))
        h = {}
        try:
            # Size of the version about to be destroyed, for the
            # incremental usage counter (markers destroy nothing).
            versioned = self._versioned(req.bucket)
            freed = 0
            # A versioned delete without a versionId writes a marker —
            # nothing is freed, skip the stat.
            if (self._usage_cache.get(req.bucket) is not None
                    and not (versioned and not version_id)):
                try:
                    freed = self.layer.get_object_info(
                        req.bucket, req.key, version_id).size
                except Exception:
                    freed = 0
            deleted = self.layer.delete_object(
                req.bucket, req.key, version_id,
                versioned=versioned)
            if not deleted.delete_marker and freed:
                self._usage_add(req.bucket, -freed)
            if deleted.delete_marker:
                h["x-amz-delete-marker"] = "true"
            if deleted.version_id:
                h["x-amz-version-id"] = deleted.version_id
            from ..event import event as ev
            self._notify(
                ev.OBJECT_REMOVED_DELETE_MARKER if deleted.delete_marker
                else ev.OBJECT_REMOVED_DELETE,
                req.bucket, req.key, deleted)
            # Only a NEW marker replicates; purging a marker version
            # ("undelete") must not delete the replica.
            if deleted.delete_marker and not version_id and \
                    self.replication.replicates_deletes(req.bucket,
                                                        req.key):
                self.replication.queue_task(req.bucket, req.key, "",
                                            "delete")
            if tier_meta is not None and not deleted.delete_marker:
                self.tiers.delete_remote(tier_meta)
        except (ObjectNotFound, BucketNotFound):
            if version_id:  # S3 DELETE is idempotent-success on missing keys
                h["x-amz-version-id"] = version_id
        except MethodNotAllowed:
            raise s3err.ERR_NOT_IMPLEMENTED  # FS backend versioned delete
        return S3Response(204, headers=h)


class S3Server:
    """HTTP front end with SigV4 auth (the reference's generic-handlers
    auth dispatch, ref cmd/auth-handler.go)."""

    def __init__(self, layer: ErasureObjects | None = None,
                 access_key: str = "minioadmin",
                 secret_key: str = "minioadmin", region: str = "us-east-1",
                 rpc_registry=None, iam=None):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.rpc_registry = rpc_registry
        self.iam = iam  # IAMSys; None = root-credentials-only mode
        self.handlers = None
        self.bucket_meta = None
        self.config = None  # ConfigSys once the layer attaches
        self.audit = None
        self._audit_from_env = False
        # QoS: per-class admission caps + request deadline budget (ref
        # maxClients middleware, cmd/generic-handlers.go). Created
        # before set_layer so _apply_config can configure it, and
        # registered as the dispatch scheduler's foreground-busy probe.
        from ..qos.admission import AdmissionController
        from ..qos.scheduler import GATE
        self.qos = AdmissionController()
        GATE.register(self.qos)
        from .webrpc import WebHandlers
        self.web = WebHandlers(self)
        if layer is not None:
            self.set_layer(layer)
        from .admin import AdminHandlers, Metrics
        self.metrics = Metrics()
        self.admin = AdminHandlers(self)
        from ..logger.audit import AuditWebhook
        from ..utils.bandwidth import BandwidthMonitor
        from ..utils.pubsub import PubSub
        self.bandwidth = BandwidthMonitor()
        # Every request publishes a trace.Info analog here; admin
        # /trace subscribes (ref globalHTTPTrace, cmd/globals.go:184).
        self.trace_hub = PubSub()
        if self.audit is None:
            self.audit = AuditWebhook.from_env()
            self._audit_from_env = self.audit is not None
        self.crawler = None  # attached by serve when scanning is on
        # rpc.peer.NotificationSys in distributed mode: admin trace /
        # profiling / info aggregate across the cluster through it.
        self.notification = None
        # PUT bodies at or above this size stream through the engine's
        # block pipeline instead of buffering (O(batch) server memory).
        self.stream_threshold = 8 * 1024 * 1024
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._front_door = None  # asyncserver.AsyncFrontDoor when async

    @property
    def layer(self):
        return self.handlers.layer if self.handlers else None

    def set_layer(self, layer) -> None:
        """Attach the object layer once boot completes (the reference
        serves 503 until newObjectLayer finishes,
        cmd/server-main.go:463)."""
        from ..bucket.metadata import BucketMetadataSys
        self.bucket_meta = BucketMetadataSys.for_layer(layer)
        self.handlers = S3ApiHandlers(layer, self.region, self.bucket_meta)
        self.handlers.server = self
        from ..config.kv import ConfigSys
        self.config = ConfigSys(self.bucket_meta.store)
        self.config.validators.append(self._validate_config)
        self.config.on_change(self._apply_config)
        self._apply_config(self.config)
        # Boot-time crash recovery: GC orphaned staging residue
        # (age-gated), requeue partially-committed objects, replay the
        # durable MRF journal — synchronously, so the report (and the
        # replayed mrf_queue_depth) exists before the first request is
        # served (storage/recovery.py).
        from ..storage.recovery import sweep_layer
        self.recovery_reports = sweep_layer(layer)

    def _validate_config(self, subsys: str, target: str,
                         kvs: dict) -> None:
        """Reject values that would break the running system BEFORE
        they persist (ref per-subsystem validation in lookupConfigs)."""
        if subsys == "storage_class":
            from ..config.storageclass import _parse_buckets, _parse_ec
            n = getattr(self.layer, "k", 0) + getattr(self.layer, "m", 0)
            for key, v in kvs.items():
                if key == "regen_buckets":
                    # A bucket list, not an EC:m value; any parse
                    # result is safe (unknown buckets simply never
                    # match a PUT).
                    _parse_buckets(v)
                    continue
                try:
                    m = _parse_ec(v)
                except Exception as e:
                    raise ValueError(f"storage_class {key}: {e}")
                if m is not None and n >= 2 and not (0 < m <= n // 2):
                    raise ValueError(
                        f"storage_class {key}={v}: parity out of range "
                        f"for {n}-disk sets")
        if subsys == "audit_webhook":
            ep = kvs.get("endpoint")
            if ep:
                from urllib.parse import urlparse
                if urlparse(ep).scheme not in ("http", "https"):
                    raise ValueError(f"audit endpoint {ep!r} must be "
                                     "http(s)")
        if subsys == "obs":
            from ..qos.deadline import parse_duration
            for key, v in kvs.items():
                if key.startswith("slow_ms"):
                    if v.strip() == "":
                        continue  # empty = inherit the default SLO
                    try:
                        if float(v) < 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"obs {key}={v!r}: must be a millisecond "
                            "number >= 0 (or empty to inherit)")
                elif key == "profile_on_slow":
                    if v not in ("on", "off"):
                        raise ValueError(
                            f"obs profile_on_slow={v!r}: must be "
                            "on/off")
                elif key == "loop_stall_ms":
                    try:
                        # NaN-proof: `not (x > 0)` rejects NaN where
                        # `x <= 0` would wave it through.
                        if not (float(v) > 0):
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"obs loop_stall_ms={v!r}: must be a "
                            "positive millisecond number")
                elif key == "profile_continuous":
                    if v not in ("on", "off"):
                        raise ValueError(
                            f"obs profile_continuous={v!r}: must be "
                            "on/off")
                elif key in ("timeline_sample", "timeline_retention"):
                    try:
                        if parse_duration(v) <= 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"obs {key}={v!r}: must be a positive "
                            "duration like 1s / 500ms / 15m")
        if subsys == "logger":
            if kvs.get("json") not in (None, "on", "off"):
                raise ValueError(
                    f"logger json={kvs.get('json')!r}: must be on/off")
        if subsys == "codec":
            for key, v in kvs.items():
                if key in ("autotune", "probe_on_boot"):
                    if v not in ("on", "off"):
                        raise ValueError(
                            f"codec {key}={v!r}: must be on/off")
                elif key == "hysteresis":
                    try:
                        # NaN-proof: `not (x >= 1.0)` rejects NaN
                        # where `x < 1.0` would wave it through.
                        if not (float(v) >= 1.0):
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"codec hysteresis={v!r}: must be a "
                            "number >= 1.0")
        if subsys == "alerts":
            from ..obs.watchdog import validate_user_rules
            from ..qos.deadline import parse_duration
            for key, v in kvs.items():
                if key == "enable":
                    if v not in ("on", "off"):
                        raise ValueError(
                            f"alerts enable={v!r}: must be on/off")
                elif key in ("fast_window", "slow_window"):
                    try:
                        if parse_duration(v) <= 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"alerts {key}={v!r}: must be a positive "
                            "duration like 30s / 1m / 15m")
                elif key == "burn_threshold":
                    try:
                        if not 0 < float(v) <= 1:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"alerts burn_threshold={v!r}: must be a "
                            "fraction in (0, 1]")
                elif key in ("pending_ticks", "resolve_ticks"):
                    try:
                        if int(v) < 1:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"alerts {key}={v!r}: must be an integer "
                            ">= 1")
                elif key == "rules" and v.strip():
                    validate_user_rules(v)  # AlertRuleError = ValueError
                elif key == "webhook_endpoint" and v.strip():
                    from urllib.parse import urlparse
                    if urlparse(v).scheme not in ("http", "https"):
                        raise ValueError(
                            f"alerts webhook_endpoint={v!r} must be "
                            "http(s)")
            # Cross-key: the two-window semantic (fast reacts, slow
            # confirms) degenerates if fast >= slow — configure()
            # would silently clamp, so reject the write instead. The
            # half not in this write reads its current effective
            # value.
            if "fast_window" in kvs or "slow_window" in kvs:
                try:
                    fast = parse_duration(
                        kvs.get("fast_window")
                        or self.config.get("alerts", "fast_window"))
                    slow = parse_duration(
                        kvs.get("slow_window")
                        or self.config.get("alerts", "slow_window"))
                except ValueError:
                    fast = slow = 0.0  # per-key checks already raised
                if fast and slow and fast > slow:
                    raise ValueError(
                        f"alerts fast_window ({fast:g}s) must be <= "
                        f"slow_window ({slow:g}s) — both windows must "
                        "breach for a burn alert, so a fast window "
                        "wider than the slow one would never confirm")
        if subsys == "usage":
            from ..qos.deadline import parse_duration
            for key, v in kvs.items():
                if key == "enable":
                    if v not in ("on", "off"):
                        raise ValueError(
                            f"usage enable={v!r}: must be on/off")
                elif key in ("top_k", "cardinality_cap",
                             "noisy_min_requests"):
                    caps = {"top_k": 1024, "cardinality_cap": 100_000,
                            "noisy_min_requests": 10_000_000}
                    try:
                        if not 1 <= int(v) <= caps[key]:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"usage {key}={v!r}: must be an integer "
                            f"in [1, {caps[key]}]")
                elif key in ("fast_window", "slow_window"):
                    try:
                        if parse_duration(v) <= 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"usage {key}={v!r}: must be a positive "
                            "duration like 30s / 1m / 15m")
                elif key == "noisy_share":
                    try:
                        if not 0 < float(v) <= 1:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"usage noisy_share={v!r}: must be a "
                            "fraction in (0, 1]")
            # Same two-window cross-check as the alerts subsystem:
            # fast reacts, slow confirms — a fast window wider than
            # the slow one would make noisy_neighbor never confirm.
            if "fast_window" in kvs or "slow_window" in kvs:
                try:
                    fast = parse_duration(
                        kvs.get("fast_window")
                        or self.config.get("usage", "fast_window"))
                    slow = parse_duration(
                        kvs.get("slow_window")
                        or self.config.get("usage", "slow_window"))
                except ValueError:
                    fast = slow = 0.0  # per-key checks already raised
                if fast and slow and fast > slow:
                    raise ValueError(
                        f"usage fast_window ({fast:g}s) must be <= "
                        f"slow_window ({slow:g}s)")
        if subsys == "cache":
            from ..qos.deadline import parse_duration
            for key, v in kvs.items():
                if key == "enable":
                    if v not in ("on", "off"):
                        raise ValueError(
                            f"cache enable={v!r}: must be on/off")
                elif key in ("mem_bytes", "disk_bytes", "min_hits",
                             "max_object_bytes"):
                    try:
                        if int(v) < 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"cache {key}={v!r}: must be an integer "
                            ">= 0")
                elif key == "revalidate":
                    if v == "off":
                        continue
                    try:
                        if parse_duration(v) < 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"cache revalidate={v!r}: must be a "
                            "duration like 1s / 500ms, 0 (always), "
                            "or off (never)")
        if subsys == "rpc":
            from ..qos.deadline import parse_duration
            for key, v in kvs.items():
                if key == "offline_retry":
                    try:
                        if parse_duration(v) <= 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"rpc offline_retry={v!r}: must be a "
                            "positive duration like 2s / 500ms")
        if subsys == "storage":
            for key, v in kvs.items():
                if key == "fsync" and v not in ("on", "off"):
                    raise ValueError(
                        f"storage fsync={v!r}: must be on/off")
        if subsys == "fault_inject":
            for key, v in kvs.items():
                if key == "enable":
                    if v not in ("on", "off"):
                        raise ValueError(
                            f"fault_inject enable={v!r}: must be "
                            "on/off")
                elif key == "plan" and v.strip():
                    import json as _json
                    from ..faultinject import FAULTS, FaultPlanError
                    try:
                        FAULTS.validate(_json.loads(v))
                    except (_json.JSONDecodeError,
                            FaultPlanError) as e:
                        raise ValueError(
                            f"fault_inject plan: {e}")
        if subsys == "api":
            from ..qos.deadline import parse_duration
            for key, v in kvs.items():
                if key.startswith("requests_max"):
                    try:
                        if int(v) < 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"api {key}={v!r}: must be an integer >= 0")
                elif key == "requests_deadline":
                    try:
                        if parse_duration(v) < 0:
                            raise ValueError
                    except ValueError:
                        raise ValueError(
                            f"api requests_deadline={v!r}: must be a "
                            "duration like 10s / 250ms")

    def _apply_config(self, cfg) -> None:
        """Push dynamic config into the running subsystems (the
        reference's dynamic-subsystem reload on SetKVS)."""
        from ..config.storageclass import (StorageClassConfig,
                                           _parse_buckets, _parse_ec)
        from ..logger.audit import AuditWebhook
        h = self.handlers
        if h is None:
            return
        # compression.enable flips the PUT-path wrap live; env keeps
        # its historical override.
        import os as _os
        h.compress_enabled = (
            _os.environ.get("MINIO_COMPRESS", "") == "on"
            or cfg.get("compression", "enable") == "on")
        try:
            h.storage_class = StorageClassConfig(
                standard_parity=_parse_ec(
                    cfg.get("storage_class", "standard")),
                rrs_parity=_parse_ec(cfg.get("storage_class", "rrs")),
                regen_buckets=_parse_buckets(
                    cfg.get("storage_class", "regen_buckets")))
        except Exception as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"storage_class config invalid, keeping previous: {e}",
                "config")
        # Admission caps + deadline reload live (per-class overrides on
        # top of the reference's single requests_max knob).
        from ..qos.deadline import parse_duration
        try:
            self.qos.configure(
                int(cfg.get("api", "requests_max") or "0"),
                {c: int(cfg.get("api", f"requests_max_{c}") or "0")
                 for c in ("read", "write", "list", "admin",
                           "select")},
                parse_duration(cfg.get("api", "requests_deadline")))
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"api qos config invalid, keeping previous: {e}", "config")
        # Peer health-gate window reloads live on the CLASS, so every
        # RPC client in the process follows (rpc/transport.py).
        from ..qos.deadline import parse_duration as _pd
        from ..rpc.transport import RPCClient
        try:
            _retry = _pd(cfg.get("rpc", "offline_retry"))
            # Env overrides bypass _validate: a zero here would
            # disable the peer health gate entirely (every RPC to a
            # dead peer pays the full socket timeout).
            if _retry <= 0:
                raise ValueError(f"offline_retry={_retry!r}: must be "
                                 "positive")
            RPCClient.OFFLINE_RETRY = _retry
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"rpc config invalid, keeping previous: {e}", "config")
        # Commit-path fsync policy flips live (storage/xl.py
        # commit_replace); env MINIO_STORAGE_FSYNC wins via the
        # config's env-first rule. Anything but an explicit "on" is
        # off — durability must be asked for, never inferred.
        from ..storage.xl import set_fsync
        set_fsync(cfg.get("storage", "fsync") == "on")
        # Fault-injection plan: applied only when the EFFECTIVE
        # fault_inject config changed — the apply hook runs on every
        # config write, and an unrelated change must not clobber a
        # plan loaded through the admin /fault-inject API.
        fcfg = (cfg.get("fault_inject", "enable"),
                cfg.get("fault_inject", "plan"))
        if fcfg != getattr(self, "_last_fault_cfg", ("off", "")):
            self._last_fault_cfg = fcfg
            from ..faultinject import FAULTS
            try:
                if fcfg[0] == "on" and fcfg[1].strip():
                    import json as _json
                    FAULTS.load_plan(_json.loads(fcfg[1]))
                else:
                    FAULTS.clear()
            except Exception as e:  # env override may carry garbage
                from ..logger import Logger
                Logger.get().log_once(
                    f"fault_inject config invalid, ignored: {e}",
                    "config")
        # Hot-object serving tier reloads live (cache/hotcache.py):
        # budgets shrink in place, disabling clears both tiers, a dir
        # change re-creates the disk tier.
        from ..cache.hotcache import HOTCACHE
        from ..qos.deadline import parse_duration as _pdur
        try:
            _reval_raw = cfg.get("cache", "revalidate").strip()
            _reval = (None if _reval_raw == "off"
                      else _pdur(_reval_raw))
            if _reval is not None and _reval < 0:
                raise ValueError("revalidate must be >= 0")
            HOTCACHE.configure(
                enable=cfg.get("cache", "enable") == "on",
                mem_bytes=int(cfg.get("cache", "mem_bytes")),
                disk_bytes=int(cfg.get("cache", "disk_bytes")),
                dirs=[d for d in
                      cfg.get("cache", "dirs").split(",") if d],
                min_hits=int(cfg.get("cache", "min_hits")),
                max_object_bytes=int(
                    cfg.get("cache", "max_object_bytes")),
                revalidate_s=_reval)
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"cache config invalid, keeping previous: {e}",
                "config")
        # Slowlog SLO thresholds reload live (the always-on tail
        # capture must be tunable under fire, like the QoS caps).
        from ..obs.slowlog import SLOWLOG

        def _ms(key: str) -> float | None:
            raw = cfg.get("obs", key).strip()
            return float(raw) if raw else None

        try:
            # Empty default = inherit the shipped SLO, matching the
            # validator's contract (an operator CLEARING the key must
            # not silently disable capture; "0" does that explicitly).
            default_ms = _ms("slow_ms")
            if default_ms is None:
                from ..config.kv import DEFAULT_KVS
                default_ms = float(DEFAULT_KVS["obs"]["slow_ms"])
            SLOWLOG.configure(
                default_ms,
                {c: _ms(f"slow_ms_{c}")
                 for c in ("read", "write", "list", "admin",
                           "select")},
                cfg.get("obs", "profile_on_slow") == "on")
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"obs slowlog config invalid, keeping previous: {e}",
                "config")
        # Timeline ring shape reloads live (obs/timeline.py keeps the
        # history it already has, up to the new capacity).
        from ..obs.timeline import TIMELINE
        try:
            _period = parse_duration(cfg.get("obs", "timeline_sample"))
            _keep = parse_duration(cfg.get("obs", "timeline_retention"))
            if _period <= 0 or _keep <= 0:
                raise ValueError("timeline durations must be positive")
            TIMELINE.configure(_period, _keep)
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"obs timeline config invalid, keeping previous: {e}",
                "config")
        # Event-loop health plane (obs/loopmon.py): the stall
        # threshold and the continuous profiler reload live — an
        # operator chasing a stall must be able to tighten the trip
        # wire (or switch the profiler on) without a restart.
        from ..obs.loopmon import LOOPMON
        try:
            _stall = float(cfg.get("obs", "loop_stall_ms"))
            if not (_stall > 0):  # env bypasses _validate; NaN-proof
                raise ValueError("loop_stall_ms must be positive")
            LOOPMON.configure(
                stall_ms=_stall,
                profile_continuous=cfg.get(
                    "obs", "profile_continuous") == "on")
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"obs loopmon config invalid, keeping previous: {e}",
                "config")
        # Watchdog alert engine: windows/threshold/hysteresis/user
        # rules/webhook all reload live (an operator tuning an alert
        # storm must not need a restart). Applied only when the
        # EFFECTIVE alerts config changed — the apply hook runs on
        # every config write, and rebuilding the rule set resets a
        # rate-mode user rule's delta window (a firing alert would
        # falsely resolve whenever an operator tunes an UNRELATED
        # key mid-incident; same convention as fault_inject below).
        from ..obs.watchdog import WATCHDOG, validate_user_rules
        acfg = tuple(cfg.get("alerts", k) for k in
                     ("enable", "fast_window", "slow_window",
                      "burn_threshold", "pending_ticks",
                      "resolve_ticks", "rules", "webhook_endpoint",
                      "webhook_auth_token"))
        if acfg != getattr(self, "_last_alerts_cfg", None):
            try:
                _rules_raw = acfg[6].strip()
                WATCHDOG.configure(
                    enable=acfg[0] == "on",
                    fast_s=parse_duration(acfg[1]),
                    slow_s=parse_duration(acfg[2]),
                    burn_threshold=float(acfg[3]),
                    pending_ticks=int(acfg[4]),
                    resolve_ticks=int(acfg[5]),
                    user_rules=(validate_user_rules(_rules_raw)
                                if _rules_raw else ()),
                    webhook_endpoint=acfg[7].strip(),
                    webhook_auth_token=acfg[8])
                self._last_alerts_cfg = acfg
            except ValueError as e:  # env override may carry garbage
                from ..logger import Logger
                Logger.get().log_once(
                    f"alerts config invalid, keeping previous: {e}",
                    "config")
        # Tenant/workload attribution reloads live (obs/usage.py):
        # enable toggles the _finish_request hook, top_k reshapes the
        # sketches, cardinality_cap retunes both the account fold and
        # the metrics2 usage_* label guard, the windows and noisy_*
        # knobs retune the noisy_neighbor rule.
        from ..obs.usage import USAGE
        try:
            USAGE.configure(
                enable=cfg.get("usage", "enable") == "on",
                top_k=int(cfg.get("usage", "top_k")),
                cardinality_cap=int(cfg.get("usage",
                                            "cardinality_cap")),
                fast_s=parse_duration(cfg.get("usage", "fast_window")),
                slow_s=parse_duration(cfg.get("usage", "slow_window")),
                noisy_share=float(cfg.get("usage", "noisy_share")),
                noisy_min_requests=int(
                    cfg.get("usage", "noisy_min_requests")))
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"usage config invalid, keeping previous: {e}",
                "config")
        # Codec autotuner knobs reload live (ops/autotune.py):
        # autotune=off pins the static policy, hysteresis retunes the
        # plan-flip margin.
        from ..ops.autotune import AUTOTUNE
        try:
            _hyst = float(cfg.get("codec", "hysteresis"))
            if not (_hyst >= 1.0):  # env bypasses _validate; NaN-proof
                raise ValueError("hysteresis must be >= 1.0")
            AUTOTUNE.configure(
                enabled=cfg.get("codec", "autotune") == "on",
                hysteresis=_hyst)
        except ValueError as e:  # env override may carry garbage
            from ..logger import Logger
            Logger.get().log_once(
                f"codec config invalid, keeping previous: {e}",
                "config")
        # Structured JSON log mode; the legacy MINIO_LOG_JSON env
        # spelling wins over config (env-first, like every subsystem).
        import os as _os_log
        if not _os_log.environ.get("MINIO_LOG_JSON", ""):
            from ..logger import Logger
            Logger.get().json_output = \
                cfg.get("logger", "json") == "on"
        ep = cfg.get("audit_webhook", "endpoint")
        tok = cfg.get("audit_webhook", "auth_token")
        if cfg.get("audit_webhook", "enable") == "on" and ep:
            if (self.audit is None or self.audit.endpoint != ep
                    or self.audit.auth_token != tok):
                if self.audit is not None:
                    self.audit.close()
                self.audit = AuditWebhook(ep, tok)
                self._audit_from_env = False
        elif self.audit is not None and not self._audit_from_env:
            # Config turned it off: stop posting. An env-configured
            # sink survives config (env always wins).
            self.audit.close()
            self.audit = None

    def _lookup_secret(self, access_key: str) -> str | None:
        if self.iam is not None:
            return self.iam.lookup_secret(access_key)
        return self.secret_key if access_key == self.access_key else None

    def authenticate(self, req: S3Request) -> str:
        if req.headers.get("authorization", "").startswith("AWS "):
            # Legacy V2 signature (ref cmd/signature-v2.go).
            return sigv4.verify_header_auth_v2(
                req.method, req.raw_path, req.query, req.headers,
                self._lookup_secret)
        if "authorization" in req.headers:
            if (req.body_stream is not None
                    and "x-amz-content-sha256" not in req.headers):
                # The canonical request then needs the actual body hash:
                # buffer (clients virtually always send the header).
                req.body = _drain_stream(req.body_stream)
                req.body_stream = None
            ak = sigv4.verify_header_auth(
                req.method, req.raw_path, req.query, req.headers,
                "" if req.body_stream is not None
                else hashlib.sha256(req.body).hexdigest(),
                self._lookup_secret)
            # aws-chunked streaming upload: the seed signature just
            # verified chains the per-chunk signatures; decode + verify
            # the payload — incrementally when the body streams (ref
            # newSignV4ChunkedReader, cmd/streaming-signature-v4.go:156).
            if req.headers.get("x-amz-content-sha256",
                               "") == sigv4.STREAMING_PAYLOAD:
                cred, _, seed = sigv4.parse_auth_fields(req.headers)
                want = req.headers.get("x-amz-decoded-content-length")
                if req.body_stream is not None:
                    # AWS requires the decoded length for aws-chunked;
                    # without it the size/quota caps would be blind.
                    if not want:
                        raise s3err.ERR_MISSING_CONTENT_LENGTH
                    req.body_stream = sigv4.ChunkedDecoder(
                        req.body_stream, self._lookup_secret(ak), cred,
                        req.headers.get("x-amz-date", ""), seed)
                    try:
                        req.content_length = int(want)
                    except ValueError:
                        raise s3err.ERR_INVALID_ARGUMENT
                else:
                    req.body = sigv4.decode_streaming(
                        req.body, self._lookup_secret(ak), cred,
                        req.headers.get("x-amz-date", ""), seed)
                    req.content_length = len(req.body)
                    try:
                        if want and int(want) != len(req.body):
                            raise s3err.ERR_SIGNATURE_DOES_NOT_MATCH
                    except ValueError:
                        raise s3err.ERR_INVALID_ARGUMENT
        elif "X-Amz-Signature" in req.params:
            ak = sigv4.verify_presigned(
                req.method, req.raw_path, req.query, req.headers,
                self._lookup_secret)
        else:
            raise s3err.ERR_MISSING_AUTH
        # Temporary (STS) credentials must present their session token
        # (ref cmd/auth-handler.go session-token validation).
        if self.iam is not None:
            u = self.iam.get_user(ak)
            if u is not None and u.session_token:
                sent = (req.headers.get("x-amz-security-token")
                        or req.params.get("X-Amz-Security-Token", ""))
                if sent != u.session_token:
                    raise s3err.ERR_ACCESS_DENIED
        return ak

    @staticmethod
    def _action_for(req: S3Request) -> tuple[str, str]:
        """Map a request to (s3 action, resource) for policy checks
        (ref cmd/auth-handler.go action dispatch)."""
        m, p = req.method, req.params
        if not req.bucket:
            return "s3:ListAllMyBuckets", "*"
        resource = (f"{req.bucket}/{req.key}" if req.key
                    else req.bucket)
        if not req.key:
            if "policy" in p:
                return ({"GET": "s3:GetBucketPolicy",
                         "PUT": "s3:PutBucketPolicy",
                         "DELETE": "s3:DeleteBucketPolicy"}.get(
                             m, "s3:GetBucketPolicy"), resource)
            if "versioning" in p:
                return ("s3:GetBucketVersioning" if m == "GET"
                        else "s3:PutBucketVersioning", resource)
            if "lifecycle" in p:
                return ("s3:GetLifecycleConfiguration" if m == "GET"
                        else "s3:PutLifecycleConfiguration", resource)
            if "notification" in p:
                return ("s3:GetBucketNotification" if m == "GET"
                        else "s3:PutBucketNotification", resource)
            if "encryption" in p:
                return ("s3:GetEncryptionConfiguration" if m == "GET"
                        else "s3:PutEncryptionConfiguration", resource)
            if "tagging" in p:
                return ("s3:GetBucketTagging" if m == "GET"
                        else "s3:PutBucketTagging", resource)
            if "object-lock" in p:
                return ("s3:GetBucketObjectLockConfiguration" if m == "GET"
                        else "s3:PutBucketObjectLockConfiguration",
                        resource)
            if "replication" in p:
                return ("s3:GetReplicationConfiguration" if m == "GET"
                        else "s3:PutReplicationConfiguration", resource)
            if "cors" in p:
                return ("s3:GetBucketCORS" if m == "GET"
                        else "s3:PutBucketCORS", resource)
            if "versions" in p:
                return "s3:ListBucketVersions", resource
            if m == "PUT":
                return "s3:CreateBucket", resource
            if m == "DELETE":
                return "s3:DeleteBucket", resource
            if m == "POST" and "delete" in p:
                return "s3:DeleteObject", f"{req.bucket}/*"
            if "location" in p:
                return "s3:GetBucketLocation", resource
            if "uploads" in p:
                return "s3:ListBucketMultipartUploads", resource
            return "s3:ListBucket", resource
        if "tagging" in p:
            if m == "GET":
                return ("s3:GetObjectVersionTagging" if "versionId" in p
                        else "s3:GetObjectTagging"), resource
            return ("s3:PutObjectVersionTagging" if "versionId" in p
                    else "s3:PutObjectTagging"), resource
        if "retention" in p:
            return ("s3:GetObjectRetention" if m == "GET"
                    else "s3:PutObjectRetention"), resource
        if "legal-hold" in p:
            return ("s3:GetObjectLegalHold" if m == "GET"
                    else "s3:PutObjectLegalHold"), resource
        if "uploadId" in p or "uploads" in p:
            if m == "DELETE":
                return "s3:AbortMultipartUpload", resource
            if m == "GET":
                return "s3:ListMultipartUploadParts", resource
            return "s3:PutObject", resource
        if m == "POST" and "restore" in p:
            return "s3:RestoreObject", resource
        if m == "POST" and "select" in p:
            # SELECT scans object content: same grant as GetObject
            # (ref SelectObjectContentHandler auth).
            return "s3:GetObject", resource
        if m in ("GET", "HEAD"):
            if "versionId" in p:
                return "s3:GetObjectVersion", resource
            return "s3:GetObject", resource
        if m == "PUT":
            return "s3:PutObject", resource
        if m == "DELETE":
            return "s3:DeleteObject", resource
        return "s3:*", resource

    def authorize(self, req: S3Request, access_key: str) -> None:
        if self.iam is None:
            return  # root-only mode: authentication implies full access
        action, resource = self._action_for(req)
        ctx = {"s3:prefix": req.params.get("prefix", "")}
        if not self.iam.is_allowed(access_key, action, resource, ctx):
            raise s3err.ERR_ACCESS_DENIED
        # Governance bypass is itself a grant (ref
        # enforceRetentionBypassForDelete permission check).
        from ..bucket.objectlock import H_BYPASS_GOVERNANCE
        if req.headers.get(H_BYPASS_GOVERNANCE, "").lower() == "true":
            if not self.iam.is_allowed(
                    access_key, "s3:BypassGovernanceRetention", resource,
                    ctx):
                raise s3err.ERR_ACCESS_DENIED
        # CopyObject additionally reads the source: require GetObject
        # on it (ref CopyObjectHandler source auth).
        if req.method == "PUT" and req.key and \
                "x-amz-copy-source" in req.headers:
            src = urllib.parse.unquote(
                req.headers["x-amz-copy-source"]).lstrip("/")
            if not self.iam.is_allowed(access_key, "s3:GetObject", src,
                                       ctx):
                raise s3err.ERR_ACCESS_DENIED

    def _post_policy(self, req: S3Request) -> S3Response:
        """Auth + policy checks for a browser form POST, then store
        (ref PostPolicyBucketHandler: the signature lives in the FORM,
        not the headers)."""
        from . import formupload as fu
        try:
            form = fu.parse_multipart(
                req.headers.get("content-type", ""), req.body)
        except fu.FormError:
            raise s3err.ERR_MALFORMED_XML
        if not form.has_file:
            raise s3err.ERR_INVALID_ARGUMENT
        policy_b64 = form.fields.get("policy", "")
        if not policy_b64:
            raise s3err.ERR_MISSING_AUTH
        access_key = fu.verify_post_signature(policy_b64, form.fields,
                                              self._lookup_secret)
        try:
            policy = fu.PostPolicy.from_json(
                base64.b64decode(policy_b64))
        except (fu.FormError, ValueError):
            raise s3err.ERR_MALFORMED_POLICY
        key = form.fields.get("key", "")
        if not key:
            raise s3err.ERR_INVALID_ARGUMENT
        key = key.replace("${filename}", form.file_name)
        fields = dict(form.fields)
        fields["bucket"] = req.bucket
        fields["key"] = key
        try:
            policy.check(fields, len(form.file_data))
        except fu.PolicyViolation:
            raise s3err.ERR_ACCESS_DENIED
        if self.iam is not None and not self.iam.is_allowed(
                access_key, "s3:PutObject", f"{req.bucket}/{key}", {}):
            raise s3err.ERR_ACCESS_DENIED
        return self.handlers.post_policy_upload(req, form, key)

    def _federation_redirect(self, req: S3Request) -> "S3Response | None":
        """307 to the owning cluster when the bucket lives elsewhere in
        the federation (ref bucket DNS resolution; the reference fronts
        this with CoreDNS — the redirect covers clients that address
        any federated node directly)."""
        h = self.handlers
        if h is None or h.bucket_dns is None or not req.bucket:
            return None
        try:
            records = h.bucket_dns.lookup(req.bucket)
        except Exception:
            return None
        me = h.public_addr
        others = [r for r in records if r != me]
        if not others:
            return None
        host, port = others[0]
        scheme = "https" if getattr(self, "cert_manager", None) else \
            "http"
        loc = f"{scheme}://{host}:{port}{req.raw_path}"
        if req.query:
            loc += f"?{req.query}"
        return S3Response(307, headers={"Location": loc})

    def route_qos(self, req: S3Request) -> S3Response:
        """Admission + deadline wrapper around route (ref the
        maxClients middleware fronting the router,
        cmd/generic-handlers.go): classify the request, open its time
        budget, wait FIFO for a slot within that budget, shed with 503
        SlowDown + Retry-After past it. The deadline stays current for
        the whole handler, so storage/peer RPC below sees the remaining
        budget."""
        from ..qos import admission as adm
        from ..qos import deadline as dl
        api_class = adm.classify(req.method, req.bucket, req.key,
                                 req.params)
        req.qos_class = api_class
        budget_s = self.qos.deadline_s if self.qos.engaged else 0.0
        req.qos_deadline_s = budget_s
        with dl.open_deadline(budget_s) as budget:
            _t_adm = time.perf_counter()
            try:
                admitted = self.qos.acquire(api_class, budget)
            except adm.AdmissionShed as shed:
                # Deliberate backpressure: the QoS layer WORKING must
                # not flood the slow-request log's blame histogram.
                req.slowlog_exempt = True
                raise s3err.ERR_SLOW_DOWN.with_retry_after(
                    shed.retry_after)
            req.qos_wait_ms = (time.perf_counter() - _t_adm) * 1e3
            try:
                resp = self.route(req)
            except BaseException:
                admitted.release()
                raise
            if isinstance(resp.body, (bytes, bytearray)):
                admitted.release()
            else:
                # Streaming body: the per-group shard reads run LAZILY
                # while the body writes to the socket — the request is
                # still consuming its class's capacity. Hold the slot
                # until _finish_request (which also covers vanished
                # clients); release() is idempotent.
                resp.qos_release = admitted.release
            return resp

    def route(self, req: S3Request) -> S3Response:
        h = self.handlers
        if h is None:
            raise s3err.ERR_SLOW_DOWN  # 503 until the layer is ready
        if (req.method == "POST" and req.bucket and not req.key
                and req.headers.get("content-type", "").startswith(
                    "multipart/form-data")):
            return self._post_policy(req)
        if (req.method == "POST" and not req.bucket
                and (b"AssumeRoleWithWebIdentity" in req.body
                     or b"AssumeRoleWithClientGrants" in req.body)):
            # JWT-based STS is unauthenticated: the TOKEN is the
            # credential (ref one shared JWT handler for WebIdentity
            # and ClientGrants, cmd/sts-handlers.go:86,270-305).
            return self.sts_web_identity(req)
        if (req.method == "POST" and not req.bucket
                and b"AssumeRoleWithLDAPIdentity" in req.body):
            # LDAP STS is unauthenticated: the directory password is
            # the credential (ref AssumeRoleWithLDAPIdentity,
            # cmd/sts-handlers.go:78-93).
            return self.sts_ldap_identity(req)
        _t_auth = time.perf_counter()
        from ..obs.span import TRACER
        with TRACER.span("auth.sigv4"):
            access_key = self.authenticate(req)
        if req.method == "PUT" and req.key:
            from ..utils.phasetimer import PUT as _PUT
            _PUT.record("auth_sigv4",
                        (time.perf_counter() - _t_auth) * 1e3)
        req.access_key = access_key  # audit/trace attribution
        m, bucket, key, p = req.method, req.bucket, req.key, req.params
        # STS API: POST / (ref cmd/sts-handlers.go).
        if not bucket and m == "POST":
            return self.sts_handler(req, access_key)
        
        self.authorize(req, access_key)
        # Only plain object PUTs and part uploads consume body streams;
        # sub-resource PUTs (?tagging, ?retention, ...) read req.body.
        if req.body_stream is not None and (
                not key or m != "PUT"
                or any(q in p for q in ("tagging", "retention",
                                        "legal-hold"))):
            req.body = _drain_stream(req.body_stream)
            req.body_stream = None
            req.content_length = len(req.body)
        if not bucket:
            if m == "GET":
                return h.list_buckets(req)
            raise s3err.ERR_METHOD_NOT_ALLOWED
        if not key:
            # Bucket sub-resources (?policy, ?versioning, ?lifecycle...)
            # dispatch on the query param (ref cmd/api-router.go queries()).
            if "policy" in p:
                if m == "GET":
                    return h.get_bucket_policy(req)
                if m == "PUT":
                    return h.put_bucket_policy(req)
                if m == "DELETE":
                    return h.delete_bucket_policy(req)
            if "versioning" in p:
                if m == "GET":
                    return h.get_versioning(req)
                if m == "PUT":
                    return h.put_versioning(req)
            for param, fn in (("lifecycle", h.bucket_lifecycle),
                              ("notification", h.bucket_notification),
                              ("encryption", h.bucket_encryption),
                              ("tagging", h.bucket_tagging),
                              ("object-lock", h.bucket_object_lock),
                              ("replication", h.bucket_replication),
                              ("cors", h.bucket_cors)):
                if param in p:
                    return fn(req)
            if m == "PUT":
                return h.make_bucket(req)
            if m == "HEAD":
                return h.head_bucket(req)
            if m == "DELETE":
                return h.delete_bucket(req)
            if m == "POST" and "delete" in p:
                return h.delete_multiple(req)
            if m == "GET":
                if "location" in p:
                    return h.get_location(req)
                if "uploads" in p:
                    return h.list_multipart_uploads(req)
                if "versions" in p:
                    return h.list_object_versions(req)
                return h.list_objects(req)
            raise s3err.ERR_METHOD_NOT_ALLOWED
        if "tagging" in p:
            return h.object_tagging(req)
        if "retention" in p:
            return h.object_retention(req)
        if "legal-hold" in p:
            return h.object_legal_hold(req)
        if m == "POST" and "restore" in p:
            return h.restore_object(req)
        if m == "POST" and "select" in p:
            return h.select_object_content(req)
        if m == "POST" and "uploads" in p:
            return h.initiate_multipart(req)
        if m == "POST" and "uploadId" in p:
            return h.complete_multipart(req)
        if m == "PUT" and "partNumber" in p and "uploadId" in p:
            if "x-amz-copy-source" in req.headers:
                return h.upload_part_copy(req)
            return h.put_part(req)
        if m == "DELETE" and "uploadId" in p:
            return h.abort_multipart(req)
        if m == "GET" and "uploadId" in p:
            return h.list_parts(req)
        if m == "PUT":
            return h.put_object(req)
        if m == "GET":
            return h.get_object(req)
        if m == "HEAD":
            return h.get_object(req, head=True)
        if m == "DELETE":
            return h.delete_object(req)
        raise s3err.ERR_METHOD_NOT_ALLOWED

    def handle_ops(self, method: str, raw_path: str, query: str,
                   headers: dict[str, str], body: bytes,
                   ) -> tuple:
        """Health / metrics / admin routes (non-S3 prefixes).
        Returns (status, content_type, body[, extra_headers]) — the
        4th element is optional and carries response headers (the
        admin shed path's Retry-After)."""
        import json as _json
        params = dict(urllib.parse.parse_qsl(query,
                                             keep_blank_values=True))
        if raw_path == "/minio-tpu/health/live":
            return 200, "text/plain", b"OK"
        if raw_path == "/minio-tpu/health/ready":
            ok = self.handlers is not None
            return (200 if ok else 503), "text/plain", \
                (b"OK" if ok else b"initializing")
        if raw_path == "/minio-tpu/health/cluster":
            ok = self._cluster_healthy()
            return (200 if ok else 503), "text/plain", \
                (b"OK" if ok else b"degraded")
        if raw_path == "/minio-tpu/metrics":
            text = self.metrics.prometheus(self.layer)
            return 200, "text/plain; version=0.0.4", text.encode()
        if raw_path == "/minio-tpu/v2/metrics/node":
            # Metrics v2, node scope: the typed registry (per-API
            # histograms, PUT phase split, kernel counters, disk-op
            # latency) — ref cmd/metrics-v2.go node collectors.
            from ..obs import metrics2 as m2
            text = m2.render(m2.METRICS2.snapshot())
            return 200, "text/plain; version=0.0.4", text.encode()
        if raw_path == "/minio-tpu/v2/metrics/cluster":
            return self._metrics_cluster()
        if raw_path == "/minio-tpu/v2/health/drives":
            # Node drive health: the drivemon's per-drive EWMAs +
            # suspect/faulty states (ref the drive sections of
            # `mc admin obd`; here continuously tracked, not probed).
            # UNAUTHENTICATED like the metrics pages, so endpoints are
            # redacted — full paths are on the admin /drive-health.
            # The MRF heal-queue census rides along: queue depth +
            # drops are the "how far behind is healing" signal that
            # belongs next to the drive states.
            from ..obs.drivemon import DRIVEMON, redact_drives
            doc = redact_drives(DRIVEMON.snapshot())
            doc["mrf"] = self._mrf_stats()
            return 200, "application/json", _json.dumps(doc).encode()
        if raw_path == "/minio-tpu/v2/health/cluster/drives":
            return self._health_cluster_drives()
        if raw_path == "/minio-tpu/v2/timeline":
            # Node timeline: the in-process ring of 1-second samples
            # (obs/timeline.py) — per-class rates, kernel GiB/s per
            # backend, drive census, worst-sample trace exemplars.
            # `?n=` tails, `?since=` returns samples after a stamp
            # (what mtpu_top uses for incremental refresh).
            from ..obs.timeline import TIMELINE
            try:
                n, since = self._parse_n_since(params)
            except ValueError:
                return 400, "text/plain", b"bad n/since"
            doc = TIMELINE.snapshot(n=n, since=since)
            return 200, "application/json", _json.dumps(doc).encode()
        if raw_path == "/minio-tpu/v2/timeline/cluster":
            try:
                n, since = self._parse_n_since(params)
            except ValueError:
                return 400, "text/plain", b"bad n/since"
            return self._timeline_cluster(n=n, since=since)
        if raw_path == "/minio-tpu/v2/alerts":
            # Node alert census (obs/watchdog.py): active + recently
            # resolved alerts with causes. Unauthenticated like the
            # metrics pages — drive identities in causes are redacted.
            from ..obs.watchdog import WATCHDOG
            return (200, "application/json",
                    _json.dumps(WATCHDOG.snapshot()).encode())
        if raw_path == "/minio-tpu/v2/alerts/cluster":
            return self._alerts_cluster()
        if raw_path == "/minio-tpu/v2/usage":
            # Node workload attribution (obs/usage.py): per-bucket/
            # per-tenant window accounts + per-class heavy-hitter
            # sketches. Unauthenticated like the metrics pages, so
            # access keys, client addresses and object-key tails are
            # redacted — admin /top serves them whole.
            from ..obs.usage import USAGE, redact_usage
            return (200, "application/json", _json.dumps(
                redact_usage(USAGE.snapshot())).encode())
        if raw_path == "/minio-tpu/v2/usage/cluster":
            return self._usage_cluster()
        if raw_path in ("/minio-tpu/console", "/minio-tpu/console/") \
                and method == "GET":
            from .console import console_response
            return console_response()
        if raw_path == "/minio-tpu/webrpc" and method == "POST":
            out = self.web.handle_rpc(headers, body)
            return 200, "application/json", out
        if raw_path.startswith("/minio-tpu/web/upload/") and \
                method == "PUT":
            return self.web.handle_upload(raw_path, headers, body)
        if raw_path.startswith("/minio-tpu/web/download/") and \
                method == "GET":
            return self.web.handle_download(raw_path, query)
        if raw_path.startswith("/minio-tpu/admin/"):
            try:
                req = S3Request(method, raw_path, query, headers, body)
                access_key = self.authenticate(req)
            except APIError:
                return 403, "application/json", _json.dumps(
                    {"error": "authentication failed"}).encode()
            # Admin rides its own admission class so a control-plane
            # storm cannot crowd out data-plane caps (and vice versa).
            from ..qos import admission as adm
            from ..qos import deadline as dl
            _budget_s = self.qos.deadline_s if self.qos.engaged else 0.0
            with dl.open_deadline(_budget_s) as budget:
                try:
                    admitted = self.qos.acquire("admin", budget)
                except adm.AdmissionShed as shed:
                    return (503, "application/json", _json.dumps(
                        {"error": "SlowDown",
                         "retryAfterSeconds": shed.retry_after}).encode(),
                        {"Retry-After": str(shed.retry_after)})
                with admitted:
                    status, out = self.admin.handle(
                        method, raw_path, params, body, access_key)
            return status, "application/json", out
        return 404, "text/plain", b"not found"

    def publish_trace(self, api: str, method: str, path: str,
                      status: int, duration_ms: float, rx: int, tx: int,
                      request_id: str = "", remote: str = "",
                      access_key: str = "", spans: dict | None = None,
                      qos_class: str = "", blamed_layer: str = "",
                      ) -> None:
        """Fan a per-request trace entry to subscribers + the audit
        sink (ref httpTraceAll wrapper, cmd/handler-utils.go:349, and
        the AuditLog call in the same wrapper). `spans` carries the
        request's completed span tree, so `mc admin trace` consumers
        get the per-layer breakdown alongside the flat entry;
        qos_class/blamed_layer ride into the audit entry so the
        webhook stream joins against the slow-request log."""
        if self.trace_hub.subscriber_count:
            entry = {
                "time": time.time(), "api": api, "method": method,
                "path": path, "statusCode": status,
                "durationMs": round(duration_ms, 3),
                "rx": rx, "tx": tx, "requestID": request_id,
                "remote": remote, "accessKey": access_key,
            }
            if spans is not None:
                entry["spans"] = spans
            self.trace_hub.publish(entry)
        if self.audit is not None:
            from ..logger.audit import audit_entry
            self.audit.send(audit_entry(
                api, method, path, status, duration_ms, rx, tx,
                access_key=access_key, request_id=request_id,
                remote=remote, qos_class=qos_class,
                blamed_layer=blamed_layer))

    # One cluster scrape may fan out to every peer; cache it so an
    # unauthenticated GET loop cannot amplify into N internal RPCs per
    # hit (Prometheus scrapes at interval >> this TTL anyway).
    CLUSTER_METRICS_TTL = 10.0
    _cluster_metrics_cache: tuple[float, bytes] | None = None

    def _cached_cluster_scrape(self, cache_attr: str, build) -> bytes:
        """Shared anti-amplification TTL cache for cluster fan-in
        endpoints (metrics2, drive health): build() runs the peer
        fan-out at most once per CLUSTER_METRICS_TTL."""
        cached = getattr(self, cache_attr)
        if cached is not None and \
                time.monotonic() - cached[0] < self.CLUSTER_METRICS_TTL:
            return cached[1]
        # The fill serves EVERY request for the next TTL window, so it
        # must not inherit the triggering request's remaining deadline:
        # now that peer fan-out threads carry QoS context (qos/ctx.py),
        # a nearly-burnt request would otherwise fast-fail the peer
        # RPCs and poison the cache with a degraded scrape for 10s.
        from ..qos.deadline import deadline_scope
        with deadline_scope(None):
            body = build()
        setattr(self, cache_attr, (time.monotonic(), body))
        return body

    def _metrics_cluster(self) -> tuple[int, str, bytes]:
        """Metrics v2, cluster scope: this node's snapshot merged with
        every peer's (scraped over the `metrics2` peer RPC) — the
        node/cluster split of cmd/metrics-v2.go. Unreachable peers
        degrade the node count, never the scrape."""
        from ..obs import metrics2 as m2

        def build() -> bytes:
            snaps = [m2.METRICS2.snapshot()]
            nodes = 1
            if self.notification is not None:
                for res in self.notification.metrics2_all().values():
                    snap = res.get("metrics2") if isinstance(res, dict) \
                        else None
                    if snap is not None:
                        snaps.append(snap)
                        nodes += 1
            merged = m2.merge(*snaps)
            merged["minio_tpu_v2_cluster_nodes"] = {
                "type": "gauge",
                "help": "Nodes contributing to a cluster metrics scrape.",
                "buckets": None,
                "series": [{"labels": {}, "value": nodes}]}
            return m2.render(merged).encode()

        body = self._cached_cluster_scrape("_cluster_metrics_cache",
                                           build)
        return 200, "text/plain; version=0.0.4", body

    _cluster_drives_cache: tuple[float, bytes] | None = None

    def _health_cluster_drives(self) -> tuple[int, str, bytes]:
        """Cluster drive health: this node's drivemon snapshot merged
        with every peer's (scraped over the `drivemon` peer RPC),
        exactly like the metrics2 fan-in — each drive annotated with
        the node it was observed from. Unreachable peers degrade the
        node count, never the scrape."""
        import json as _json
        from ..obs.drivemon import DRIVEMON, redact_drives

        def build() -> bytes:
            local = DRIVEMON.snapshot()
            drives = [dict(d, node="local") for d in local["drives"]]
            nodes = 1
            if self.notification is not None:
                for i, (key, res) in enumerate(
                        sorted(self.notification.drivemon_all()
                               .items())):
                    snap = res.get("drivemon") if isinstance(res, dict) \
                        else None
                    if snap is None:
                        continue
                    nodes += 1
                    for d in snap.get("drives", []):
                        if isinstance(d, dict):
                            # Anonymous surface: a stable ordinal, not
                            # the peer's internal host:port.
                            drives.append(dict(d, node=f"peer{i}"))
            return _json.dumps(redact_drives({
                "nodes": nodes,
                "drives": drives,
                "suspect": sum(1 for d in drives
                               if d.get("state") == "suspect"),
                "faulty": sum(1 for d in drives
                              if d.get("state") == "faulty"),
            })).encode()

        body = self._cached_cluster_scrape("_cluster_drives_cache",
                                           build)
        return 200, "application/json", body

    _cluster_alerts_cache: tuple[float, bytes] | None = None

    def _alerts_cluster(self) -> tuple[int, str, bytes]:
        """Cluster alert census: this node's watchdog snapshot merged
        with every peer's (scraped over the `alerts` peer RPC) —
        worst state per rule, count of nodes firing it, and an HONEST
        node count: unreachable peers are reported as such instead of
        silently reading as alert-free (same TTL-cached fan-in shape
        as metrics2/drives/timeline)."""
        import json as _json
        from ..obs.watchdog import WATCHDOG, merge_alerts

        def build() -> bytes:
            named = [("local", WATCHDOG.snapshot())]
            unreachable = 0
            if self.notification is not None:
                for i, (key, res) in enumerate(
                        sorted(self.notification.alerts_all()
                               .items())):
                    snap = res.get("alerts") if isinstance(res, dict) \
                        else None
                    if isinstance(snap, dict):
                        # Anonymous surface: a stable ordinal, not the
                        # peer's internal host:port.
                        named.append((f"peer{i}", snap))
                    else:
                        unreachable += 1
            doc = merge_alerts(named)
            doc["unreachable"] = unreachable
            return _json.dumps(doc).encode()

        body = self._cached_cluster_scrape("_cluster_alerts_cache",
                                           build)
        return 200, "application/json", body

    _cluster_usage_cache: tuple[float, bytes] | None = None

    def _usage_cluster(self) -> tuple[int, str, bytes]:
        """Cluster workload attribution: this node's usage snapshot
        merged with every peer's (scraped over the `usage` peer RPC)
        — accounts sum per name, heavy-hitter sketches merge with the
        count-min backing, and the node count is HONEST: unreachable
        peers are reported as such instead of silently reading as
        idle (same TTL-cached fan-in shape as metrics2/alerts)."""
        import json as _json
        from ..obs.usage import USAGE, merge_usage, redact_usage

        def build() -> bytes:
            named = [("local", USAGE.snapshot())]
            unreachable = 0
            if self.notification is not None:
                for i, (key, res) in enumerate(
                        sorted(self.notification.usage_all()
                               .items())):
                    snap = res.get("usage") if isinstance(res, dict) \
                        else None
                    if isinstance(snap, dict):
                        named.append((f"peer{i}", snap))
                    else:
                        unreachable += 1
            doc = merge_usage(named)
            doc["unreachable"] = unreachable
            return _json.dumps(redact_usage(doc)).encode()

        body = self._cached_cluster_scrape("_cluster_usage_cache",
                                           build)
        return 200, "application/json", body

    @staticmethod
    def _parse_n_since(params: dict) -> tuple[int | None, float | None]:
        """The timeline endpoints' shared ?n=/?since= parse (raises
        ValueError on garbage; both routes answer 400)."""
        n = int(params["n"]) if "n" in params else None
        since = float(params["since"]) if "since" in params else None
        return n, since

    _cluster_timeline_cache: tuple[float, bytes] | None = None

    def _timeline_cluster(self, n: int | None = None,
                          since: float | None = None,
                          ) -> tuple[int, str, bytes]:
        """Cluster timeline: this node's sample ring merged with every
        peer's (scraped over the `timeline` peer RPC) on aligned
        1-second buckets — exactly the metrics2/drivemon fan-in shape,
        TTL-cached against scrape amplification. A lagging peer's
        samples still land in their own time buckets (merge_timelines
        keeps per-bucket node counts honest).  The cache holds the
        FULL merge (one shape for every caller); ?n=/?since= slice it
        per request so a 1 Hz mtpu_top poll doesn't re-download the
        whole 15-minute history each refresh."""
        import json as _json
        from ..obs import timeline as tl

        def build() -> bytes:
            snaps = [tl.TIMELINE.snapshot()]
            if self.notification is not None:
                for res in self.notification.timeline_all().values():
                    snap = res.get("timeline") if isinstance(res, dict) \
                        else None
                    if isinstance(snap, dict):
                        snaps.append(snap)
            return _json.dumps(tl.merge_timelines(snaps)).encode()

        body = self._cached_cluster_scrape("_cluster_timeline_cache",
                                           build)
        if n is not None or since is not None:
            doc = _json.loads(body)
            doc["samples"] = tl.slice_samples(doc.get("samples", []),
                                              n=n, since=since)
            body = _json.dumps(doc).encode()
        return 200, "application/json", body

    def _incident_config(self) -> dict:
        """Effective config for incident bundles, credentials masked
        (obs/incidents.py applies the same policy; doubly-redacted is
        fine, un-redacted is not)."""
        if self.config is None:
            return {}
        from ..obs.incidents import _redact_config
        return _redact_config(self.config.dump())

    def _mrf_stats(self) -> dict:
        """MRF heal-queue census across this node's erasure sets
        (depth + drop count; see erasure/heal.py MRFQueue)."""
        from .admin import _pools
        depth = drops = 0
        if self.layer is not None:
            for pool in _pools(self.layer):
                for es in pool.sets:
                    mrf = getattr(es, "mrf", None)
                    if mrf is not None:
                        depth += mrf.depth()
                        drops += mrf.drops
        return {"depth": depth, "drops": drops}

    def _cluster_healthy(self) -> bool:
        """Quorum-aware cluster check (ref ClusterCheckHandler,
        cmd/healthcheck-handler.go:30): every set must have >= read
        quorum of its disks reachable."""
        layer = self.layer
        if layer is None:
            return False
        from .admin import _pools
        for pool in _pools(layer):
            for es in pool.sets:
                online = 0
                for d in es.disks:
                    try:
                        d.disk_info()
                        online += 1
                    except Exception:
                        pass
                if online < es.k:
                    return False
        return True

    def sts_handler(self, req: S3Request, access_key: str) -> S3Response:
        """AssumeRole: mint temp credentials for the authenticated
        identity (ref cmd/sts-handlers.go AssumeRole)."""
        form = dict(urllib.parse.parse_qsl(
            req.body.decode("utf-8", "replace")))
        if form.get("Action") != "AssumeRole":
            raise s3err.ERR_NOT_IMPLEMENTED
        if self.iam is None:
            raise s3err.ERR_NOT_IMPLEMENTED
        try:
            duration = int(form.get("DurationSeconds", "3600"))
        except ValueError:
            raise s3err.ERR_INVALID_ARGUMENT
        session_policy = None
        if form.get("Policy"):
            import json as _json
            try:
                session_policy = _json.loads(form["Policy"])
            except ValueError:
                raise s3err.ERR_MALFORMED_XML
        cred = self.iam.assume_role(access_key, duration, session_policy)
        ns = "https://sts.amazonaws.com/doc/2011-06-15/"
        root = Element("AssumeRoleResponse", ns)
        result = root.child("AssumeRoleResult")
        c = result.child("Credentials")
        c.child("AccessKeyId", cred.access_key)
        c.child("SecretAccessKey", cred.secret_key)
        c.child("SessionToken", cred.session_token)
        c.child("Expiration", _iso8601(cred.expiration))
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def _openid_validator(self):
        """Per-server cached OpenID validator, rebuilt when the
        identity env config changes (tests reconfigure between
        servers; the JWKS cache must survive across requests)."""
        import os as _os
        sig = tuple(_os.environ.get(k, "") for k in (
            "MINIO_IDENTITY_OPENID_JWKS_URL",
            "MINIO_IDENTITY_OPENID_SECRET",
            "MINIO_IDENTITY_OPENID_CLIENT_ID",
            "MINIO_IDENTITY_OPENID_CLAIM_NAME"))
        cached = getattr(self, "_oidc_cache", None)
        if cached is None or cached[0] != sig:
            from ..iam.oidc import OpenIDValidator
            self._oidc_cache = (sig, OpenIDValidator.from_env())
        return self._oidc_cache[1]

    def sts_web_identity(self, req: S3Request) -> S3Response:
        """AssumeRoleWithWebIdentity: validate the bearer JWT — RS256
        against the provider's JWKS (MINIO_IDENTITY_OPENID_JWKS_URL;
        ref cmd/config/identity/openid/jwks.go:30), or HS256 against
        MINIO_IDENTITY_OPENID_SECRET as an explicit dev mode — and mint
        temp creds carrying the token's policy claim (ref
        cmd/sts-handlers.go AssumeRoleWithWebIdentity)."""
        from ..iam.oidc import OIDCError
        form = dict(urllib.parse.parse_qsl(
            req.body.decode("utf-8", "replace")))
        action = form.get("Action")
        if action not in ("AssumeRoleWithWebIdentity",
                          "AssumeRoleWithClientGrants"):
            raise s3err.ERR_NOT_IMPLEMENTED
        validator = self._openid_validator()
        if validator is None or self.iam is None:
            raise s3err.ERR_NOT_IMPLEMENTED
        # ClientGrants sends the provider token as `Token`; WebIdentity
        # as `WebIdentityToken` (ref stsToken/stsWebIdentityToken,
        # cmd/sts-handlers.go:300-303). Validation is identical.
        token = (form.get("Token") or form.get("WebIdentityToken", ""))
        try:
            claims = validator.validate(token)
        except OIDCError:
            raise s3err.ERR_ACCESS_DENIED
        except Exception:
            # JWKS endpoint unreachable: auth cannot be decided.
            raise s3err.ERR_SLOW_DOWN
        subject = claims.get("sub", "")
        policy_name = claims.get(validator.claim_name, "")
        if not subject or not policy_name:
            raise s3err.ERR_ACCESS_DENIED
        try:
            duration = int(form.get("DurationSeconds", "3600"))
        except ValueError:
            raise s3err.ERR_INVALID_ARGUMENT
        try:
            cred = self.iam.assume_role_web_identity(
                subject, policy_name, duration)
        except KeyError:
            raise s3err.ERR_ACCESS_DENIED
        ns = "https://sts.amazonaws.com/doc/2011-06-15/"
        grants = action == "AssumeRoleWithClientGrants"
        root = Element(f"{action}Response", ns)
        result = root.child("ClientGrantsResult" if grants
                            else "AssumeRoleWithWebIdentityResult")
        c = result.child("Credentials")
        c.child("AccessKeyId", cred.access_key)
        c.child("SecretAccessKey", cred.secret_key)
        c.child("SessionToken", cred.session_token)
        c.child("Expiration", _iso8601(cred.expiration))
        result.child("SubjectFromToken" if grants
                     else "SubjectFromWebIdentityToken", subject)
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    def sts_ldap_identity(self, req: S3Request) -> S3Response:
        """AssumeRoleWithLDAPIdentity: authenticate the username and
        password against the configured directory (lookup-bind mode)
        and mint temp creds carrying the policies mapped to the user's
        DN / group DNs (ref cmd/sts-handlers.go:78-93,
        cmd/config/identity/ldap/)."""
        import os as _os

        from ..iam.ldap import LDAPError, LDAPIdentity
        form = dict(urllib.parse.parse_qsl(
            req.body.decode("utf-8", "replace")))
        if form.get("Action") != "AssumeRoleWithLDAPIdentity":
            raise s3err.ERR_NOT_IMPLEMENTED
        ldap = getattr(self, "ldap_identity", None) \
            or LDAPIdentity.from_env(_os.environ)
        if ldap is None or self.iam is None:
            raise s3err.ERR_NOT_IMPLEMENTED
        try:
            duration = int(form.get("DurationSeconds", "3600"))
        except ValueError:
            raise s3err.ERR_INVALID_ARGUMENT
        try:
            user_dn, groups = ldap.authenticate(
                form.get("LDAPUsername", ""),
                form.get("LDAPPassword", ""))
            cred = self.iam.assume_role_ldap_identity(
                user_dn, groups, duration)
        except LDAPError:
            raise s3err.ERR_ACCESS_DENIED
        except KeyError:
            raise s3err.ERR_ACCESS_DENIED
        except OSError:
            raise s3err.ERR_SLOW_DOWN  # directory unreachable
        ns = "https://sts.amazonaws.com/doc/2011-06-15/"
        root = Element("AssumeRoleWithLDAPIdentityResponse", ns)
        result = root.child("AssumeRoleWithLDAPIdentityResult")
        c = result.child("Credentials")
        c.child("AccessKeyId", cred.access_key)
        c.child("SecretAccessKey", cred.secret_key)
        c.child("SessionToken", cred.session_token)
        c.child("Expiration", _iso8601(cred.expiration))
        result.child("LDAPUserDN", user_dn)
        return S3Response(200, root.tobytes(),
                          {"Content-Type": "application/xml"})

    # ---------------- request core (transport-agnostic) ----------------

    def preflight(self, raw_path: str, headers: dict,
                  ) -> tuple[int, list]:
        """CORS preflight decision, shared by the threaded handler's
        do_OPTIONS and the async front door (unauthenticated by
        design; ref the preflight path of the CORS middleware).
        Returns (status, response headers)."""
        origin = headers.get("origin", "")
        want = headers.get("access-control-request-method", "")
        want_headers = [
            x.strip().lower() for x in headers.get(
                "access-control-request-headers", ""
            ).split(",") if x.strip()]
        bucket = raw_path.lstrip("/").split("/", 1)[0]
        rule = None
        if bucket and self.handlers is not None:
            rule = self.handlers.cors_match(bucket, origin, want)
        if rule is not None and want_headers:
            allowed = rule["headers"]
            if "*" not in allowed and any(
                    hh not in allowed for hh in want_headers):
                rule = None  # requested header not allowed
        if rule is None:
            return 403, [("Content-Length", "0")]
        out = [("Access-Control-Allow-Origin", origin),
               ("Access-Control-Allow-Methods",
                ", ".join(rule["methods"]))]
        if rule["headers"]:
            out.append(("Access-Control-Allow-Headers",
                        ", ".join(rule["headers"])))
        if rule["max_age"]:
            out.append(("Access-Control-Max-Age", rule["max_age"]))
        out.append(("Content-Length", "0"))
        return 200, out

    def _serve_one(self, txn) -> None:
        """One request's full lifecycle over an abstract transport
        (`txn`): routing, QoS boundary, trace root, accounting,
        response framing.  Both front ends — the threaded handler
        (`_ThreadedTxn`) and the async event loop (`asyncserver`'s
        `_AsyncTxn`) — drive requests through THIS method, so the
        semantics at the QoS/trace/metrics boundary cannot drift
        between them.  Runs on a handler thread (threaded) or a
        worker-pool thread (async)."""
        server = self
        t0 = time.monotonic()
        root_span = None
        finish_fn = None
        detached = False
        command, raw_path, query = txn.command, txn.raw_path, txn.query
        headers, body, length = txn.headers, txn.body, txn.rx_length
        try:
            if command == "OPTIONS":
                status, hdrs = self.preflight(raw_path, headers)
                txn.send_head(status, hdrs)
                return
            # Internal cluster RPC rides the same port
            # (ref registerDistErasureRouters, cmd/routers.go:26).
            if server.rpc_registry is not None and \
                    raw_path.startswith("/minio-tpu/rpc/"):
                status, rhdrs, rbody = server.rpc_registry.handle(
                    raw_path, headers, body)
                out = list(rhdrs.items())
                out.append(("Content-Length", str(len(rbody))))
                txn.send_head(status, out)
                txn.write(rbody)
                return
            # Health, metrics, admin (ref healthcheck-router.go,
            # metrics-router.go, admin-router.go).
            if raw_path.startswith("/minio-tpu/"):
                res = server.handle_ops(command, raw_path, query,
                                        headers, body)
                status, ctype, rbody = res[:3]
                out = [("Content-Type", ctype)]
                out.extend((res[3] if len(res) > 3 else {}).items())
                out.append(("Content-Length", str(len(rbody))))
                txn.send_head(status, out)
                txn.write(rbody)
                return
            req = S3Request(command, raw_path, query, headers, body)
            if txn.body_stream is not None:
                req.body_stream = txn.body_stream
                req.content_length = txn.content_length
            # Root span of this request's trace, keyed by the
            # x-amz-request-id the response already carries —
            # every layer below (engine, kernels, disks, peer
            # RPC) hangs child spans off it via the contextvar.
            from ..obs.span import TRACER
            root_span = TRACER.begin(
                "s3.request", req.request_id,
                method=command, path=raw_path)
            if root_span is not None:
                root_span.__enter__()
            try:
                resp = server.route_qos(req)
            except APIError as e:
                resp = None
                if getattr(e, "code", "") == "NoSuchBucket":
                    resp = server._federation_redirect(req)
                if resp is None:
                    hdrs = {"Content-Type": "application/xml"}
                    hdrs.update(e.headers())
                    resp = S3Response(
                        e.http_status,
                        e.xml(raw_path, req.request_id),
                        hdrs)
            except (QuorumError, TimeoutError) as e:
                # Quorum races/outages and lock-acquire
                # timeouts are RETRYABLE: 503 SlowDown,
                # matching the reference's
                # InsufficientWriteQuorum/OperationTimedOut ->
                # ErrSlowDown (cmd/api-errors.go:1898). Clients
                # with standard retry policies recover
                # transparently. A burnt request DEADLINE is
                # the same family but its own code: 503
                # RequestTimeout (ref ErrOperationTimedOut).
                from ..logger import Logger
                from ..qos.deadline import DeadlineExceeded
                Logger.get().log_once(
                    f"{command} {raw_path}: quorum: {e}",
                    "s3-handler")
                if isinstance(e, DeadlineExceeded):
                    # Burnt budget = deliberate backpressure,
                    # exempt from slowlog like admission sheds.
                    req.slowlog_exempt = True
                err = (s3err.ERR_REQUEST_TIMEOUT
                       if isinstance(e, DeadlineExceeded)
                       else s3err.ERR_SLOW_DOWN
                       ).with_retry_after(1)
                resp = S3Response(
                    err.http_status,
                    err.xml(raw_path, req.request_id),
                    {"Content-Type": "application/xml",
                     **err.headers()})
            except Exception as e:  # noqa: BLE001
                if isinstance(e, APIError):
                    raise
                from ..logger import Logger
                Logger.get().log_once(
                    f"{command} {raw_path}: "
                    f"{type(e).__name__}: {e}", "s3-handler")
                # A raw per-disk storage error that escaped the
                # engine's quorum reduction still answers its
                # TYPED S3 code (404/409/503/507) instead of an
                # opaque 500 — STORAGE_ERROR_MAP is kept total
                # by lint rule R5.
                err = (s3err.storage_api_error(e)
                       or s3err.ERR_INTERNAL_ERROR)
                resp = S3Response(
                    err.http_status,
                    err.xml(raw_path, req.request_id),
                    {"Content-Type": "application/xml",
                     **err.headers()})
            api = (f"{command}-"
                   f"{'object' if req.key else 'bucket' if req.bucket else 'service'}")
            body_is_stream = not isinstance(
                resp.body, (bytes, bytearray))
            trace_tree = None
            if root_span is not None:
                root_span.name = api
                root_span.tags["statusCode"] = resp.status
                if not body_is_stream or command == "HEAD":
                    # Buffered response: close BEFORE further
                    # socket work so the thread's span context
                    # never leaks into the next keep-alive
                    # request. STREAMING responses keep the
                    # root open — the engine's per-group shard
                    # reads run lazily while the body writes
                    # below, and must still attach; the
                    # _finish_request finally closes it.
                    trace_tree = root_span.finish()
            # Keep-alive hygiene: whatever the handler left unread
            # (auth failures, sheds, burnt deadlines, early errors)
            # must not desync the next pipelined request. Policy is
            # the transport's: threaded drains the remainder inline;
            # async discards small tails loop-side and CLOSES past its
            # cap (or when an Expect body was never solicited), per
            # Content-Length. close_hdr = the response must carry
            # `Connection: close` so the client knows.
            close_hdr = txn.prepare_body_cleanup()
            resp_len = (int(resp.headers.get("Content-Length", 0))
                        if body_is_stream else len(resp.body))

            # Atomic once-guard: on the async path the teardown safety
            # net and the drain task's cleanup can (in pathological
            # interleavings) both reach this from different pool
            # threads — a bare flag's check-then-set window would
            # account the request twice and double-release its slot.
            _fin_mu = threading.Lock()
            _finished = [False]

            def _finish_request():
                nonlocal trace_tree
                with _fin_mu:
                    if _finished[0]:
                        return
                    _finished[0] = True
                qos_release = getattr(resp, "qos_release", None)
                if qos_release is not None:
                    qos_release()  # streaming body done: free
                if root_span is not None and trace_tree is None:
                    trace_tree = root_span.finish()
                dur_ms = (time.monotonic() - t0) * 1000.0
                server.metrics.record(api, resp.status, length,
                                      resp_len)
                from ..obs.metrics2 import METRICS2
                METRICS2.inc("minio_tpu_v2_api_requests_total",
                             {"api": api,
                              "status": resp.status})
                if resp.status >= 500 \
                        and not req.slowlog_exempt:
                    # Per-CLASS 5xx counter: the watchdog's
                    # error-burn numerator (api_requests_total
                    # has per-API status detail but no class).
                    # Sheds/burnt deadlines are EXEMPT like in
                    # the slowlog: deliberate backpressure is
                    # the shed-burn rule's signal, and letting
                    # it bleed into error-burn would page twice
                    # for one brownout.
                    METRICS2.inc(
                        "minio_tpu_v2_api_class_errors_total",
                        {"class": req.qos_class or "read"})
                METRICS2.observe(
                    "minio_tpu_v2_api_request_duration_ms",
                    {"api": api}, dur_ms)
                if length:
                    METRICS2.inc(
                        "minio_tpu_v2_api_rx_bytes_total",
                        None, length)
                if resp_len:
                    METRICS2.inc(
                        "minio_tpu_v2_api_tx_bytes_total",
                        None, resp_len)
                server.bandwidth.record(req.bucket, length,
                                        resp_len)
                # Workload attribution (obs/usage.py): who was
                # this request — bucket/tenant accounts, per-class
                # key/client heavy-hitter sketches, usage_* series.
                # Sheds/burnt deadlines count as shed, not error,
                # mirroring the slowlog exemption split.
                from ..obs.usage import (USAGE,
                                         claimed_access_key)
                USAGE.record(
                    bucket=req.bucket,
                    access_key=(getattr(req, "access_key", "")
                                or claimed_access_key(
                                    headers.get("authorization",
                                                ""),
                                    req.params)),
                    qos_class=req.qos_class or "read",
                    rx=length, tx=resp_len,
                    status=resp.status,
                    shed=(resp.status >= 500
                          and req.slowlog_exempt),
                    key=req.key, client=txn.client_ip,
                    duration_ms=dur_ms,
                    trace_id=req.request_id)
                # Slow-request capture: over-SLO or 5xx lands
                # the full span tree + QoS data in the slowlog
                # ring, annotated with the blamed layer
                # (obs/slowlog.py). Sheds/burnt deadlines are
                # exempt (deliberate backpressure).
                # Worst-request exemplar for the current
                # timeline window: a spike in the 1s series
                # links straight to this request's trace tree
                # (and its slowlog entry when captured).
                from ..obs.timeline import TIMELINE
                TIMELINE.note_request(req.qos_class, dur_ms,
                                      req.request_id)
                from ..obs.slowlog import SLOWLOG
                slow_entry = SLOWLOG.record(
                    api=api, api_class=req.qos_class,
                    method=command, path=raw_path,
                    status=resp.status, duration_ms=dur_ms,
                    request_id=req.request_id,
                    trace=trace_tree,
                    qos={"class": req.qos_class,
                         "waitMs": round(req.qos_wait_ms, 3),
                         "deadlineS": req.qos_deadline_s},
                    exempt=req.slowlog_exempt)
                server.publish_trace(
                    api, command, raw_path, resp.status,
                    dur_ms, length,
                    resp_len, req.request_id,
                    txn.client_ip,
                    getattr(req, "access_key", ""),
                    spans=trace_tree,
                    qos_class=req.qos_class,
                    blamed_layer=(slow_entry["blamedLayer"]
                                  if slow_entry else ""))

            finish_fn = _finish_request
            if not body_is_stream:
                # Buffered: account/publish before the write,
                # as before (the body cannot fail mid-flight).
                _finish_request()
            hdrs_out = [("x-amz-request-id", req.request_id),
                        ("Server", "MinIO-TPU")]
            origin = headers.get("origin", "")
            if origin and req.bucket and \
                    server.handlers is not None:
                rule = server.handlers.cors_match(
                    req.bucket, origin, command)
                if rule is not None:
                    hdrs_out.append(
                        ("Access-Control-Allow-Origin", origin))
                    if rule["expose"]:
                        hdrs_out.append(
                            ("Access-Control-Expose-Headers",
                             ", ".join(rule["expose"])))
            for k, v in resp.headers.items():
                hdrs_out.append((k, v))
            if "Content-Length" not in resp.headers:
                hdrs_out.append(("Content-Length", str(resp_len)))
            if close_hdr:
                hdrs_out.append(("Connection", "close"))
            txn.send_head(resp.status, hdrs_out)
            if command == "HEAD":
                pass
            elif body_is_stream:
                # Streaming GET: blocks flow decoded-chunk by
                # decoded-chunk from the engine to the socket.
                # Mid-stream decode/auth failures (bitrot,
                # compression damage, GCM auth) arrive AFTER the
                # 200 headers went out — the transport aborts the
                # connection so the client sees a short body, never
                # a clean success. The threaded transport drives
                # the body inline; the async one DETACHES (returns
                # True) and its loop pulls chunks, owning finish_fn
                # from here.
                detached = txn.stream_response(resp, raw_path,
                                               _finish_request,
                                               root_span)
            elif resp.body:
                txn.write(resp.body)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            # Safety nets (both idempotent): a streaming
            # response whose client vanished before/while the
            # body wrote still gets its metrics/trace
            # accounted, and an open span context never leaks
            # into the next keep-alive request on this thread.
            # A DETACHED response hands both duties to the async
            # drain task (backstopped by connection teardown).
            if not detached:
                if finish_fn is not None:
                    finish_fn()
                if root_span is not None:
                    root_span.finish()

    # ---------------- HTTP plumbing ----------------

    def start(self, host: str = "127.0.0.1", port: int = 0,
              cert_manager=None) -> int:
        """Boot the front door. Default is the asyncio event-loop
        listener (`s3/asyncserver.py`): accept/parse/keep-alive for
        10k+ sockets on a handful of loop threads, request execution
        on a bounded worker pool through the same `_serve_one` core.
        `MINIO_FRONT_DOOR=threaded` keeps the legacy thread-per-
        connection front end. cert_manager: utils.certs.CertManager
        for HTTPS with hot-reloaded certificates (None = plaintext)."""
        import os as _os
        self.cert_manager = cert_manager
        mode = _os.environ.get("MINIO_FRONT_DOOR",
                               "async").strip().lower()
        if mode == "threaded":
            bound = self._start_threaded(host, port, cert_manager)
        else:
            from .asyncserver import AsyncFrontDoor
            front = AsyncFrontDoor(self, cert_manager=cert_manager)
            try:
                bound = front.start(host, port)
            except BaseException:
                front.pool.shutdown(wait=False)
                front.rpc_pool.shutdown(wait=False)
                front.stream_pool.shutdown(wait=False)
                raise
            self._front_door = front
            # Address shim: callers (webrpc port probe, tests) read
            # `server._httpd.server_address` regardless of front end.
            self._httpd = _BoundAddress(host, bound)
        # Timeline sampler: one process-wide daemon deltaing the
        # registry per sample period (refcounted — the last server to
        # stop stops it; its tick also drives kernprof's rate-limited
        # backend recovery probes).
        from ..obs.timeline import TIMELINE
        TIMELINE.start()
        self._timeline_started = True
        # The loop monitor's watcher and profiler stop with the last
        # server that holds them (obs/loopmon.py ``release``).
        from ..obs.loopmon import LOOPMON
        LOOPMON.hold()
        self._loopmon_held = True
        # Codec autotuner boot probe ladder (ops/autotune.py): one
        # background run per process — tiny known-answer dispatches
        # seeding the measured per-lane crossover; serving starts on
        # the static policy and flips to the plan when the ladder
        # lands (codec probe_on_boot=off skips it; the plan then
        # builds from live dispatch samples only). A server that boots
        # without a layer (a cluster node's, before the formats exist)
        # has no stored config yet: the env and the defaults decide.
        try:
            from ..config.kv import ConfigSys
            config = (self.config if self.config is not None
                      else ConfigSys(None))
            probe_on_boot = config.get("codec", "probe_on_boot") == "on"
        except Exception:
            probe_on_boot = True
        if probe_on_boot:
            from ..ops.autotune import AUTOTUNE
            AUTOTUNE.ensure_probed(background=True)
        # Incident bundles capture server-scoped context (effective
        # config, MRF census) through providers — the recorder itself
        # stays server-agnostic.
        from ..obs.incidents import INCIDENTS
        INCIDENTS.providers["config"] = self._incident_config
        INCIDENTS.providers["mrf"] = self._mrf_stats
        if cert_manager is not None:
            cert_manager.start()
        return bound

    def _start_threaded(self, host: str, port: int,
                        cert_manager) -> int:
        """The legacy thread-per-connection front end
        (MINIO_FRONT_DOOR=threaded): one OS thread per socket,
        BaseHTTPRequestHandler framing, same `_serve_one` core."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Socket timeout: a client that stops reading (streamed GET)
            # or writing (streamed PUT) errors out and releases any held
            # namespace lock instead of pinning it indefinitely (ref the
            # reference's conn read/write deadlines, cmd/http/listener.go).
            timeout = 120

            def log_message(self, *args):  # silence
                pass

            def _reject(self, status: int, msg: str):
                """Pre-dispatch framing error: terse close-delimited
                response (the request body's extent is unknowable, so
                keep-alive is off the table)."""
                self.send_response(status, msg)
                self.send_header("Content-Length", "0")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True

            def _handle(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw_path, _, query = self.path.partition("?")
                    headers = {k.lower(): v
                               for k, v in self.headers.items()}
                    te = headers.get("transfer-encoding", "").strip()
                    if te:
                        if te.lower() != "chunked":
                            return self._reject(501, "Not Implemented")
                        if "content-length" in headers:
                            # CL + TE together is the classic request
                            # smuggling vector: refuse outright.
                            return self._reject(400, "Bad Request")
                        if self.request_version == "HTTP/1.0":
                            return self._reject(400, "Bad Request")
                        return self._handle_chunked(
                            raw_path, query, headers)
                    # Large object PUTs stream: the socket body is never
                    # buffered whole (ref the reference's streaming PUT
                    # pipeline, cmd/erasure-encode.go:73).
                    stream_body = (
                        self.command == "PUT"
                        and length >= server.stream_threshold
                        and not raw_path.startswith("/minio-tpu/")
                        and "/" in raw_path.lstrip("/"))
                    if stream_body:
                        from ..utils.streams import LimitReader
                        body = b""
                        body_stream = LimitReader(self.rfile, length)
                    else:
                        body = self.rfile.read(length) if length else b""
                        body_stream = None
                    txn = _ThreadedTxn(self, raw_path, query, headers,
                                       body, body_stream, length)
                    server._serve_one(txn)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _handle_chunked(self, raw_path, query, headers):
                """Chunked Transfer-Encoding request body: object PUTs
                stream the decoder straight into the erasure pipeline
                (length -1 = unknown); everything else decodes to a
                buffer first — same split as the async front door
                (`asyncserver._HttpConn._begin_chunked`)."""
                from .asyncserver import CHUNKED_BUF_MAX
                from ..utils.streams import (ChunkedTEReader,
                                             ChunkedTooLarge)
                stream_body = (
                    self.command == "PUT"
                    and not raw_path.startswith("/minio-tpu/")
                    and "/" in raw_path.lstrip("/"))
                if stream_body:
                    body = b""
                    body_stream = ChunkedTEReader(
                        self.rfile, MAX_OBJECT_SIZE + 1)
                    length = -1
                else:
                    reader = ChunkedTEReader(self.rfile, CHUNKED_BUF_MAX)
                    acc = bytearray()
                    try:
                        while True:
                            piece = reader.read(64 * 1024)
                            if not piece:
                                break
                            acc += piece
                    except ChunkedTooLarge:
                        return self._reject(413, "Payload Too Large")
                    except ValueError:
                        return self._reject(400, "Bad Request")
                    body = bytes(acc)
                    body_stream = None
                    length = len(body)
                txn = _ThreadedTxn(self, raw_path, query, headers,
                                   body, body_stream, length)
                server._serve_one(txn)

            def do_OPTIONS(self):
                """CORS preflight: unauthenticated by design (ref the
                preflight path of the CORS middleware)."""
                raw_path, _, _q = self.path.partition("?")
                headers = {k.lower(): v for k, v in self.headers.items()}
                status, hdrs = server.preflight(raw_path, headers)
                self.send_response(status)
                for k, v in hdrs:
                    self.send_header(k, v)
                self.end_headers()

            do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _handle

        class _Server(ThreadingHTTPServer):
            # Keep-alive handler threads must never block shutdown
            # (the reference's xhttp.Server drains with a deadline,
            # cmd/http/server.go:117).
            daemon_threads = True
            block_on_close = False

            def finish_request(self, request, client_address):
                # TLS wraps PER CONNECTION in the handler thread — a
                # wrapped LISTENING socket would run the blocking
                # handshake inside the single accept loop, letting one
                # silent client stall every new connection (trivial
                # DoS). The handshake also gets the handler timeout.
                if cert_manager is not None:
                    import ssl as _ssl
                    request.settimeout(Handler.timeout)
                    try:
                        request = cert_manager.context.wrap_socket(
                            request, server_side=True)
                    except (_ssl.SSLError, OSError, TimeoutError):
                        try:
                            request.close()
                        except OSError:
                            pass
                        return
                super().finish_request(request, client_address)

        Handler.timeout = 120  # idle keep-alive reaper
        self._httpd = _Server((host, port), Handler)
        # mtpu-lint: disable=R1 -- the accept loop itself; request context is OPENED per request below it
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def notifier(self):
        return self.handlers.notifier if self.handlers else None

    @property
    def kms(self):
        return self.handlers.kms if self.handlers else None

    def stop(self) -> None:
        if getattr(self, "_timeline_started", False):
            self._timeline_started = False
            from ..obs.timeline import TIMELINE
            TIMELINE.stop()
            # Unregister OUR incident providers (another server may
            # have installed its own since): bound methods would
            # otherwise pin this server's whole object graph for the
            # process lifetime and report a dead server's config in
            # bundles captured after the stop.
            from ..obs.incidents import INCIDENTS
            for key, fn in (("config", self._incident_config),
                            ("mrf", self._mrf_stats)):
                if INCIDENTS.providers.get(key) == fn:
                    del INCIDENTS.providers[key]
        if getattr(self, "cert_manager", None) is not None:
            self.cert_manager.stop()
        if getattr(self, "_front_door", None) is not None:
            # Graceful drain: stop accepting, let in-flight requests
            # finish within the deadline, then abort stragglers —
            # the SIGTERM semantics the threaded front end only
            # approximated with abandoned daemon threads.
            import os as _os
            try:
                drain = float(_os.environ.get(
                    "MINIO_SHUTDOWN_DRAIN", "10") or 10)
            except ValueError:
                drain = 10.0
            self._front_door.stop(drain_s=drain)
            self._front_door = None
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if getattr(self, "_loopmon_held", False):
            self._loopmon_held = False
            from ..obs.loopmon import LOOPMON
            LOOPMON.release()
        # Stop the layer's background daemons (MRF heal worker, disk
        # monitors, quarantine prober) — a stopped server's daemons
        # must not keep churning its disks (tests run many servers per
        # process; leaked healers steal CPU from everything after).
        layer_shutdown = getattr(self.layer, "shutdown", None)
        if callable(layer_shutdown):
            layer_shutdown()
        if self.notifier is not None:
            self.notifier.close()
        if self.handlers is not None:
            self.handlers.replication.close()
        if self.audit is not None:
            self.audit.close()


class _BoundAddress:
    """Duck-typed stand-in for the ThreadingHTTPServer attribute
    surface the rest of the stack reads (`server_address`), when the
    async front door owns the socket."""

    def __init__(self, host: str, port: int):
        self.server_address = (host, port)

    def shutdown(self) -> None:
        pass

    def server_close(self) -> None:
        pass


class _ThreadedTxn:
    """Transport adapter for the legacy thread-per-connection front
    end: one request on a ThreadingHTTPServer handler thread, driven
    through the same `S3Server._serve_one` core as the async front
    door (`s3/asyncserver._AsyncTxn`)."""

    def __init__(self, handler, raw_path: str, query: str,
                 headers: dict, body: bytes, body_stream, length: int):
        self.h = handler
        self.command = handler.command
        self.raw_path = raw_path
        self.query = query
        self.headers = headers
        self.body = body
        self.body_stream = body_stream  # raw LimitReader (or None)
        self.content_length = length  # -1 = chunked (unknown)
        self.rx_length = max(length, 0)
        self.client_ip = handler.client_address[0]
        self.close_after = False
        self.detached = False

    # -- body hygiene ---------------------------------------------------

    def prepare_body_cleanup(self) -> bool:
        """Keep-alive framing after an early response (shed, burnt
        deadline, auth failure) left body bytes unread: drain the
        remainder inline — per Content-Length, so the next pipelined
        request can never desync. The handler THREAD pays for the
        whole drain here, however large (this transport has no way to
        linger a half-closed socket); the async front door instead
        discards small tails loop-side and closes large ones with a
        lingering FIN."""
        bs = self.body_stream
        if bs is None:
            return False
        if bs.remaining() <= 0:
            return False
        try:
            while bs.read(64 * 1024):
                pass
        except (OSError, ValueError):
            self.set_close()
            return True
        return False

    def set_close(self) -> None:
        self.h.close_connection = True
        self.close_after = True

    # -- response plumbing ----------------------------------------------

    def send_head(self, status: int, headers: list) -> None:
        self.h.send_response(status)
        for k, v in headers:
            self.h.send_header(k, v)
        self.h.end_headers()

    def write(self, data) -> None:
        if data:
            self.h.wfile.write(data)

    def stream_response(self, resp, raw_path: str, finish_fn,
                        root_span) -> bool:
        """Drive the iterator body inline on this handler thread (the
        threaded model: a slow reader parks the thread). Returns False
        — never detaches; finish_fn runs here and again (idempotent)
        in the core's finally."""
        h = self.h
        try:
            for chunk in resp.body:
                if chunk:
                    h.wfile.write(chunk)
        except (BrokenPipeError, ConnectionResetError):
            raise
        except Exception as e:  # noqa: BLE001
            from ..logger import Logger
            Logger.get().log_once(
                f"streaming GET {raw_path} aborted "
                f"mid-body: {type(e).__name__}: {e}",
                "s3-stream-abort")
            h.close_connection = True
        finally:
            close = getattr(resp.body, "close", None)
            if close is not None:
                close()
            # Streaming: the trace closes only now, so it carries the
            # lazy shard-read spans and the duration covers the body
            # transfer.
            finish_fn()
        return False
