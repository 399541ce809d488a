"""S3 gateway: an ObjectLayer backed by a REMOTE S3-compatible store
(ref cmd/gateway/s3/gateway-s3.go — every ObjectLayer method maps to a
minio-go client call against the upstream; here the transport is our
own SigV4 S3Client).

Bucket-scoped configs (policy, notification, ...) live in a LOCAL
metadata directory, as gateways have no `.minio.sys` on the remote.

The port's own copy of ``minio_tpu/gateway/s3.py``, with no change in
behaviour.
"""

from __future__ import annotations

import email.utils
import urllib.parse
import xml.etree.ElementTree as ET

from ..erasure.engine import (BucketExists, BucketNotFound,
                              MethodNotAllowed, ObjectInfo,
                              ObjectNotFound)
from ..s3.client import S3Client
from ..storage.metadata import ObjectPartInfo


def _strip_ns(root: ET.Element) -> ET.Element:
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


def _parse_http_date(s: str) -> float:
    try:
        return email.utils.parsedate_to_datetime(s).timestamp()
    except (TypeError, ValueError):
        return 0.0


def _parse_iso(s: str) -> float:
    import calendar
    import time as _t
    try:
        return calendar.timegm(_t.strptime(s.split(".")[0].rstrip("Z"),
                                           "%Y-%m-%dT%H:%M:%S"))
    except ValueError:
        return 0.0


class GatewayUnsupported(MethodNotAllowed):
    """Operation has no upstream analog (ref errors like
    NotImplemented in gateway-s3.go)."""


class S3Gateway:
    name = "s3"

    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str, meta_dir: str):
        self.host, self.port = host, port
        self.access_key, self.secret_key = access_key, secret_key
        self.meta_dir = meta_dir

    def new_gateway_layer(self) -> "S3GatewayLayer":
        return S3GatewayLayer(
            S3Client(self.host, self.port, self.access_key,
                     self.secret_key), self.meta_dir)


class S3GatewayLayer:
    """ObjectLayer over a remote S3 endpoint."""

    supports_versioning = False
    # API-layer SSE/compression envelopes live in backend metadata the
    # upstream would drop; the reference likewise disables local SSE
    # in gateway mode unless the backend handles it.
    supports_transforms = False

    def __init__(self, client: S3Client, meta_dir: str):
        self.client = client
        # Local home for bucket metadata / IAM config stores; also
        # keeps the admin plane's disk iteration meaningful.
        from ..storage.xl import XLStorage
        self.meta_disk = XLStorage(meta_dir)
        self.disks = [self.meta_disk]
        self.k, self.m = 1, 0
        self.multipart = _GatewayMultipart(self)
        self.healer = _GatewayHealer()

    # -- helpers --------------------------------------------------------

    def _raise_for(self, resp, bucket: str, key: str = "") -> None:
        if resp.status == 404:
            if key and b"NoSuchBucket" not in resp.body:
                raise ObjectNotFound(f"{bucket}/{key}")
            raise BucketNotFound(bucket)
        if resp.status == 409:
            raise BucketExists(bucket)
        if resp.status >= 400:
            raise MethodNotAllowed(
                f"upstream {resp.status}: {resp.body[:200]!r}")

    @staticmethod
    def _info_from_headers(bucket: str, key: str, headers: dict,
                           size: int | None = None) -> ObjectInfo:
        meta = {"content-type": headers.get("content-type",
                                            "application/octet-stream")}
        for k, v in headers.items():
            if k.startswith("x-amz-meta-"):
                meta[k] = v
        return ObjectInfo(
            bucket=bucket, name=key,
            size=(size if size is not None
                  else int(headers.get("content-length", 0))),
            etag=headers.get("etag", "").strip('"'),
            mod_time=_parse_http_date(headers.get("last-modified", "")),
            version_id=headers.get("x-amz-version-id", ""),
            metadata=meta)

    # -- buckets --------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        self._raise_for(self.client.make_bucket(bucket), bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        r = self.client.delete_bucket(bucket)
        if r.status == 409:
            raise BucketExists(bucket)  # not empty, same mapping as FS
        if r.status not in (200, 204):
            self._raise_for(r, bucket)

    def list_buckets(self) -> list[dict]:
        r = self.client.request("GET", "/")
        self._raise_for(r, "")
        out = []
        for b in _strip_ns(ET.fromstring(r.body)).iter("Bucket"):
            out.append({"name": b.findtext("Name") or "",
                        "created": _parse_iso(
                            b.findtext("CreationDate") or "")})
        return out

    def bucket_exists(self, bucket: str) -> bool:
        return self.client.request("HEAD", f"/{bucket}").status == 200

    # -- objects --------------------------------------------------------

    def put_object(self, bucket: str, object_name: str, data: bytes,
                   metadata: dict | None = None,
                   versioned: bool = False,
                   parity_shards: int | None = None) -> ObjectInfo:
        if versioned:
            raise GatewayUnsupported("gateway: no versioning")
        headers = {}
        for k, v in (metadata or {}).items():
            if k.startswith("x-amz-meta-") or k in ("content-type",
                                                    "x-amz-tagging"):
                headers[k] = v
        r = self.client.put_object(bucket, object_name, data,
                                   headers=headers)
        self._raise_for(r, bucket, object_name)
        return self._info_from_headers(bucket, object_name, r.headers,
                                       size=len(data))

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1, version_id: str = "",
                   ) -> tuple[bytes, ObjectInfo]:
        headers = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            headers["range"] = f"bytes={offset}-{end}"
        r = self.client.get_object(bucket, object_name, headers=headers)
        self._raise_for(r, bucket, object_name)
        info = self._info_from_headers(bucket, object_name, r.headers)
        info.size = len(r.body) if offset or length >= 0 else info.size
        return r.body, info

    def get_object_info(self, bucket: str, object_name: str,
                        version_id: str = "") -> ObjectInfo:
        r = self.client.head_object(bucket, object_name)
        if r.status == 404:
            # HEAD bodies are empty; probe the bucket to tell
            # NoSuchBucket from NoSuchKey.
            if not self.bucket_exists(bucket):
                raise BucketNotFound(bucket)
            raise ObjectNotFound(f"{bucket}/{object_name}")
        self._raise_for(r, bucket, object_name)
        return self._info_from_headers(bucket, object_name, r.headers)

    def delete_object(self, bucket: str, object_name: str,
                      version_id: str = "",
                      versioned: bool = False) -> ObjectInfo:
        r = self.client.delete_object(bucket, object_name)
        if r.status not in (200, 204):
            self._raise_for(r, bucket, object_name)
        return ObjectInfo(bucket=bucket, name=object_name)

    def object_exists(self, bucket: str, object_name: str) -> bool:
        return self.client.head_object(bucket,
                                       object_name).status == 200

    def put_object_tags(self, bucket: str, object_name: str, tags: str,
                        version_id: str = "") -> None:
        enc = urllib.parse.quote(object_name, safe="/-_.~")
        if not tags:
            r = self.client.request("DELETE", f"/{bucket}/{enc}",
                                    query="tagging")
        else:
            from xml.sax.saxutils import escape
            body = ["<Tagging><TagSet>"]
            for pair in tags.split("&"):
                k, _, v = pair.partition("=")
                body.append(
                    f"<Tag>"
                    f"<Key>{escape(urllib.parse.unquote_plus(k))}</Key>"
                    f"<Value>{escape(urllib.parse.unquote_plus(v))}"
                    f"</Value></Tag>")
            body.append("</TagSet></Tagging>")
            r = self.client.request("PUT", f"/{bucket}/{enc}",
                                    query="tagging",
                                    body="".join(body).encode())
        if r.status not in (200, 204):
            self._raise_for(r, bucket, object_name)

    def get_object_tags(self, bucket: str, object_name: str,
                        version_id: str = "") -> str:
        """Tags live upstream, not in HEAD metadata: fetch them (the
        handler prefers this hook when a layer provides it)."""
        enc = urllib.parse.quote(object_name, safe="/-_.~")
        r = self.client.request("GET", f"/{bucket}/{enc}",
                                query="tagging")
        self._raise_for(r, bucket, object_name)
        pairs = []
        for t in _strip_ns(ET.fromstring(r.body)).iter("Tag"):
            pairs.append(
                f"{urllib.parse.quote_plus(t.findtext('Key') or '')}="
                f"{urllib.parse.quote_plus(t.findtext('Value') or '')}")
        return "&".join(pairs)

    def update_object_metadata(self, bucket: str, object_name: str,
                               updates: dict,
                               version_id: str = "") -> None:
        raise GatewayUnsupported("gateway: metadata rewrite")

    # -- listing --------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000,
                     marker: str = "") -> list[ObjectInfo]:
        out: list[ObjectInfo] = []
        token = ""
        while len(out) < max_keys:
            q = {"list-type": "2",
                 "max-keys": str(min(1000, max_keys - len(out)))}
            if prefix:
                q["prefix"] = prefix
            if token:
                q["continuation-token"] = token
            r = self.client.request(
                "GET", f"/{bucket}", query=urllib.parse.urlencode(q))
            self._raise_for(r, bucket)
            doc = _strip_ns(ET.fromstring(r.body))
            for c in doc.iter("Contents"):
                out.append(ObjectInfo(
                    bucket=bucket, name=c.findtext("Key") or "",
                    size=int(c.findtext("Size") or "0"),
                    etag=(c.findtext("ETag") or "").strip('"'),
                    mod_time=_parse_iso(
                        c.findtext("LastModified") or "")))
            token = doc.findtext("NextContinuationToken") or ""
            if not token:
                break
        return out[:max_keys]

    def list_object_versions(self, bucket: str, prefix: str = "",
                             max_keys: int = 1000,
                             marker: str = "") -> list[ObjectInfo]:
        raise GatewayUnsupported("gateway: versions listing")

    def walk_object_names(self, bucket: str) -> list[str]:
        return [o.name for o in self.list_objects(bucket,
                                                  max_keys=1_000_000)]


class _GatewayMultipart:
    """Multipart pass-through to the upstream (ref gateway-s3.go
    NewMultipartUpload/PutObjectPart/Complete...)."""

    def __init__(self, layer: S3GatewayLayer):
        self.layer = layer
        self.client = layer.client

    def _path(self, bucket, key):
        return f"/{bucket}/{urllib.parse.quote(key, safe='/-_.~')}"

    def new_multipart_upload(self, bucket, object_name,
                             metadata=None) -> str:
        headers = {k: v for k, v in (metadata or {}).items()
                   if k.startswith("x-amz-meta-")
                   or k == "content-type"}
        r = self.client.request("POST", self._path(bucket, object_name),
                                query="uploads", headers=headers)
        self.layer._raise_for(r, bucket, object_name)
        return _strip_ns(ET.fromstring(r.body)).findtext(
            "UploadId") or ""

    def put_object_part(self, bucket, object_name, upload_id,
                        part_number, data, actual_size=None) -> dict:
        from ..erasure.multipart import UploadNotFound
        q = urllib.parse.urlencode({"partNumber": str(part_number),
                                    "uploadId": upload_id})
        r = self.client.request("PUT", self._path(bucket, object_name),
                                query=q, body=data)
        if r.status == 404:
            raise UploadNotFound(upload_id)
        self.layer._raise_for(r, bucket, object_name)
        return {"number": part_number, "size": len(data),
                "etag": r.headers.get("etag", "").strip('"')}

    def list_parts(self, bucket, object_name, upload_id) -> list[dict]:
        from ..erasure.multipart import UploadNotFound
        q = urllib.parse.urlencode({"uploadId": upload_id})
        r = self.client.request("GET", self._path(bucket, object_name),
                                query=q)
        if r.status == 404:
            raise UploadNotFound(upload_id)
        self.layer._raise_for(r, bucket, object_name)
        out = []
        for p in _strip_ns(ET.fromstring(r.body)).iter("Part"):
            out.append({
                "number": int(p.findtext("PartNumber") or "0"),
                "size": int(p.findtext("Size") or "0"),
                "etag": (p.findtext("ETag") or "").strip('"')})
        return out

    def get_upload_meta(self, bucket, object_name, upload_id) -> dict:
        # Upstream holds the metadata; nothing SSE-sealed locally.
        return {}

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts) -> ObjectInfo:
        from ..erasure.multipart import UploadNotFound
        body = ["<CompleteMultipartUpload>"]
        for num, etag in parts:
            body.append(f"<Part><PartNumber>{num}</PartNumber>"
                        f"<ETag>\"{etag}\"</ETag></Part>")
        body.append("</CompleteMultipartUpload>")
        q = urllib.parse.urlencode({"uploadId": upload_id})
        r = self.client.request("POST", self._path(bucket, object_name),
                                query=q, body="".join(body).encode())
        if r.status == 404:
            raise UploadNotFound(upload_id)
        self.layer._raise_for(r, bucket, object_name)
        doc = _strip_ns(ET.fromstring(r.body))
        # S3 can answer 200 with an <Error> document for Complete.
        if doc.tag == "Error" or not doc.findtext("ETag"):
            raise MethodNotAllowed(
                f"upstream complete failed: {r.body[:200]!r}")
        return ObjectInfo(
            bucket=bucket, name=object_name,
            etag=(doc.findtext("ETag") or "").strip('"'),
            parts=[ObjectPartInfo(number=n, size=0, actual_size=0,
                                  etag=e)
                   for n, e in parts])

    def abort_multipart_upload(self, bucket, object_name,
                               upload_id) -> None:
        from ..erasure.multipart import UploadNotFound
        q = urllib.parse.urlencode({"uploadId": upload_id})
        r = self.client.request("DELETE",
                                self._path(bucket, object_name), query=q)
        if r.status == 404:
            raise UploadNotFound(upload_id)
        if r.status not in (200, 204):
            self.layer._raise_for(r, bucket, object_name)

    def list_uploads(self, bucket, prefix="") -> list[dict]:
        q = {"uploads": ""}
        if prefix:
            q["prefix"] = prefix
        r = self.client.request("GET", f"/{bucket}",
                                query=urllib.parse.urlencode(q))
        self.layer._raise_for(r, bucket)
        out = []
        for u in _strip_ns(ET.fromstring(r.body)).iter("Upload"):
            out.append({
                "object": u.findtext("Key") or "",
                "upload_id": u.findtext("UploadId") or "",
                "created": _parse_iso(u.findtext("Initiated") or "")})
        return out


class _GatewayHealer:
    """Gateways own no shards; healing is a backend concern (ref
    gateway HealObject -> NotImplemented)."""

    def heal_object(self, bucket, object_name, dry_run=False):
        raise GatewayUnsupported("gateway: heal")

    heal_object_or_queue = heal_object

    def heal_bucket(self, bucket):
        raise GatewayUnsupported("gateway: heal")

    def heal_all(self):
        return []
