"""Cloud gateways: the S3 front end over Azure Blob, Google Cloud
Storage, and HDFS (ref cmd/gateway/azure/gateway-azure.go,
cmd/gateway/gcs/gateway-gcs.go, cmd/gateway/hdfs/gateway-hdfs.go —
together ~7k LoC of SDK plumbing; here each backend is a small REST
client over its actual wire API, sharing one ObjectLayer adapter).

Shared shape: `_BlobGatewayLayer` implements the ObjectLayer contract
(same surface as gateway/s3.S3GatewayLayer) on top of nine primitive
backend operations. Multipart uploads stage parts LOCALLY and commit
as one upload — the reference's azure/gcs gateways likewise emulate
multipart on backends whose native chunk APIs don't match S3 part
semantics. Tags live in the local metadata dir (no upstream analog).

Backends:
  AzureBlobBackend  Blob REST API, SharedKey authorization
  GCSBackend        GCS JSON API, Bearer-token (or anonymous) auth
  HDFSBackend       WebHDFS REST, one-redirect CREATE/OPEN

The port's own copy of ``minio_tpu/gateway/cloud.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import http.client
import json
import os
import time
import urllib.parse

from ..erasure.engine import (BucketExists, BucketNotFound, ObjectInfo,
                              ObjectNotFound)
from .s3 import (GatewayUnsupported, _GatewayHealer, _parse_http_date,
                 _parse_iso)


def _http(host: str, port: int, https: bool, timeout: float = 30.0):
    cls = http.client.HTTPSConnection if https else \
        http.client.HTTPConnection
    return cls(host, port, timeout=timeout)


class _Resp:
    def __init__(self, status: int, headers: dict, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body


def _request(host, port, https, method, path, query="", body=b"",
             headers=None) -> _Resp:
    conn = _http(host, port, https)
    try:
        url = path + (f"?{query}" if query else "")
        conn.request(method, url, body=body, headers=headers or {})
        r = conn.getresponse()
        return _Resp(r.status,
                     {k.lower(): v for k, v in r.getheaders()},
                     r.read())
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Azure Blob (SharedKey)


class AzureBlobBackend:
    """Azure Blob REST: containers=buckets, block blobs=objects
    (ref gateway-azure.go; auth per 'Authorize with Shared Key')."""

    def __init__(self, host: str, port: int, account: str, key_b64: str,
                 https: bool = False):
        self.host, self.port, self.https = host, port, https
        self.account = account
        self.key = base64.b64decode(key_b64) if key_b64 else b""

    def _auth(self, method, path, query_pairs, headers, body_len):
        # Canonicalized headers: x-ms-* sorted; canonicalized resource:
        # /account/path plus sorted query params (one per line).
        ms = sorted((k.lower(), v) for k, v in headers.items()
                    if k.lower().startswith("x-ms-"))
        canon_headers = "".join(f"{k}:{v}\n" for k, v in ms)
        canon_res = f"/{self.account}{path}"
        for k in sorted(dict(query_pairs)):
            canon_res += f"\n{k}:{dict(query_pairs)[k]}"
        sts = "\n".join([
            method, "", "",                      # content-encoding/lang
            str(body_len) if body_len else "",   # content-length
            "", headers.get("content-type", ""), "", "", "", "", "", "",
            canon_headers + canon_res])
        sig = base64.b64encode(hmac.new(
            self.key, sts.encode(), hashlib.sha256).digest()).decode()
        return f"SharedKey {self.account}:{sig}"

    def _call(self, method, path, query_pairs=(), body=b"",
              extra=None) -> _Resp:
        headers = {"x-ms-date": email.utils.formatdate(usegmt=True),
                   "x-ms-version": "2021-08-06"}
        headers.update(extra or {})
        if body:
            headers["Content-Length"] = str(len(body))
        if self.key:
            headers["Authorization"] = self._auth(
                method, path, query_pairs, headers, len(body))
        query = urllib.parse.urlencode(list(query_pairs))
        return _request(self.host, self.port, self.https, method, path,
                        query, body, headers)

    @staticmethod
    def _blob_path(bucket, key):
        return f"/{bucket}/{urllib.parse.quote(key, safe='/-_.~')}"

    def make_bucket(self, b):
        r = self._call("PUT", f"/{b}", (("restype", "container"),))
        if r.status == 409:
            raise BucketExists(b)
        if r.status // 100 != 2:
            raise IOError(f"azure create container: {r.status}")

    def delete_bucket(self, b):
        r = self._call("DELETE", f"/{b}", (("restype", "container"),))
        if r.status == 404:
            raise BucketNotFound(b)
        if r.status // 100 != 2:
            raise IOError(f"azure delete container: {r.status}")

    def list_buckets(self):
        r = self._call("GET", "/", (("comp", "list"),))
        if r.status != 200:
            raise IOError(f"azure list containers: {r.status}")
        import xml.etree.ElementTree as ET
        out = []
        for c in ET.fromstring(r.body).iter("Container"):
            out.append({"name": c.findtext("Name") or "",
                        "created": _parse_http_date(
                            c.findtext(".//Last-Modified") or "")})
        return out

    def bucket_exists(self, b):
        return self._call("HEAD", f"/{b}",
                          (("restype", "container"),)).status == 200

    def put(self, b, k, data, content_type):
        r = self._call("PUT", self._blob_path(b, k), body=data, extra={
            "x-ms-blob-type": "BlockBlob",
            "content-type": content_type or "application/octet-stream"})
        if r.status == 404:
            raise BucketNotFound(b)
        if r.status // 100 != 2:
            raise IOError(f"azure put blob: {r.status}")
        return r.headers.get("etag", "").strip('"')

    def get(self, b, k, offset, length):
        extra = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            extra["x-ms-range"] = f"bytes={offset}-{end}"
        r = self._call("GET", self._blob_path(b, k), extra=extra)
        if r.status == 404:
            raise ObjectNotFound(f"{b}/{k}")
        if r.status // 100 != 2:
            raise IOError(f"azure get blob: {r.status}")
        return r.body, {
            "etag": r.headers.get("etag", "").strip('"'),
            "mtime": _parse_http_date(
                r.headers.get("last-modified", "")),
            "content-type": r.headers.get("content-type", "")}

    def head(self, b, k):
        r = self._call("HEAD", self._blob_path(b, k))
        if r.status == 404:
            raise ObjectNotFound(f"{b}/{k}")
        if r.status // 100 != 2:
            raise IOError(f"azure head blob: {r.status}")
        return (int(r.headers.get("content-length", 0)),
                _parse_http_date(r.headers.get("last-modified", "")),
                r.headers.get("etag", "").strip('"'),
                r.headers.get("content-type", ""))

    def delete(self, b, k):
        r = self._call("DELETE", self._blob_path(b, k))
        if r.status not in (200, 202, 204, 404):
            raise IOError(f"azure delete blob: {r.status}")

    def list(self, b, prefix):
        import xml.etree.ElementTree as ET
        out = []
        marker = ""
        while True:
            pairs = [("restype", "container"), ("comp", "list")]
            if prefix:
                pairs.append(("prefix", prefix))
            if marker:
                pairs.append(("marker", marker))
            r = self._call("GET", f"/{b}", tuple(pairs))
            if r.status == 404:
                raise BucketNotFound(b)
            if r.status != 200:
                raise IOError(f"azure list blobs: {r.status}")
            doc = ET.fromstring(r.body)
            for blob in doc.iter("Blob"):
                props = blob.find("Properties")
                out.append((
                    blob.findtext("Name") or "",
                    int(props.findtext("Content-Length") or "0")
                    if props is not None else 0,
                    _parse_http_date(
                        props.findtext("Last-Modified") or "")
                    if props is not None else 0.0,
                    (props.findtext("Etag") or "").strip('"')
                    if props is not None else ""))
            marker = doc.findtext("NextMarker") or ""
            if not marker:
                return out


# ---------------------------------------------------------------------------
# Google Cloud Storage (JSON API)


class GCSBackend:
    """GCS JSON API (ref gateway-gcs.go; storage/v1 + upload/storage/v1
    media uploads). Auth: Bearer token (MINIO_GCS_TOKEN) — anonymous
    against emulators/fakes."""

    def __init__(self, host: str, port: int, project: str,
                 token: str = "", https: bool = False):
        self.host, self.port, self.https = host, port, https
        self.project = project
        self.token = token

    def _hdrs(self, extra=None):
        h = dict(extra or {})
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _call(self, method, path, query="", body=b"", extra=None):
        return _request(self.host, self.port, self.https, method, path,
                        query, body, self._hdrs(extra))

    @staticmethod
    def _obj(key):
        return urllib.parse.quote(key, safe="")

    def make_bucket(self, b):
        r = self._call("POST", "/storage/v1/b",
                       query=urllib.parse.urlencode(
                           {"project": self.project}),
                       body=json.dumps({"name": b}).encode(),
                       extra={"Content-Type": "application/json"})
        if r.status == 409:
            raise BucketExists(b)
        if r.status // 100 != 2:
            raise IOError(f"gcs insert bucket: {r.status}")

    def delete_bucket(self, b):
        r = self._call("DELETE", f"/storage/v1/b/{b}")
        if r.status == 404:
            raise BucketNotFound(b)
        if r.status == 409:
            raise BucketExists(b)  # not empty
        if r.status // 100 != 2:
            raise IOError(f"gcs delete bucket: {r.status}")

    def list_buckets(self):
        r = self._call("GET", "/storage/v1/b",
                       query=urllib.parse.urlencode(
                           {"project": self.project}))
        if r.status != 200:
            raise IOError(f"gcs list buckets: {r.status}")
        doc = json.loads(r.body or b"{}")
        return [{"name": it.get("name", ""),
                 "created": _parse_iso(it.get("timeCreated", ""))}
                for it in doc.get("items", [])]

    def bucket_exists(self, b):
        return self._call("GET", f"/storage/v1/b/{b}").status == 200

    def put(self, b, k, data, content_type):
        q = urllib.parse.urlencode({"uploadType": "media", "name": k})
        r = self._call("POST", f"/upload/storage/v1/b/{b}/o", query=q,
                       body=data,
                       extra={"Content-Type": content_type
                              or "application/octet-stream"})
        if r.status == 404:
            raise BucketNotFound(b)
        if r.status // 100 != 2:
            raise IOError(f"gcs insert object: {r.status}")
        return json.loads(r.body or b"{}").get("etag", "")

    def get(self, b, k, offset, length):
        extra = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            extra["Range"] = f"bytes={offset}-{end}"
        r = self._call("GET", f"/storage/v1/b/{b}/o/{self._obj(k)}",
                       query="alt=media", extra=extra)
        if r.status == 404:
            raise ObjectNotFound(f"{b}/{k}")
        if r.status // 100 != 2:
            raise IOError(f"gcs get object: {r.status}")
        info = {}
        if r.headers.get("etag"):
            info = {"etag": r.headers["etag"].strip('"'),
                    "mtime": _parse_http_date(
                        r.headers.get("last-modified", "")),
                    "content-type": r.headers.get("content-type", "")}
        return r.body, info

    def head(self, b, k):
        r = self._call("GET", f"/storage/v1/b/{b}/o/{self._obj(k)}")
        if r.status == 404:
            raise ObjectNotFound(f"{b}/{k}")
        if r.status != 200:
            raise IOError(f"gcs stat object: {r.status}")
        doc = json.loads(r.body or b"{}")
        return (int(doc.get("size", 0)),
                _parse_iso(doc.get("updated", "")),
                doc.get("etag", ""),
                doc.get("contentType", ""))

    def delete(self, b, k):
        r = self._call("DELETE",
                       f"/storage/v1/b/{b}/o/{self._obj(k)}")
        if r.status not in (200, 204, 404):
            raise IOError(f"gcs delete object: {r.status}")

    def list(self, b, prefix):
        out = []
        token = ""
        while True:
            q = {}
            if prefix:
                q["prefix"] = prefix
            if token:
                q["pageToken"] = token
            r = self._call("GET", f"/storage/v1/b/{b}/o",
                           query=urllib.parse.urlencode(q))
            if r.status == 404:
                raise BucketNotFound(b)
            if r.status != 200:
                raise IOError(f"gcs list objects: {r.status}")
            doc = json.loads(r.body or b"{}")
            out.extend(
                (it.get("name", ""), int(it.get("size", 0)),
                 _parse_iso(it.get("updated", "")), it.get("etag", ""))
                for it in doc.get("items", []))
            token = doc.get("nextPageToken", "")
            if not token:
                return out


# ---------------------------------------------------------------------------
# HDFS (WebHDFS)


class HDFSBackend:
    """WebHDFS REST (ref gateway-hdfs.go maps buckets to directories
    under a root path). CREATE/OPEN follow one NameNode->DataNode
    redirect, as the protocol specifies."""

    def __init__(self, host: str, port: int, root: str = "/minio-tpu",
                 user: str = "minio", https: bool = False):
        self.host, self.port, self.https = host, port, https
        self.root = root.rstrip("/")
        self.user = user

    def _path(self, b, k=""):
        p = f"{self.root}/{b}"
        if k:
            p += "/" + k
        return "/webhdfs/v1" + urllib.parse.quote(p, safe="/-_.~")

    def _call(self, method, path, op, params=None, body=b"",
              follow=True, body_after_redirect=False) -> _Resp:
        q = {"op": op, "user.name": self.user}
        q.update(params or {})
        # WebHDFS CREATE/APPEND: the NameNode request carries NO data —
        # it answers 307 with the DataNode location, which gets the
        # body (sending it twice would double every PUT's wire cost).
        first_body = b"" if body_after_redirect else body
        r = _request(self.host, self.port, self.https, method, path,
                     urllib.parse.urlencode(q), first_body)
        if follow and r.status in (307, 302):
            loc = urllib.parse.urlsplit(r.headers.get("location", ""))
            r = _request(loc.hostname or self.host,
                         loc.port or self.port, self.https, method,
                         loc.path, loc.query, body)
        return r

    def make_bucket(self, b):
        st = self._call("GET", self._path(b), "GETFILESTATUS",
                        follow=False)
        if st.status == 200:
            raise BucketExists(b)
        r = self._call("PUT", self._path(b), "MKDIRS")
        if r.status != 200:
            raise IOError(f"hdfs mkdirs: {r.status}")

    def delete_bucket(self, b):
        if self.list(b, ""):
            raise BucketExists(b)  # not empty
        r = self._call("DELETE", self._path(b), "DELETE",
                       {"recursive": "true"})
        if r.status != 200:
            raise IOError(f"hdfs delete: {r.status}")

    def list_buckets(self):
        r = self._call("GET", "/webhdfs/v1" + (self.root or "/"),
                       "LISTSTATUS")
        if r.status == 404:
            return []
        doc = json.loads(r.body or b"{}")
        out = []
        for st in doc.get("FileStatuses", {}).get("FileStatus", []):
            if st.get("type") == "DIRECTORY":
                out.append({"name": st.get("pathSuffix", ""),
                            "created": st.get("modificationTime",
                                              0) / 1000.0})
        return out

    def bucket_exists(self, b):
        r = self._call("GET", self._path(b), "GETFILESTATUS",
                       follow=False)
        return r.status == 200

    def put(self, b, k, data, content_type):
        r = self._call("PUT", self._path(b, k), "CREATE",
                       {"overwrite": "true"}, body=data,
                       body_after_redirect=True)
        if r.status not in (200, 201):
            raise IOError(f"hdfs create: {r.status}")
        return hashlib.md5(data).hexdigest()

    def get(self, b, k, offset, length):
        params = {}
        if offset:
            params["offset"] = str(offset)
        if length >= 0:
            params["length"] = str(length)
        r = self._call("GET", self._path(b, k), "OPEN", params)
        if r.status == 404:
            raise ObjectNotFound(f"{b}/{k}")
        if r.status != 200:
            raise IOError(f"hdfs open: {r.status}")
        return r.body, {}

    def head(self, b, k):
        r = self._call("GET", self._path(b, k), "GETFILESTATUS",
                       follow=False)
        if r.status == 404:
            raise ObjectNotFound(f"{b}/{k}")
        if r.status != 200:
            raise IOError(f"hdfs stat: {r.status}")
        st = json.loads(r.body).get("FileStatus", {})
        if st.get("type") == "DIRECTORY":
            raise ObjectNotFound(f"{b}/{k}")
        return (int(st.get("length", 0)),
                st.get("modificationTime", 0) / 1000.0, "", "")

    def delete(self, b, k):
        self._call("DELETE", self._path(b, k), "DELETE")

    def list(self, b, prefix):
        """Recursive walk from the bucket dir (WebHDFS lists one level;
        object keys with '/' become subdirectories, like the
        reference's hdfs gateway)."""
        out = []
        stack = [""]
        while stack:
            rel = stack.pop()
            path = self._path(b, rel) if rel else self._path(b)
            r = self._call("GET", path, "LISTSTATUS", follow=False)
            if r.status == 404:
                if not rel:
                    raise BucketNotFound(b)
                continue
            doc = json.loads(r.body or b"{}")
            for st in doc.get("FileStatuses", {}).get("FileStatus", []):
                name = st.get("pathSuffix", "")
                full = f"{rel}/{name}" if rel else name
                if st.get("type") == "DIRECTORY":
                    # Prune subtrees that can neither extend nor be
                    # extended by the prefix.
                    subdir = full + "/"
                    if (not prefix or subdir.startswith(prefix)
                            or prefix.startswith(subdir)):
                        stack.append(full)
                elif full.startswith(prefix):
                    out.append((full, int(st.get("length", 0)),
                                st.get("modificationTime", 0) / 1000.0,
                                ""))
        return sorted(out)


# ---------------------------------------------------------------------------
# shared ObjectLayer adapter


class _BlobGatewayLayer:
    """ObjectLayer over a blob-store backend (same contract as
    gateway/s3.S3GatewayLayer; consumed by S3Server unchanged)."""

    supports_versioning = False
    supports_transforms = False

    def __init__(self, backend, meta_dir: str):
        self.backend = backend
        from ..storage.xl import XLStorage
        os.makedirs(meta_dir, exist_ok=True)
        self.meta_disk = XLStorage(meta_dir)
        self.disks = [self.meta_disk]
        self.k, self.m = 1, 0
        self.meta_dir = meta_dir
        self.multipart = _LocalStageMultipart(self)
        self.healer = _GatewayHealer()

    # -- buckets --------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        self.backend.make_bucket(bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self.backend.delete_bucket(bucket)

    def list_buckets(self) -> list[dict]:
        return self.backend.list_buckets()

    def bucket_exists(self, bucket: str) -> bool:
        return self.backend.bucket_exists(bucket)

    # -- objects --------------------------------------------------------

    def put_object(self, bucket: str, object_name: str, data,
                   metadata: dict | None = None,
                   versioned: bool = False,
                   parity_shards: int | None = None) -> ObjectInfo:
        if versioned:
            raise GatewayUnsupported("gateway: no versioning")
        if not isinstance(data, (bytes, bytearray)):
            from ..utils.streams import ensure_reader
            r = ensure_reader(data)
            chunks = []
            while chunk := r.read(1 << 20):
                chunks.append(chunk)
            data = b"".join(chunks)
        meta = metadata or {}
        etag = self.backend.put(bucket, object_name, bytes(data),
                                meta.get("content-type", ""))
        if meta.get("x-amz-tagging"):
            self.put_object_tags(bucket, object_name,
                                 meta["x-amz-tagging"])
        return ObjectInfo(bucket=bucket, name=object_name,
                          size=len(data),
                          etag=etag or hashlib.md5(data).hexdigest(),
                          mod_time=time.time(), metadata=dict(meta))

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1, version_id: str = "",
                   ) -> tuple[bytes, ObjectInfo]:
        body, binfo = self.backend.get(bucket, object_name, offset,
                                       length)
        if binfo:
            # ObjectInfo from the SAME response (one round trip, no
            # head/get race; same as gateway/s3.py).
            info = ObjectInfo(
                bucket=bucket, name=object_name, size=len(body),
                etag=binfo.get("etag", ""),
                mod_time=binfo.get("mtime", 0.0),
                metadata={"content-type": binfo.get("content-type")
                          or "application/octet-stream"})
        else:
            info = self.get_object_info(bucket, object_name)
            info.size = len(body) if (offset or length >= 0) \
                else info.size
        return body, info

    def get_object_info(self, bucket: str, object_name: str,
                        version_id: str = "") -> ObjectInfo:
        try:
            size, mtime, etag, ctype = self.backend.head(bucket,
                                                         object_name)
        except ObjectNotFound:
            if not self.bucket_exists(bucket):
                raise BucketNotFound(bucket)
            raise
        meta = {"content-type": ctype or "application/octet-stream"}
        return ObjectInfo(bucket=bucket, name=object_name, size=size,
                          etag=etag, mod_time=mtime, metadata=meta)

    def delete_object(self, bucket: str, object_name: str,
                      version_id: str = "",
                      versioned: bool = False) -> ObjectInfo:
        self.backend.delete(bucket, object_name)
        self._tags_store(bucket, object_name, None)
        return ObjectInfo(bucket=bucket, name=object_name)

    def object_exists(self, bucket: str, object_name: str) -> bool:
        try:
            self.backend.head(bucket, object_name)
            return True
        except Exception:
            return False

    # -- tags (local store: no upstream analog) ------------------------

    def _tags_path(self, bucket, key):
        digest = hashlib.sha256(f"{bucket}/{key}".encode()).hexdigest()
        return os.path.join(self.meta_dir, "tags", digest + ".json")

    def _tags_store(self, bucket, key, tags: str | None):
        path = self._tags_path(bucket, key)
        if tags is None:
            try:
                os.remove(path)
            except OSError:
                pass
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"tags": tags}, f)

    def put_object_tags(self, bucket: str, object_name: str, tags: str,
                        version_id: str = "") -> None:
        self.get_object_info(bucket, object_name)  # must exist
        self._tags_store(bucket, object_name, tags or None)

    def get_object_tags(self, bucket: str, object_name: str,
                        version_id: str = "") -> str:
        try:
            with open(self._tags_path(bucket, object_name)) as f:
                return json.load(f).get("tags", "")
        except OSError:
            return ""

    def update_object_metadata(self, bucket: str, object_name: str,
                               updates: dict,
                               version_id: str = "") -> None:
        raise GatewayUnsupported("gateway: metadata rewrite")

    # -- listing --------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000,
                     marker: str = "") -> list[ObjectInfo]:
        out = []
        for name, size, mtime, etag in self.backend.list(bucket, prefix):
            if marker and name <= marker:
                continue
            out.append(ObjectInfo(bucket=bucket, name=name, size=size,
                                  etag=etag, mod_time=mtime))
            if len(out) >= max_keys:
                break
        return out

    def list_object_versions(self, bucket: str, prefix: str = "",
                             max_keys: int = 1000,
                             marker: str = "") -> list[ObjectInfo]:
        raise GatewayUnsupported("gateway: versions listing")

    def walk_object_names(self, bucket: str) -> list[str]:
        return [o.name for o in self.list_objects(bucket,
                                                  max_keys=1_000_000)]


class _LocalStageMultipart:
    """Multipart emulation: parts stage locally; complete concatenates
    and issues ONE backend put (ref azure/gcs gateway multipart
    emulation over block lists / compose — same observable contract)."""

    def __init__(self, layer: _BlobGatewayLayer):
        self.layer = layer
        self.dir = os.path.join(layer.meta_dir, "uploads")

    def _base(self, bucket, key, upload_id):
        digest = hashlib.sha256(f"{bucket}/{key}".encode()).hexdigest()
        return os.path.join(self.dir, digest, upload_id)

    def new_multipart_upload(self, bucket, object_name,
                             metadata=None) -> str:
        if not self.layer.bucket_exists(bucket):
            raise BucketNotFound(bucket)
        import uuid
        upload_id = uuid.uuid4().hex
        base = self._base(bucket, object_name, upload_id)
        os.makedirs(base, exist_ok=True)
        with open(os.path.join(base, "meta.json"), "w") as f:
            json.dump({"meta": dict(metadata or {})}, f)
        return upload_id

    def _check(self, bucket, object_name, upload_id) -> str:
        from ..erasure.multipart import UploadNotFound
        base = self._base(bucket, object_name, upload_id)
        if not os.path.isdir(base):
            raise UploadNotFound(upload_id)
        return base

    def get_upload_meta(self, bucket, object_name, upload_id) -> dict:
        base = self._check(bucket, object_name, upload_id)
        with open(os.path.join(base, "meta.json")) as f:
            return json.load(f).get("meta", {})

    def put_object_part(self, bucket, object_name, upload_id,
                        part_number, data, actual_size=None) -> dict:
        base = self._check(bucket, object_name, upload_id)
        if not isinstance(data, (bytes, bytearray)):
            from ..utils.streams import ensure_reader
            r = ensure_reader(data)
            chunks = []
            while chunk := r.read(1 << 20):
                chunks.append(chunk)
            data = b"".join(chunks)
        etag = hashlib.md5(data).hexdigest()
        with open(os.path.join(base, f"part.{part_number}"), "wb") as f:
            f.write(data)
        # Sidecar records size+etag so ListParts/Complete never re-read
        # and re-hash staged bytes.
        with open(os.path.join(base, f"part.{part_number}.info"),
                  "w") as f:
            json.dump({"size": len(data), "etag": etag}, f)
        return {"number": part_number, "size": len(data), "etag": etag}

    def list_parts(self, bucket, object_name, upload_id) -> list[dict]:
        base = self._check(bucket, object_name, upload_id)
        out = []
        for name in sorted(os.listdir(base)):
            if name.startswith("part.") and name.endswith(".info"):
                num = int(name.split(".")[1])
                with open(os.path.join(base, name)) as f:
                    rec = json.load(f)
                out.append({"number": num, "size": rec["size"],
                            "etag": rec["etag"]})
        return sorted(out, key=lambda p: p["number"])

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts) -> ObjectInfo:
        from ..erasure.multipart import (InvalidPart, multipart_etag)
        base = self._check(bucket, object_name, upload_id)
        have = {p["number"]: p for p in self.list_parts(
            bucket, object_name, upload_id)}
        blob = bytearray()
        etags = []
        for num, etag in parts:
            p = have.get(num)
            if p is None or p["etag"] != etag.strip('"'):
                raise InvalidPart(f"part {num}")
            with open(os.path.join(base, f"part.{num}"), "rb") as pf:
                blob += pf.read()
            etags.append(p["etag"])
        meta = self.get_upload_meta(bucket, object_name, upload_id)
        info = self.layer.put_object(bucket, object_name, bytes(blob),
                                     metadata=meta)
        info.etag = multipart_etag(etags)
        self.abort_multipart_upload(bucket, object_name, upload_id)
        return info

    def abort_multipart_upload(self, bucket, object_name,
                               upload_id) -> None:
        import shutil
        base = self._check(bucket, object_name, upload_id)
        shutil.rmtree(base, ignore_errors=True)

    def list_uploads(self, bucket, prefix="") -> list[dict]:
        return []  # local staging: ids are opaque; parity with ref gcs


# ---------------------------------------------------------------------------
# gateway entrypoints (ref Gateway interface, cmd/gateway-interface.go)


class AzureGateway:
    name = "azure"

    def __init__(self, host: str, port: int, account: str, key_b64: str,
                 meta_dir: str, https: bool = False):
        self.backend = AzureBlobBackend(host, port, account, key_b64,
                                        https)
        self.meta_dir = meta_dir

    def new_gateway_layer(self):
        return _BlobGatewayLayer(self.backend, self.meta_dir)


class GCSGateway:
    name = "gcs"

    def __init__(self, host: str, port: int, project: str,
                 meta_dir: str, token: str = "", https: bool = False):
        self.backend = GCSBackend(host, port, project, token, https)
        self.meta_dir = meta_dir

    def new_gateway_layer(self):
        return _BlobGatewayLayer(self.backend, self.meta_dir)


class HDFSGateway:
    name = "hdfs"

    def __init__(self, host: str, port: int, meta_dir: str,
                 root: str = "/minio-tpu", user: str = "minio",
                 https: bool = False):
        self.backend = HDFSBackend(host, port, root, user, https)
        self.meta_dir = meta_dir

    def new_gateway_layer(self):
        return _BlobGatewayLayer(self.backend, self.meta_dir)
