"""The port's S3 front door (minio_tpu_torch/s3: server.py, asyncserver.py
and everything they reach) held to the JAX package's, over HTTP.

Each package boots its own ``S3Server`` over four CPU drives in a temp
dir: the port's as ``ErasureObjects(..., backend="cpu", device="cpu")``
over ``XLStorage(root, device="cpu")`` (kernels K1, K2 and X2 as their
plain PyTorch versions), the JAX package's as its own tests build it.
Both run with the codec probe ladder off (``MINIO_CODEC_PROBE_ON_BOOT``,
the config-KV knob), on the async front door and on the threaded one.

- One scripted SigV4 request sequence goes to both servers: buckets,
  PUT / GET / HEAD / ranges, CopyObject, conditional headers, listings
  V1 and V2, tagging, DeleteObjects, presigned URLs, aws-chunked bodies,
  multipart, versioning, SSE-C, object lock, POST form upload, S3 Select
  (CSV and Parquet), the error XML, the health, admin and metrics
  endpoints. Each step's status, headers and body must be equal, with
  Date, request ids, Last-Modified and XML times masked, version and
  upload ids mapped to their order of first appearance, and JSON and
  Prometheus bodies compared by key.
- After the sequence the two drive trees hold the same part files and
  xl.meta (SSE-C objects, whose nonces are random, by xl.meta only), and
  each object reads back byte-exact through the other package's server
  over the same drives.

The device seam and the thread census are in test_torch_s3_seam.py.
Payloads come from numpy generators with fixed seeds."""

from __future__ import annotations

import base64
import contextlib
import hashlib
import http.client
import json
import os
import re
import urllib.parse
from xml.sax.saxutils import escape

import numpy as np
import pytest

from minio_tpu.erasure.engine import ErasureObjects as RefEngine
from minio_tpu.s3 import formupload as ref_form
from minio_tpu.s3 import sigv4 as ref_sigv4
from minio_tpu.s3.client import S3Client as RefClient
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.s3select import parquet as ref_pq
from minio_tpu.storage.xl import XLStorage as RefXL
from minio_tpu_torch.erasure.engine import ErasureObjects
from minio_tpu_torch.s3 import formupload as port_form
from minio_tpu_torch.s3 import sigv4 as port_sigv4
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.s3select import parquet as port_pq
from minio_tpu_torch.s3select.select import parse_request, run_select
from minio_tpu_torch.storage.xl import XLStorage

ACCESS, SECRET = "portadmin", "portadmin-secret"
BLOCK = 8 * 1024
DRIVES = 4
DOORS = ("async", "threaded")
FAR_FUTURE = "2099-01-01T00:00:00Z"


def rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


SMALL = rand(20_000, 1)
PART1 = rand(5 * 1024 * 1024, 2)
PART2 = rand(3_001, 3)
CHUNKED = rand(70_000, 4)
VER1, VER2 = rand(9_000, 5), rand(11_000, 6)
SSE_BODY = rand(12_345, 7)
LOCKED = rand(4_000, 8)
FORM_BODY = rand(6_000, 9)
CSV_BODY = "".join(f"{i},{(i * 37) % 101},name{i % 7}\n"
                   for i in range(600)).encode()
SSE_KEY = bytes(range(32))
SSE_HDRS = {
    "x-amz-server-side-encryption-customer-algorithm": "AES256",
    "x-amz-server-side-encryption-customer-key":
        base64.b64encode(SSE_KEY).decode(),
    "x-amz-server-side-encryption-customer-key-md5":
        base64.b64encode(hashlib.md5(SSE_KEY).digest()).decode(),
}


def chip_parquet(mod, n: int = 4096, seed: int = 5) -> bytes:
    """The chip run's Select object (c0, c1 FLOAT; i0, i1 INT32, all
    REQUIRED) at a small row count: its WHERE lowers to X2's program."""
    rng = np.random.default_rng(seed)
    cols = [mod.Column("c0", mod.FLOAT, optional=False),
            mod.Column("c1", mod.FLOAT, optional=False),
            mod.Column("i0", mod.INT32, optional=False),
            mod.Column("i1", mod.INT32, optional=False)]
    data = {"c0": rng.random(n, dtype=np.float32),
            "c1": rng.random(n, dtype=np.float32),
            "i0": rng.integers(0, 100_000, n).astype(np.int32),
            "i1": rng.integers(0, 16, n).astype(np.int32)}
    return mod.write_parquet_columns(cols, data, n)


def select_xml(expr: str, input_xml: str, output_xml: str = "<CSV/>"):
    return ("<SelectObjectContentRequest><Expression>" + escape(expr)
            + "</Expression><ExpressionType>SQL</ExpressionType>"
            "<InputSerialization>" + input_xml + "</InputSerialization>"
            "<OutputSerialization>" + output_xml + "</OutputSerialization>"
            "</SelectObjectContentRequest>").encode()


SELECT_CSV = select_xml(
    "SELECT s._1, s._3 FROM S3Object s WHERE CAST(s._2 AS INT) < 20",
    "<CSV><FileHeaderInfo>NONE</FileHeaderInfo></CSV>")
SELECT_PARQUET = select_xml(
    "SELECT COUNT(*) FROM S3Object WHERE c0 >= 0.25 AND i0 BETWEEN 1000 "
    "AND 50000 AND i1 IN (3, 5, 7)", "<Parquet/>", "<JSON/>")


# ---------------------------------------------------------------------------
# Servers


class Side:
    """One package's server, its client and the client-side helpers of
    the same package."""

    def __init__(self, name, srv, port, client_cls, sigv4, form, root):
        self.name, self.srv, self.port, self.root = name, srv, port, root
        self.c = client_cls("127.0.0.1", port, ACCESS, SECRET)
        self.client_cls, self.sigv4, self.form = client_cls, sigv4, form
        self.state: dict = {}

    def other(self, access, secret):
        return self.client_cls("127.0.0.1", self.port, access, secret)

    def raw(self, method, url, body=b"", headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)
        try:
            conn.request(method, url, body=body, headers=headers or {})
            r = conn.getresponse()
            return Resp(r.status, {k.lower(): v for k, v in r.getheaders()},
                        r.read())
        finally:
            conn.close()


class Resp:
    def __init__(self, status, headers, body):
        self.status, self.headers, self.body = status, headers, body


@contextlib.contextmanager
def serving_env(front_door: str):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        mp.setenv("MINIO_FRONT_DOOR", front_door)
        mp.setenv("MINIO_SELECT_ENGINE", "")
        yield


def boot_port(root) -> Side:
    """The port's server over DRIVES CPU drives under ``root``."""
    disks = [XLStorage(os.path.join(root, f"d{i}"), device="cpu")
             for i in range(DRIVES)]
    srv = S3Server(ErasureObjects(disks, 2, 2, block_size=BLOCK,
                                  backend="cpu", device="cpu"),
                   ACCESS, SECRET)
    return Side("port", srv, srv.start(), S3Client, port_sigv4, port_form,
                root)


def boot_ref(root) -> Side:
    """The JAX package's server over DRIVES drives under ``root``."""
    disks = [RefXL(os.path.join(root, f"d{i}")) for i in range(DRIVES)]
    srv = RefServer(RefEngine(disks, 2, 2, block_size=BLOCK), ACCESS,
                    SECRET)
    return Side("ref", srv, srv.start(), RefClient, ref_sigv4, ref_form,
                root)


# ---------------------------------------------------------------------------
# The request sequence: (name, step(side) -> Resp)


def _key(b, k):
    return f"/{b}/" + urllib.parse.quote(k, safe="/-_.~")


def _etag(side, key):
    return side.c.head_object("seq", key).headers["etag"]


def _put_many(side, bucket, keys, body=b"x"):
    rs = [side.c.put_object(bucket, k, body) for k in keys]
    return Resp(max(r.status for r in rs), {},
                b"".join(r.headers["etag"].encode() for r in rs))


def _multipart_init(side):
    r = side.c.request("POST", "/seq/mp.bin", query="uploads=")
    side.state["upload"] = re.search(rb"<UploadId>([^<]+)</UploadId>",
                                     r.body).group(1).decode()
    return r


def _part(side, n, body):
    q = f"partNumber={n}&uploadId={side.state['upload']}"
    r = side.c.request("PUT", "/seq/mp.bin", query=q, body=body)
    side.state.setdefault("parts", {})[n] = r.headers["etag"]
    return r


def _complete(side):
    parts = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag>"
                    "</Part>" for n, e in sorted(side.state["parts"].items()))
    return side.c.request(
        "POST", "/seq/mp.bin", query=f"uploadId={side.state['upload']}",
        body=f"<CompleteMultipartUpload>{parts}"
             "</CompleteMultipartUpload>".encode())


def _ver_put(side, body, tag):
    r = side.c.put_object("ver", "doc", body)
    side.state[tag] = r.headers.get("x-amz-version-id", "")
    return r


def _presigned(side, tamper=False):
    url = side.sigv4.presign_url("GET", f"127.0.0.1:{side.port}",
                                 "/seq/dir/a.bin", ACCESS, SECRET,
                                 expires=600)
    if tamper:
        url = url[:-4] + "0000"
    return side.raw("GET", url[len(f"http://127.0.0.1:{side.port}"):])


def _chunked_put(side):
    hdrs, wire = side.sigv4.sign_streaming_request(
        "PUT", "/seq/chunked.bin", "",
        {"host": f"127.0.0.1:{side.port}"}, CHUNKED, ACCESS, SECRET,
        chunk_size=16 * 1024)
    return side.raw("PUT", "/seq/chunked.bin", wire, hdrs)


def _post_form(side):
    ctype, body = side.form.build_post_form("seq", "form/up.bin", FORM_BODY,
                                            ACCESS, SECRET)
    return side.raw("POST", "/seq", body, {"Content-Type": ctype,
                                           "Content-Length": str(len(body))})


def _lock_put(side):
    r = side.c.put_object("lockb", "held.bin", LOCKED, headers={
        "x-amz-object-lock-mode": "GOVERNANCE",
        "x-amz-object-lock-retain-until-date": FAR_FUTURE})
    side.state["locked"] = r.headers.get("x-amz-version-id", "")
    return r


def _admin_json(side, route):
    return side.c.request("GET", f"/minio-tpu/admin/v1/{route}")


TAGS = (b"<Tagging><TagSet><Tag><Key>team</Key><Value>storage</Value></Tag>"
        b"<Tag><Key>tier</Key><Value>hot</Value></Tag></TagSet></Tagging>")
DELETE_XML = (b'<?xml version="1.0"?><Delete><Object><Key>k0</Key></Object>'
              b"<Object><Key>k1</Key></Object>"
              b"<Object><Key>missing</Key></Object></Delete>")
VERSIONING_ON = (b"<VersioningConfiguration><Status>Enabled</Status>"
                 b"</VersioningConfiguration>")
LEGAL_HOLD_ON = b"<LegalHold><Status>ON</Status></LegalHold>"
RETENTION = ("<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>"
             f"{FAR_FUTURE}</RetainUntilDate></Retention>").encode()

STEPS = [
    ("make_bucket", lambda s: s.c.make_bucket("seq")),
    ("make_bucket_again", lambda s: s.c.make_bucket("seq")),
    ("invalid_bucket_name", lambda s: s.c.make_bucket("ab")),
    ("list_buckets", lambda s: s.c.request("GET", "/")),
    ("head_bucket", lambda s: s.c.request("HEAD", "/seq")),
    ("put", lambda s: s.c.put_object("seq", "dir/a.bin", SMALL, headers={
        "content-type": "app/x-test", "x-amz-meta-color": "blue"})),
    ("get", lambda s: s.c.get_object("seq", "dir/a.bin")),
    ("head", lambda s: s.c.head_object("seq", "dir/a.bin")),
    ("range_head", lambda s: s.c.get_object(
        "seq", "dir/a.bin", headers={"range": "bytes=0-99"})),
    ("range_suffix", lambda s: s.c.get_object(
        "seq", "dir/a.bin", headers={"range": "bytes=-500"})),
    ("range_across_blocks", lambda s: s.c.get_object(
        "seq", "dir/a.bin", headers={"range": "bytes=8000-16500"})),
    ("range_unsatisfiable", lambda s: s.c.get_object(
        "seq", "dir/a.bin", headers={"range": "bytes=999999-"})),
    ("get_missing_key", lambda s: s.c.get_object("seq", "nope")),
    ("get_missing_bucket", lambda s: s.c.get_object("nobucket", "x")),
    ("bad_content_md5", lambda s: s.c.put_object(
        "seq", "bad", b"payload", headers={"content-md5": base64.b64encode(
            hashlib.md5(b"other").digest()).decode()})),
    ("copy", lambda s: s.c.request("PUT", "/seq/copy.bin", headers={
        "x-amz-copy-source": "/seq/dir/a.bin"})),
    ("get_copy", lambda s: s.c.get_object("seq", "copy.bin")),
    ("if_match", lambda s: s.c.get_object(
        "seq", "dir/a.bin", headers={"if-match": _etag(s, "dir/a.bin")})),
    ("if_match_fails", lambda s: s.c.get_object(
        "seq", "dir/a.bin", headers={"if-match": '"0123"'})),
    ("if_none_match", lambda s: s.c.get_object(
        "seq", "dir/a.bin",
        headers={"if-none-match": _etag(s, "dir/a.bin")})),
    ("if_modified_since", lambda s: s.c.get_object(
        "seq", "dir/a.bin",
        headers={"if-modified-since": "Fri, 01 Jan 2100 00:00:00 GMT"})),
    ("if_unmodified_since", lambda s: s.c.get_object(
        "seq", "dir/a.bin",
        headers={"if-unmodified-since": "Mon, 01 Jan 1990 00:00:00 GMT"})),
    ("put_listing_keys", lambda s: _put_many(
        s, "seq", ["a/1.txt", "a/2.txt", "b/deep/3.txt", "top.txt",
                   "k0", "k1", "k2", "with space.txt", "uni-日本語.bin"])),
    ("list_v1", lambda s: s.c.request("GET", "/seq", query="delimiter=%2F")),
    ("list_v2_delimiter", lambda s: s.c.list_objects_v2(
        "seq", delimiter="/")),
    ("list_v2_prefix", lambda s: s.c.list_objects_v2("seq", prefix="a/")),
    ("list_v2_page", lambda s: s.c.list_objects_v2("seq", max_keys=3)),
    ("list_v2_start_after", lambda s: s.c.request(
        "GET", "/seq", query="list-type=2&start-after=k1")),
    ("get_special_key", lambda s: s.c.get_object("seq", "uni-日本語.bin")),
    ("put_tagging", lambda s: s.c.request(
        "PUT", "/seq/dir/a.bin", query="tagging=", body=TAGS)),
    ("get_tagging", lambda s: s.c.request(
        "GET", "/seq/dir/a.bin", query="tagging=")),
    ("delete_tagging", lambda s: s.c.request(
        "DELETE", "/seq/dir/a.bin", query="tagging=")),
    ("delete_objects", lambda s: s.c.request(
        "POST", "/seq", query="delete=", body=DELETE_XML)),
    ("list_after_delete", lambda s: s.c.list_objects_v2("seq", prefix="k")),
    ("presigned_get", lambda s: _presigned(s)),
    ("presigned_tampered", lambda s: _presigned(s, tamper=True)),
    ("bad_secret", lambda s: s.other(ACCESS, "wrong").request("GET", "/")),
    ("unknown_access_key", lambda s: s.other("nobody", "x").request(
        "GET", "/")),
    ("anonymous", lambda s: s.c.request("GET", "/seq", sign=False)),
    ("aws_chunked_put", _chunked_put),
    ("aws_chunked_get", lambda s: s.c.get_object("seq", "chunked.bin")),
    ("multipart_init", _multipart_init),
    ("multipart_part1", lambda s: _part(s, 1, PART1)),
    ("multipart_part2", lambda s: _part(s, 2, PART2)),
    ("multipart_list_parts", lambda s: s.c.request(
        "GET", "/seq/mp.bin", query=f"uploadId={s.state['upload']}")),
    ("multipart_list_uploads", lambda s: s.c.request(
        "GET", "/seq", query="uploads=")),
    ("multipart_complete", _complete),
    ("multipart_get_tail", lambda s: s.c.get_object(
        "seq", "mp.bin", headers={"range": "bytes=5242000-"})),
    ("multipart_head", lambda s: s.c.head_object("seq", "mp.bin")),
    ("make_versioned_bucket", lambda s: s.c.make_bucket("ver")),
    ("enable_versioning", lambda s: s.c.request(
        "PUT", "/ver", query="versioning=", body=VERSIONING_ON)),
    ("get_versioning", lambda s: s.c.request(
        "GET", "/ver", query="versioning=")),
    ("versioned_put_1", lambda s: _ver_put(s, VER1, "v1")),
    ("versioned_put_2", lambda s: _ver_put(s, VER2, "v2")),
    ("list_versions", lambda s: s.c.request("GET", "/ver", query="versions=")),
    ("get_old_version", lambda s: s.c.get_object(
        "ver", "doc", query=f"versionId={s.state['v1']}")),
    ("delete_marker", lambda s: s.c.delete_object("ver", "doc")),
    ("get_after_delete_marker", lambda s: s.c.get_object("ver", "doc")),
    ("sse_c_put", lambda s: s.c.put_object("seq", "sec.bin", SSE_BODY,
                                           headers=SSE_HDRS)),
    ("sse_c_get", lambda s: s.c.get_object("seq", "sec.bin",
                                           headers=SSE_HDRS)),
    ("sse_c_get_without_key", lambda s: s.c.get_object("seq", "sec.bin")),
    ("sse_c_range", lambda s: s.c.get_object(
        "seq", "sec.bin", headers={**SSE_HDRS, "range": "bytes=100-9000"})),
    ("make_lock_bucket", lambda s: s.c.request(
        "PUT", "/lockb", headers={"x-amz-bucket-object-lock-enabled":
                                  "true"})),
    ("get_object_lock_config", lambda s: s.c.request(
        "GET", "/lockb", query="object-lock=")),
    ("locked_put", _lock_put),
    ("get_retention", lambda s: s.c.get_object(
        "lockb", "held.bin", query="retention=")),
    ("shorten_retention_denied", lambda s: s.c.request(
        "PUT", "/lockb/held.bin", query="retention=", body=RETENTION.replace(
            b"2099", b"2098"))),
    ("put_legal_hold", lambda s: s.c.request(
        "PUT", "/lockb/held.bin", query="legal-hold=", body=LEGAL_HOLD_ON)),
    ("get_legal_hold", lambda s: s.c.request(
        "GET", "/lockb/held.bin", query="legal-hold=")),
    ("delete_locked_version", lambda s: s.c.request(
        "DELETE", "/lockb/held.bin", query=f"versionId={s.state['locked']}")),
    ("post_form_upload", _post_form),
    ("get_form_upload", lambda s: s.c.get_object("seq", "form/up.bin")),
    ("put_csv", lambda s: s.c.put_object("seq", "table.csv", CSV_BODY)),
    ("select_csv", lambda s: s.c.request(
        "POST", "/seq/table.csv", query="select=&select-type=2",
        body=SELECT_CSV)),
    ("put_parquet", lambda s: s.c.put_object(
        "seq", "table.parquet", chip_parquet(port_pq if s.name == "port"
                                             else ref_pq))),
    ("select_parquet", lambda s: s.c.request(
        "POST", "/seq/table.parquet", query="select=&select-type=2",
        body=SELECT_PARQUET)),
    ("select_missing_key", lambda s: s.c.request(
        "POST", "/seq/nope.csv", query="select=&select-type=2",
        body=SELECT_CSV)),
    ("health_live", lambda s: s.raw("GET", "/minio-tpu/health/live")),
    ("health_ready", lambda s: s.raw("GET", "/minio-tpu/health/ready")),
    ("health_cluster", lambda s: s.raw("GET", "/minio-tpu/health/cluster")),
    ("admin_info", lambda s: _admin_json(s, "info")),
    ("admin_kernel_health", lambda s: _admin_json(s, "kernel-health")),
    ("admin_codec_plan", lambda s: _admin_json(s, "codec-plan")),
    ("admin_cache_stats", lambda s: _admin_json(s, "cache-stats")),
    ("admin_drive_health", lambda s: _admin_json(s, "drive-health")),
    ("admin_slowlog", lambda s: _admin_json(s, "slowlog")),
    ("admin_get_config", lambda s: _admin_json(s, "get-config")),
    ("admin_unsigned", lambda s: s.raw("GET", "/minio-tpu/admin/v1/info")),
    ("metrics", lambda s: s.raw("GET", "/minio-tpu/metrics")),
    ("metrics_v2_node", lambda s: s.raw("GET", "/minio-tpu/v2/metrics/node")),
    ("delete_bucket_not_empty", lambda s: s.c.delete_bucket("seq")),
    ("delete_object", lambda s: s.c.delete_object("seq", "copy.bin")),
    ("head_deleted", lambda s: s.c.head_object("seq", "copy.bin")),
]
STEP_NAMES = [n for n, _ in STEPS]

# Objects the sequence leaves behind, with their payloads.
OBJECTS = {("seq", "dir/a.bin"): SMALL, ("seq", "chunked.bin"): CHUNKED,
           ("seq", "mp.bin"): PART1 + PART2, ("seq", "form/up.bin"):
           FORM_BODY, ("seq", "table.csv"): CSV_BODY, ("seq", "top.txt"): b"x",
           ("seq", "uni-日本語.bin"): b"x", ("lockb", "held.bin"): LOCKED}


# ---------------------------------------------------------------------------
# Normalising a response


_MASKED_HEADERS = {"date", "x-amz-request-id", "last-modified", "x-amz-id-2",
                   "keep-alive", "connection"}
_TIME = re.compile(rb"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z")
_IDS = (re.compile(rb"<VersionId>([^<]+)</VersionId>"),
        re.compile(rb"<UploadId>([^<]+)</UploadId>"),
        re.compile(rb"<VersionIdMarker>([^<]+)</VersionIdMarker>"),
        re.compile(rb"<NextVersionIdMarker>([^<]+)</NextVersionIdMarker>"))
_REQ_ID = re.compile(rb"<(RequestId|HostId)>[^<]*</(RequestId|HostId)>")
_HOST = re.compile(rb"127\.0\.0\.1:\d+")
# SSE-C seals each object under a random key: its ETag is random too.
_RANDOM_ETAG = {"sse_c_put", "sse_c_get", "sse_c_range"}
# The codec plan holds the lanes each server measured: the port's CPU
# engine is pinned to the kernel lane, the reference's plans over its
# own; only the report's sections compare.
# The drive report's per-drive op classes depend on which background op
# (MRF, monitor probes) reached a drive first; the slowlog holds what ran
# over its threshold on this machine.
_SECTIONS_ONLY = {"admin_codec_plan", "admin_drive_health", "admin_slowlog"}
# The node registry holds every family the package's process has touched
# so far (other tests included): the families both hold must agree in
# type, and both must hold the request families.
_REGISTRY_STEPS = {"metrics_v2_node"}
REQUEST_FAMILIES = {b"minio_tpu_v2_api_requests_total",
                    b"minio_tpu_v2_api_request_duration_ms",
                    b"minio_tpu_v2_api_rx_bytes_total"}


class Masker:
    """Maps each server's version and upload ids to their order of first
    appearance, so the two sequences compare."""

    def __init__(self):
        self.ids: dict[bytes, bytes] = {}

    def _learn(self, ident: bytes) -> None:
        if ident and ident != b"null" and ident not in self.ids:
            self.ids[ident] = b"<id%d>" % len(self.ids)

    def __call__(self, step: str, r) -> dict:
        body = r.body
        for pat in _IDS:
            for m in pat.finditer(body):
                self._learn(m.group(1))
        for h in ("x-amz-version-id", "x-amz-delete-marker-version-id"):
            if h in r.headers:
                self._learn(r.headers[h].encode())
        ctype = r.headers.get("content-type", "")
        if ctype.startswith("application/json"):
            doc = json.loads(body)
            body_view = (sorted(doc) if step in _SECTIONS_ONLY
                         else json_shape(doc))
        elif ctype.startswith("text/plain") and b"# TYPE" in body:
            body_view = dict(re.findall(rb"^# TYPE (\S+) (\S+)", body,
                                        re.M))
        else:
            for ident, token in sorted(self.ids.items(),
                                       key=lambda kv: -len(kv[0])):
                body = body.replace(ident, token)
                body = body.replace(urllib.parse.quote(ident).encode(),
                                    token)
            body = _REQ_ID.sub(rb"<\1>-</\2>", _TIME.sub(b"<time>", body))
            body = _HOST.sub(b"<host>", body)
            body_view = body
        headers = {}
        for k, v in r.headers.items():
            if k in _MASKED_HEADERS or (k == "etag" and step in _RANDOM_ETAG):
                continue
            if ctype.startswith(("application/json", "text/plain")) \
                    and k == "content-length":
                continue
            v = v.encode()
            for ident, token in self.ids.items():
                v = v.replace(ident, token)
            headers[k] = v
        return {"status": r.status, "headers": headers, "body": body_view}


def json_shape(doc):
    """A JSON document by key: dict keys recursively, list lengths and
    value types (numbers, times and counters differ between runs). The
    port's CPU kernel lane is named ``torch-cpu`` where the reference's is
    ``xla-cpu`` (obs/kernprof.py)."""
    if isinstance(doc, dict):
        return {("xla-cpu" if k == "torch-cpu" else k): json_shape(v)
                for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return ["list", len(doc)] + [json_shape(v) for v in doc[:1]]
    if isinstance(doc, bool):
        return "bool"
    if isinstance(doc, (int, float)):
        return "number"
    return type(doc).__name__


def run_sequence(side) -> dict:
    mask = Masker()
    out = {}
    for name, step in STEPS:
        out[name] = mask(name, step(side))
    return out


# ---------------------------------------------------------------------------
# Fixtures


@pytest.fixture(scope="module", params=DOORS)
def pair(request, tmp_path_factory):
    """Both packages' servers on one front door, after the sequence:
    (port Side, ref Side, port results, ref results, front door)."""
    with serving_env(request.param):
        root = tmp_path_factory.mktemp(f"s3pair-{request.param}")
        ref = boot_ref(str(root / "ref"))
        port = boot_port(str(root / "port"))
        try:
            got, want = run_sequence(port), run_sequence(ref)
            yield port, ref, got, want, request.param
        finally:
            port.srv.stop()
            ref.srv.stop()


# ---------------------------------------------------------------------------
# The sequence, step by step


@pytest.mark.parametrize("step", STEP_NAMES)
def test_step_matches_reference(pair, step):
    _, _, got, want, _ = pair
    if step in _REGISTRY_STEPS:
        g, w = dict(got[step]), dict(want[step])
        gb, wb = g.pop("body"), w.pop("body")
        assert g == w
        assert REQUEST_FAMILIES <= set(gb) & set(wb)
        assert {k: gb[k] for k in set(gb) & set(wb)} == \
            {k: wb[k] for k in set(gb) & set(wb)}
        return
    assert got[step] == want[step]


def test_sequence_reads_back_its_payloads(pair):
    """The bodies the sequence got are the payloads it sent, so the
    comparison above holds two right answers, not two equal wrong ones."""
    _, _, got, _, _ = pair
    assert got["get"]["body"] == SMALL
    assert got["range_across_blocks"]["body"] == SMALL[8000:16501]
    assert got["aws_chunked_get"]["body"] == CHUNKED
    assert got["multipart_get_tail"]["body"] == (PART1 + PART2)[5242000:]
    assert got["get_old_version"]["body"] == VER1
    assert got["sse_c_get"]["body"] == SSE_BODY
    assert got["sse_c_range"]["body"] == SSE_BODY[100:9001]
    assert got["get_form_upload"]["body"] == FORM_BODY
    assert got["get_copy"]["body"] == SMALL
    for key, status in (("get", 200), ("range_head", 206),
                        ("if_none_match", 304), ("if_match_fails", 412),
                        ("presigned_get", 200), ("presigned_tampered", 403),
                        ("bad_secret", 403), ("sse_c_get_without_key", 400),
                        ("delete_locked_version", 403),
                        ("post_form_upload", 204), ("select_csv", 200),
                        ("select_parquet", 200)):
        assert got[key]["status"] == status, key


@pytest.mark.parametrize("step", ["select_csv", "select_parquet"])
def test_select_over_http_equals_run_select(pair, step):
    """Select over HTTP returns what ``run_select(..., device="cpu")``
    returns on the same object: the server adds nothing of its own."""
    _, _, got, _, _ = pair
    xml, data = ((SELECT_CSV, CSV_BODY) if step == "select_csv"
                 else (SELECT_PARQUET, chip_parquet(port_pq)))
    assert got[step]["body"] == run_select(parse_request(xml), data,
                                           device="cpu")


# ---------------------------------------------------------------------------
# Drive trees, and reads across the packages


def tree(root: str, bucket: str, key: str, parts: bool) -> list:
    """Per drive: xl.meta as parsed versions (less the per-write ids and
    times) and, with ``parts``, every version's part files."""
    out = []
    for i in range(DRIVES):
        odir = os.path.join(root, f"d{i}", bucket, key)
        doc = json.loads(open(os.path.join(odir, "xl.meta"), "rb").read())
        vers = []
        for v in doc["versions"]:
            dd = v.get("data_dir") or v.get("dataDir") or ""
            files = {}
            if parts and dd and os.path.isdir(os.path.join(odir, dd)):
                for f in sorted(os.listdir(os.path.join(odir, dd))):
                    files[f] = open(os.path.join(odir, dd, f), "rb").read()
            meta = {k: v for k, v in v.items()
                    if k not in ("version_id", "versionId", "data_dir",
                                 "dataDir", "mod_time", "modTime")}
            if not parts:  # sealed: its key, nonce and ETag are random
                for k in list(meta.get("meta", {})):
                    if k.startswith("x-internal-sse-") or k == "etag":
                        meta["meta"][k] = "<sealed>"
                for part in meta.get("parts", []):
                    part["etag"] = "<sealed>"
            vers.append((json.dumps(meta, sort_keys=True, default=str),
                         files))
        out.append(vers)
    return out


TREE_OBJECTS = sorted(OBJECTS) + [("seq", "sec.bin"), ("ver", "doc")]


@pytest.mark.parametrize("bucket,key", TREE_OBJECTS,
                         ids=[f"{b}/{k}" for b, k in TREE_OBJECTS])
def test_drive_trees_match_reference(pair, bucket, key):
    port, ref, _, _, _ = pair
    parts = key != "sec.bin"  # SSE-C: a random nonce per object
    assert tree(port.root, bucket, key, parts) == \
        tree(ref.root, bucket, key, parts)


@pytest.fixture(scope="module")
def crossed(pair):
    """After the sequence: a port server over the JAX package's drives and
    a JAX package server over the port's, each on the same front door."""
    port, ref, _, _, door = pair
    port.srv.stop()
    ref.srv.stop()
    with serving_env(door):
        over_ref = boot_port(ref.root)
        over_port = boot_ref(port.root)
        try:
            yield over_ref, over_port
        finally:
            over_ref.srv.stop()
            over_port.srv.stop()


@pytest.mark.parametrize("bucket,key", sorted(OBJECTS),
                         ids=[f"{b}/{k}" for b, k in sorted(OBJECTS)])
def test_objects_read_across_packages(crossed, bucket, key):
    for side in crossed:
        r = side.c.get_object(bucket, key)
        assert r.status == 200, (side.name, key)
        assert r.body == OBJECTS[bucket, key], (side.name, key)


def test_encrypted_and_versioned_read_across_packages(crossed):
    for side in crossed:
        assert side.c.get_object("seq", "sec.bin",
                                 headers=SSE_HDRS).body == SSE_BODY
        r = side.c.request("GET", "/ver", query="versions=")
        assert r.body.count(b"<Version>") == 2
        assert r.body.count(b"<DeleteMarker>") == 1
        assert side.c.get_object("ver", "doc").status == 404
