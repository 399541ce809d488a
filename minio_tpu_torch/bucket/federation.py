"""Bucket federation over etcd DNS (ref cmd/globals.go
globalDNSConfig + pkg/dns/etcd_dns.go: every cluster registers its
buckets as skydns-style SRV records; any cluster can then resolve a
foreign bucket to its owning endpoints).

The etcd client speaks the v3 JSON gRPC-gateway (/v3/kv/put, /v3/kv/
range, /v3/kv/deleterange; keys/values base64) — no etcd library
exists in this image, and the JSON gateway is etcd's stable public
surface.

Server integration (s3/server.py): a request for a bucket that is NOT
local but resolves in DNS answers 307 to the owning cluster — the
federation contract a dumb client can follow (the reference fronts
this with CoreDNS; the redirect covers clients addressing any
federated node directly).

The port's own copy of ``minio_tpu/bucket/federation.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.parse


class EtcdError(Exception):
    pass


class EtcdClient:
    """Minimal etcd v3 JSON-gateway client."""

    def __init__(self, endpoint: str, timeout: float = 5.0):
        from ..utils.httpjson import parse_endpoint
        self.host, self.port, self.https = parse_endpoint(endpoint, 2379)
        self.timeout = timeout

    def _call(self, path: str, doc: dict) -> dict:
        from ..utils.httpjson import json_post
        return json_post(self.host, self.port, self.https, path, doc,
                         self.timeout, EtcdError)

    @staticmethod
    def _b64(s: bytes) -> str:
        return base64.b64encode(s).decode()

    def put(self, key: str, value: bytes) -> None:
        self._call("/v3/kv/put", {"key": self._b64(key.encode()),
                                  "value": self._b64(value)})

    def get_prefix(self, prefix: str) -> dict[str, bytes]:
        end = prefix[:-1] + chr(ord(prefix[-1]) + 1)
        doc = self._call("/v3/kv/range", {
            "key": self._b64(prefix.encode()),
            "range_end": self._b64(end.encode())})
        out = {}
        for kv in doc.get("kvs", []):
            out[base64.b64decode(kv["key"]).decode()] = \
                base64.b64decode(kv.get("value", ""))
        return out

    def delete_prefix(self, prefix: str) -> None:
        end = prefix[:-1] + chr(ord(prefix[-1]) + 1)
        self._call("/v3/kv/deleterange", {
            "key": self._b64(prefix.encode()),
            "range_end": self._b64(end.encode())})


class BucketDNS:
    """skydns-layout bucket records (ref pkg/dns/etcd_dns.go:
    /skydns/<reversed domain>/<bucket>/<node> -> {host, port})."""

    # Request-path lookups cache briefly so a slow/offline etcd can't
    # pin handler threads on every NoSuchBucket probe.
    LOOKUP_TTL = 3.0

    def __init__(self, etcd: EtcdClient, domain: str = "minio-tpu.local"):
        self.etcd = etcd
        self.domain = domain
        rev = "/".join(reversed(domain.split(".")))
        self._base = f"/skydns/{rev}"
        self._cache: dict[str, tuple[float, list]] = {}

    def _bucket_prefix(self, bucket: str) -> str:
        return f"{self._base}/{bucket}/"

    def register(self, bucket: str, host: str, port: int) -> None:
        rec = json.dumps({"host": host, "port": port,
                          "ttl": 30, "creation": time.time()}).encode()
        self.etcd.put(self._bucket_prefix(bucket) + f"{host}:{port}",
                      rec)
        self._cache.pop(bucket, None)

    def unregister(self, bucket: str) -> None:
        self.etcd.delete_prefix(self._bucket_prefix(bucket))
        self._cache.pop(bucket, None)

    def lookup(self, bucket: str,
               cached: bool = True) -> list[tuple[str, int]]:
        if cached:
            hit = self._cache.get(bucket)
            if hit and time.time() - hit[0] < self.LOOKUP_TTL:
                return hit[1]
        out = []
        try:
            records = sorted(self.etcd.get_prefix(
                self._bucket_prefix(bucket)).items())
        except EtcdError:
            if cached and bucket in self._cache:
                return self._cache[bucket][1]  # stale beats stalled
            raise
        for _k, raw in records:
            try:
                doc = json.loads(raw)
                out.append((doc["host"], int(doc["port"])))
            except (ValueError, KeyError):
                continue
        self._cache[bucket] = (time.time(), out)
        return out

    def list_buckets(self) -> dict[str, list[tuple[str, int]]]:
        out: dict[str, list[tuple[str, int]]] = {}
        for key, raw in sorted(self.etcd.get_prefix(
                self._base + "/").items()):
            rest = key[len(self._base) + 1:]
            bucket = rest.split("/", 1)[0]
            try:
                doc = json.loads(raw)
                out.setdefault(bucket, []).append(
                    (doc["host"], int(doc["port"])))
            except (ValueError, KeyError):
                continue
        return out

    @classmethod
    def from_env(cls, env=None) -> "BucketDNS | None":
        import os
        env = env if env is not None else os.environ
        ep = env.get("MINIO_ETCD_ENDPOINT", "")
        if not ep:
            return None
        return cls(EtcdClient(ep),
                   env.get("MINIO_DOMAIN", "minio-tpu.local"))
