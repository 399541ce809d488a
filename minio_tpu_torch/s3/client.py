"""Minimal SigV4 S3 client over stdlib http.client — used by the test
suite (the reference drives its API tests with signed requests from
cmd/test-utils_test.go) and by tools; intentionally independent from the
server-side request path except for sigv4.sign_request.

The port's own copy of ``minio_tpu/s3/client.py``, with no change in
behaviour."""

from __future__ import annotations

import http.client
import urllib.parse
from dataclasses import dataclass

from . import sigv4


@dataclass
class S3ClientResponse:
    status: int
    headers: dict[str, str]
    body: bytes


class S3Client:
    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 tls: "object | None" = None):
        """tls: an ssl.SSLContext (see utils.certs.client_context) to
        speak HTTPS; None = plaintext."""
        self.host = host
        self.port = port
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.tls = tls

    def request(self, method: str, path: str, query: str = "",
                body: bytes = b"",
                headers: dict[str, str] | None = None,
                sign: bool = True) -> S3ClientResponse:
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        hdrs["host"] = f"{self.host}:{self.port}"
        if sign:
            hdrs = sigv4.sign_request(method, path, query, hdrs, body,
                                      self.access_key, self.secret_key,
                                      self.region)
        if self.tls is not None:
            conn = http.client.HTTPSConnection(
                self.host, self.port, timeout=60, context=self.tls)
        else:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=60)
        try:
            url = path + (f"?{query}" if query else "")
            conn.request(method, url, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            return S3ClientResponse(resp.status,
                                    {k.lower(): v for k, v in
                                     resp.getheaders()}, data)
        finally:
            conn.close()

    # --- convenience ops ---

    def make_bucket(self, bucket: str) -> S3ClientResponse:
        return self.request("PUT", f"/{bucket}")

    def delete_bucket(self, bucket: str) -> S3ClientResponse:
        return self.request("DELETE", f"/{bucket}")

    def put_object(self, bucket: str, key: str, data: bytes,
                   headers: dict[str, str] | None = None,
                   ) -> S3ClientResponse:
        return self.request("PUT", self._key_path(bucket, key), body=data,
                            headers=headers)

    def get_object(self, bucket: str, key: str,
                   headers: dict[str, str] | None = None,
                   query: str = "") -> S3ClientResponse:
        return self.request("GET", self._key_path(bucket, key),
                            query=query, headers=headers)

    def head_object(self, bucket: str, key: str) -> S3ClientResponse:
        return self.request("HEAD", self._key_path(bucket, key))

    def delete_object(self, bucket: str, key: str) -> S3ClientResponse:
        return self.request("DELETE", self._key_path(bucket, key))

    def list_objects_v2(self, bucket: str, prefix: str = "",
                        delimiter: str = "",
                        max_keys: int = 1000) -> S3ClientResponse:
        q = {"list-type": "2", "max-keys": str(max_keys)}
        if prefix:
            q["prefix"] = prefix
        if delimiter:
            q["delimiter"] = delimiter
        return self.request("GET", f"/{bucket}",
                            query=urllib.parse.urlencode(q))

    @staticmethod
    def _key_path(bucket: str, key: str) -> str:
        enc = urllib.parse.quote(key, safe="/-_.~")
        return f"/{bucket}/{enc}"
