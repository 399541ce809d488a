"""Tiny JSON-over-HTTP POST helper shared by the etcd and KES clients
(one place for connect/post/raise-on-error semantics).

The port's own copy of ``minio_tpu/utils/httpjson.py``, with no change in
behaviour."""

from __future__ import annotations

import http.client
import json
import urllib.parse


def parse_endpoint(endpoint: str, default_port: int,
                   ) -> tuple[str, int, bool]:
    u = urllib.parse.urlsplit(
        endpoint if "//" in endpoint else f"http://{endpoint}")
    return (u.hostname or "127.0.0.1", u.port or default_port,
            u.scheme == "https")


def json_post(host: str, port: int, https: bool, path: str, doc: dict,
              timeout: float, error_cls: type[Exception],
              headers: dict | None = None, tls=None) -> dict:
    if https:
        conn = http.client.HTTPSConnection(host, port, timeout=timeout,
                                           context=tls)
    else:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(doc).encode()
        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        conn.request("POST", path, body=body, headers=h)
        r = conn.getresponse()
        data = r.read()
        if r.status != 200:
            raise error_cls(f"{path}: {r.status} {data[:200]!r}")
        return json.loads(data or b"{}")
    except (OSError, http.client.HTTPException) as e:
        raise error_cls(f"{host}:{port} unreachable: {e}")
    finally:
        conn.close()
