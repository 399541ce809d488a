"""Web console backend: JSON-RPC 2.0 + JWT + raw up/download routes
(ref cmd/web-router.go:63 registerWebRouter, cmd/web-handlers.go 2404
LoC, pkg/rpc; JWT auth cmd/jwt.go).

Routes (wired by the S3 server's ops handler):
    POST /minio-tpu/webrpc                    JSON-RPC 2.0 envelope
    PUT  /minio-tpu/web/upload/<b>/<key>      Bearer-token upload
    GET  /minio-tpu/web/download/<b>/<key>?token=   token download
Methods mirror the reference's web.* set: Login, ListBuckets,
MakeBucket, DeleteBucket, ListObjects, RemoveObject, PresignedGet,
CreateURLToken, ServerInfo.

The port's own copy of ``minio_tpu/s3/webrpc.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse

TOKEN_TTL = 24 * 3600
URL_TOKEN_TTL = 60


class WebError(Exception):
    def __init__(self, message: str, code: int = -32000):
        super().__init__(message)
        self.code = code


# ---------------------------------------------------------------------------
# Minimal HS256 JWT (ref cmd/jwt.go — web tokens are HMAC JWTs over the
# account's secret key)
# ---------------------------------------------------------------------------


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_sign(claims: dict, secret: str) -> str:
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps(claims, sort_keys=True).encode())
    sig = hmac.new(secret.encode(), f"{header}.{payload}".encode(),
                   hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64(sig)}"


def jwt_verify(token: str, secret: str) -> dict:
    try:
        header, payload, sig = token.split(".")
        want = hmac.new(secret.encode(),
                        f"{header}.{payload}".encode(),
                        hashlib.sha256).digest()
        if not hmac.compare_digest(want, _unb64(sig)):
            raise WebError("invalid token signature")
        claims = json.loads(_unb64(payload))
    except WebError:
        raise
    except Exception:  # binascii/json/unicode garbage == bad token
        raise WebError("malformed token")
    if not isinstance(claims, dict) or \
            claims.get("exp", 0) < time.time():
        raise WebError("token expired")
    return claims


class WebHandlers:
    """JSON-RPC dispatcher over the object layer (the reference's
    webAPIHandlers)."""

    def __init__(self, server):
        self.server = server  # S3Server

    # -- auth -----------------------------------------------------------

    def _authenticate_token(self, headers: dict) -> str:
        auth = headers.get("authorization", "")
        if not auth.startswith("Bearer "):
            raise WebError("authentication required", -32001)
        claims = jwt_verify(auth[len("Bearer "):],
                            self.server.secret_key)
        if claims.get("aud") == "url":
            # Download tokens leak via query strings/logs; they must
            # never grant the full session surface.
            raise WebError("authentication required", -32001)
        return claims.get("sub", "")

    # -- JSON-RPC envelope ----------------------------------------------

    def handle_rpc(self, headers: dict, body: bytes) -> bytes:
        try:
            req = json.loads(body)
        except ValueError:
            return self._err(None, "parse error", -32700)
        if not isinstance(req, dict):
            return self._err(None, "invalid request", -32600)
        method = req.get("method", "")
        params = req.get("params") or {}
        rpc_id = req.get("id")
        if not isinstance(params, dict):
            return self._err(rpc_id, "params must be an object",
                             -32602)
        if not method.startswith("web."):
            return self._err(rpc_id, f"unknown method {method}",
                             -32601)
        name = method[len("web."):]
        fn = getattr(self, f"rpc_{name}", None)
        if fn is None:
            return self._err(rpc_id, f"unknown method {method}",
                             -32601)
        try:
            if name != "Login":  # every other method needs the JWT
                params["_user"] = self._authenticate_token(headers)
            result = fn(params)
            return json.dumps({"jsonrpc": "2.0", "id": rpc_id,
                               "result": result}).encode()
        except WebError as e:
            return self._err(rpc_id, str(e), e.code)
        except Exception as e:  # noqa: BLE001
            return self._err(rpc_id, f"{type(e).__name__}: {e}")

    @staticmethod
    def _err(rpc_id, message: str, code: int = -32000) -> bytes:
        return json.dumps({"jsonrpc": "2.0", "id": rpc_id,
                           "error": {"code": code,
                                     "message": message}}).encode()

    # -- methods (ref web-handlers.go) -----------------------------------

    def rpc_Login(self, p: dict) -> dict:
        user = p.get("username", "")
        password = p.get("password", "")
        secret = self.server._lookup_secret(user)
        if secret is None or not hmac.compare_digest(secret, password):
            raise WebError("invalid credentials", -32001)
        token = jwt_sign({"sub": user, "exp": time.time() + TOKEN_TTL},
                         self.server.secret_key)
        return {"token": token, "uiVersion": "minio-tpu"}

    def _layer(self):
        layer = self.server.layer
        if layer is None:
            raise WebError("server initializing", -32002)
        return layer

    def _check(self, user: str, action: str, resource: str) -> None:
        iam = self.server.iam
        if iam is not None and not iam.is_allowed(user, action,
                                                  resource, {}):
            raise WebError("access denied", -32001)

    @staticmethod
    def _synthetic_request(method: str, bucket: str, key: str,
                           headers: dict | None = None,
                           body: bytes = b""):
        """An S3Request as the S3 handler pipeline would have parsed it
        — web routes funnel through the same handlers so every write/
        read/delete policy applies uniformly."""
        from .server import S3Request
        enc = urllib.parse.quote(key, safe="/-_.~")
        return S3Request(method, f"/{bucket}/{enc}", "",
                         headers or {}, body)

    def rpc_ListBuckets(self, p: dict) -> dict:
        self._check(p["_user"], "s3:ListAllMyBuckets", "*")
        return {"buckets": [
            {"name": b["name"],
             "creationDate": time.strftime(
                 "%Y-%m-%dT%H:%M:%SZ", time.gmtime(b["created"]))}
            for b in self._layer().list_buckets()]}

    def rpc_MakeBucket(self, p: dict) -> dict:
        bucket = p.get("bucketName", "")
        self._check(p["_user"], "s3:CreateBucket", bucket)
        from ..erasure.engine import BucketExists
        try:
            self._layer().make_bucket(bucket)
        except BucketExists:
            raise WebError(f"bucket {bucket!r} already exists")
        return {"ok": True}

    def rpc_DeleteBucket(self, p: dict) -> dict:
        bucket = p.get("bucketName", "")
        self._check(p["_user"], "s3:DeleteBucket", bucket)
        from ..erasure.engine import BucketExists, BucketNotFound
        try:
            self._layer().delete_bucket(bucket)
        except BucketNotFound:
            raise WebError(f"no such bucket {bucket!r}")
        except BucketExists:
            raise WebError(f"bucket {bucket!r} not empty")
        return {"ok": True}

    def rpc_ListObjects(self, p: dict) -> dict:
        bucket = p.get("bucketName", "")
        prefix = p.get("prefix", "")
        self._check(p["_user"], "s3:ListBucket", bucket)
        from ..erasure.engine import BucketNotFound
        try:
            infos = self._layer().list_objects(bucket, prefix=prefix,
                                               max_keys=1000)
        except BucketNotFound:
            raise WebError(f"no such bucket {bucket!r}")
        return {"objects": [
            {"name": o.name, "size": o.size, "etag": o.etag,
             "lastModified": time.strftime(
                 "%Y-%m-%dT%H:%M:%SZ", time.gmtime(o.mod_time))}
            for o in infos]}

    def rpc_RemoveObject(self, p: dict) -> dict:
        """Deletes ride the S3 DELETE pipeline (synthetic request):
        versioned buckets get delete markers, object-lock is enforced,
        events/replication/tier cleanup fire — the reference's web
        RemoveObject goes through the same deleteObject core
        (cmd/web-handlers.go)."""
        bucket = p.get("bucketName", "")
        objects = p.get("objects", [])
        from . import errors as s3err
        self._layer()  # raise "initializing" before any permission check
        # All-or-nothing permission check BEFORE any deletion — a
        # mid-list denial must not leave a half-deleted batch.
        for key in objects:
            self._check(p["_user"], "s3:DeleteObject",
                        f"{bucket}/{key}")
        handlers = self.server.handlers
        removed, errors = [], []
        for key in objects:
            sub = self._synthetic_request("DELETE", bucket, key)
            try:
                handlers.delete_object(sub)  # 204 also for missing keys
                removed.append(key)
            except s3err.APIError as e:
                errors.append({"object": key, "error": e.code})
        out = {"removed": removed}
        if errors:
            out["errors"] = errors
        return out

    def rpc_PresignedGet(self, p: dict) -> dict:
        bucket = p.get("bucketName", "")
        key = p.get("objectName", "")
        expiry = min(int(p.get("expiry", 3600)), 7 * 24 * 3600)
        self._check(p["_user"], "s3:GetObject", f"{bucket}/{key}")
        from . import sigv4
        host = p.get("host") or f"127.0.0.1:{self.server_port()}"
        enc = urllib.parse.quote(key, safe="/-_.~")
        url = sigv4.presign_url(
            "GET", host, f"/{bucket}/{enc}", p["_user"],
            self.server._lookup_secret(p["_user"]), expires=expiry)
        return {"url": url}

    def rpc_CreateURLToken(self, p: dict) -> dict:
        token = jwt_sign({"sub": p["_user"],
                          "exp": time.time() + URL_TOKEN_TTL,
                          "aud": "url"}, self.server.secret_key)
        return {"token": token}

    def rpc_ServerInfo(self, p: dict) -> dict:
        from .. import __version__
        return {"version": __version__,
                "uiVersion": "minio-tpu",
                "region": self.server.region}

    def server_port(self) -> int:
        httpd = self.server._httpd
        return httpd.server_address[1] if httpd else 0

    # -- raw upload / download (ref /minio/upload|download routes) -------

    def handle_upload(self, path: str, headers: dict,
                      body: bytes) -> tuple[int, str, bytes]:
        """Web uploads ride the S3 PUT pipeline (synthetic request), so
        bucket quota, object-lock defaults, bucket-default SSE,
        compression, replication stamping and events all apply — same
        funneling the reference's web Upload handler does through
        putObject (cmd/web-handlers.go)."""
        try:
            user = self._authenticate_token(headers)
        except WebError:
            return 401, "application/json", b'{"error":"auth"}'
        rest = path[len("/minio-tpu/web/upload/"):]
        bucket, _, key = rest.partition("/")
        key = urllib.parse.unquote(key)
        if not bucket or not key:
            return 400, "application/json", b'{"error":"bad path"}'
        from . import errors as s3err
        try:
            self._check(user, "s3:PutObject", f"{bucket}/{key}")
        except WebError:
            return 403, "application/json", b'{"error":"denied"}'
        if self.server.handlers is None:
            return 503, "application/json", b'{"error":"initializing"}'
        sub = self._synthetic_request(
            "PUT", bucket, key,
            {"content-type": headers.get("content-type",
                                         "application/octet-stream")},
            body)
        try:
            self.server.handlers.put_object(sub)
        except s3err.APIError as e:
            status = 403 if e.http_status == 403 else 400
            return status, "application/json", json.dumps(
                {"error": e.code}).encode()
        except Exception as e:  # noqa: BLE001
            return 400, "application/json", json.dumps(
                {"error": str(e)}).encode()
        return 200, "application/json", b'{"ok":true}'

    def handle_download(self, path: str, query: str,
                        ) -> tuple[int, str, bytes]:
        """Web downloads reuse the S3 read tail (_read_object_plain) so
        SSE-S3 objects decrypt, compressed objects decompress, and
        tier-transitioned objects read through their tier — instead of
        serving stored ciphertext verbatim."""
        params = dict(urllib.parse.parse_qsl(query))
        try:
            claims = jwt_verify(params.get("token", ""),
                                self.server.secret_key)
            if claims.get("aud") != "url":
                raise WebError("wrong token type")
        except WebError:
            return 401, "application/json", b'{"error":"auth"}'
        rest = path[len("/minio-tpu/web/download/"):]
        bucket, _, key = rest.partition("/")
        key = urllib.parse.unquote(key)
        from . import errors as s3err
        try:
            self._check(claims.get("sub", ""), "s3:GetObject",
                        f"{bucket}/{key}")
        except WebError:
            return 403, "application/json", b'{"error":"denied"}'
        if self.server.handlers is None:
            return 503, "application/json", b'{"error":"initializing"}'
        sub = self._synthetic_request("GET", bucket, key)
        try:
            data, info = self.server.handlers._read_object_plain(sub)
        except s3err.APIError as e:
            # 4xx/5xx pass through honestly (e.g. SSE-C key errors are
            # 400, not "not found").
            status = e.http_status if 400 <= e.http_status < 600 else 404
            return status, "application/json", json.dumps(
                {"error": e.code}).encode()
        except Exception:  # noqa: BLE001
            return 404, "application/json", b'{"error":"not found"}'
        from ..event import event as ev
        self.server.handlers._notify(ev.OBJECT_ACCESSED_GET, bucket,
                                     key, info)
        return 200, info.metadata.get("content-type",
                                      "application/octet-stream"), data
