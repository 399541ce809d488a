"""AWS Signature Version 4 — verification and client-side signing
(ref cmd/signature-v4.go, cmd/signature-v4-parser.go).

Covers header auth (Authorization: AWS4-HMAC-SHA256 ...) and presigned
query auth (X-Amz-Signature=...). Streaming aws-chunked signatures (ref
cmd/streaming-signature-v4.go) layer on top when the handlers need them.

The port's own copy of ``minio_tpu/s3/sigv4.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse
from dataclasses import dataclass

from .errors import (ERR_AUTHORIZATION_HEADER_MALFORMED,
                     ERR_EXPIRED_PRESIGN, ERR_INVALID_ACCESS_KEY_ID,
                     ERR_MISSING_AUTH, ERR_REQUEST_TIME_TOO_SKEWED,
                     ERR_SIGNATURE_DOES_NOT_MATCH, APIError)

SIGN_V4_ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
MAX_SKEW_SECONDS = 15 * 60


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query: str) -> str:
    """Sorted, re-encoded query string; X-Amz-Signature excluded."""
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    enc = sorted((_uri_encode(k), _uri_encode(v)) for k, v in pairs
                 if k != "X-Amz-Signature")
    return "&".join(f"{k}={v}" for k, v in enc)


def _canonical_request(method: str, raw_path: str, query: str,
                       headers: dict[str, str], signed_headers: list[str],
                       payload_hash: str) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([
        method.upper(), raw_path, canonical_query(query), canon_headers,
        ";".join(signed_headers), payload_hash,
    ])


def _signing_key(secret: str, date: str, region: str, service: str,
                 ) -> bytes:
    k = hmac.new(("AWS4" + secret).encode(), date.encode(),
                 hashlib.sha256).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _string_to_sign(amz_date: str, scope: str, canonical: str) -> str:
    return "\n".join([
        SIGN_V4_ALGORITHM, amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])


@dataclass
class Credential:
    access_key: str
    date: str
    region: str
    service: str

    @property
    def scope(self) -> str:
        return f"{self.date}/{self.region}/{self.service}/aws4_request"


def _parse_credential(cred: str) -> Credential:
    parts = cred.split("/")
    if len(parts) != 5 or parts[4] != "aws4_request":
        raise ERR_AUTHORIZATION_HEADER_MALFORMED
    return Credential(parts[0], parts[1], parts[2], parts[3])


def _check_skew(amz_date: str, now: float) -> None:
    try:
        t = time.mktime(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        t -= time.timezone
    except ValueError:
        raise ERR_AUTHORIZATION_HEADER_MALFORMED
    if abs(now - t) > MAX_SKEW_SECONDS:
        raise ERR_REQUEST_TIME_TOO_SKEWED


def verify_header_auth(method: str, raw_path: str, query: str,
                       headers: dict[str, str], body_sha256: str,
                       lookup_secret, now: float | None = None) -> str:
    """Verify an Authorization-header SigV4 request; returns the access
    key. `headers` keys must be lowercase. `lookup_secret(access_key) ->
    secret | None`. Raises APIError subtypes on failure."""
    auth = headers.get("authorization", "")
    if not auth.startswith(SIGN_V4_ALGORITHM):
        raise ERR_MISSING_AUTH
    fields = {}
    for item in auth[len(SIGN_V4_ALGORITHM):].split(","):
        item = item.strip()
        if "=" not in item:
            raise ERR_AUTHORIZATION_HEADER_MALFORMED
        k, v = item.split("=", 1)
        fields[k.strip()] = v.strip()
    try:
        cred = _parse_credential(fields["Credential"])
        signed_headers = fields["SignedHeaders"].split(";")
        signature = fields["Signature"]
    except KeyError:
        raise ERR_AUTHORIZATION_HEADER_MALFORMED

    secret = lookup_secret(cred.access_key)
    if secret is None:
        raise ERR_INVALID_ACCESS_KEY_ID

    amz_date = headers.get("x-amz-date", "")
    if not amz_date:
        raise ERR_MISSING_AUTH
    _check_skew(amz_date, now if now is not None else time.time())

    payload_hash = headers.get("x-amz-content-sha256", body_sha256)
    canonical = _canonical_request(method, raw_path, query, headers,
                                   signed_headers, payload_hash)
    sts = _string_to_sign(amz_date, cred.scope, canonical)
    want = hmac.new(
        _signing_key(secret, cred.date, cred.region, cred.service),
        sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, signature):
        raise ERR_SIGNATURE_DOES_NOT_MATCH
    return cred.access_key


def verify_presigned(method: str, raw_path: str, query: str,
                     headers: dict[str, str], lookup_secret,
                     now: float | None = None) -> str:
    """Verify a presigned-URL request; returns the access key."""
    q = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
    if q.get("X-Amz-Algorithm") != SIGN_V4_ALGORITHM:
        raise ERR_MISSING_AUTH
    try:
        cred = _parse_credential(q["X-Amz-Credential"])
        amz_date = q["X-Amz-Date"]
        expires = int(q["X-Amz-Expires"])
        signed_headers = q["X-Amz-SignedHeaders"].split(";")
        signature = q["X-Amz-Signature"]
    except (KeyError, ValueError):
        raise ERR_AUTHORIZATION_HEADER_MALFORMED

    secret = lookup_secret(cred.access_key)
    if secret is None:
        raise ERR_INVALID_ACCESS_KEY_ID

    now_t = now if now is not None else time.time()
    try:
        t0 = time.mktime(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        t0 -= time.timezone
    except ValueError:
        raise ERR_AUTHORIZATION_HEADER_MALFORMED
    if now_t > t0 + expires:
        raise ERR_EXPIRED_PRESIGN

    canonical = _canonical_request(method, raw_path, query, headers,
                                   signed_headers, UNSIGNED_PAYLOAD)
    sts = _string_to_sign(amz_date, cred.scope, canonical)
    want = hmac.new(
        _signing_key(secret, cred.date, cred.region, cred.service),
        sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, signature):
        raise ERR_SIGNATURE_DOES_NOT_MATCH
    return cred.access_key


# --- client side (tests, internal RPC, presign generation) -------------------


def sign_request(method: str, path: str, query: str, headers: dict[str, str],
                 body: bytes, access_key: str, secret_key: str,
                 region: str = "us-east-1",
                 amz_time: float | None = None) -> dict[str, str]:
    """Produce headers (lowercase keys) with SigV4 Authorization added.
    `headers` must already include 'host'."""
    t = time.gmtime(amz_time if amz_time is not None else time.time())
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = time.strftime("%Y%m%d", t)
    payload_hash = hashlib.sha256(body).hexdigest()
    out = {k.lower(): v for k, v in headers.items()}
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    signed = sorted(out)
    cred = Credential(access_key, date, region, "s3")
    canonical = _canonical_request(method, path, query, out, signed,
                                   payload_hash)
    sts = _string_to_sign(amz_date, cred.scope, canonical)
    sig = hmac.new(_signing_key(secret_key, date, region, "s3"),
                   sts.encode(), hashlib.sha256).hexdigest()
    out["authorization"] = (
        f"{SIGN_V4_ALGORITHM} Credential={cred.access_key}/{cred.scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return out


def presign_url(method: str, host: str, path: str, access_key: str,
                secret_key: str, expires: int = 3600,
                region: str = "us-east-1",
                amz_time: float | None = None,
                extra_query: dict[str, str] | None = None) -> str:
    """Generate a presigned URL (ref web-handlers PresignedGet)."""
    t = time.gmtime(amz_time if amz_time is not None else time.time())
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = time.strftime("%Y%m%d", t)
    cred = Credential(access_key, date, region, "s3")
    q = {
        "X-Amz-Algorithm": SIGN_V4_ALGORITHM,
        "X-Amz-Credential": f"{access_key}/{cred.scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    }
    q.update(extra_query or {})
    query = urllib.parse.urlencode(q)
    canonical = _canonical_request(method, path, query, {"host": host},
                                   ["host"], UNSIGNED_PAYLOAD)
    sts = _string_to_sign(amz_date, cred.scope, canonical)
    sig = hmac.new(_signing_key(secret_key, date, region, "s3"),
                   sts.encode(), hashlib.sha256).hexdigest()
    return (f"http://{host}{path}?{query}&X-Amz-Signature={sig}")


# --- streaming aws-chunked (ref cmd/streaming-signature-v4.go) ---------------

STREAMING_ALGORITHM = "AWS4-HMAC-SHA256-PAYLOAD"
_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def parse_auth_fields(headers: dict[str, str]) -> tuple[Credential,
                                                        list[str], str]:
    """(credential, signed_headers, signature) from an Authorization
    header (ref parseSignV4, cmd/signature-v4-parser.go)."""
    auth = headers.get("authorization", "")
    if not auth.startswith(SIGN_V4_ALGORITHM):
        raise ERR_MISSING_AUTH
    fields = {}
    for item in auth[len(SIGN_V4_ALGORITHM):].split(","):
        item = item.strip()
        if "=" not in item:
            raise ERR_AUTHORIZATION_HEADER_MALFORMED
        k, v = item.split("=", 1)
        fields[k.strip()] = v.strip()
    try:
        return (_parse_credential(fields["Credential"]),
                fields["SignedHeaders"].split(";"), fields["Signature"])
    except KeyError:
        raise ERR_AUTHORIZATION_HEADER_MALFORMED


def _chunk_string_to_sign(amz_date: str, scope: str, prev_sig: str,
                          chunk: bytes) -> str:
    return "\n".join([
        STREAMING_ALGORITHM, amz_date, scope, prev_sig, _EMPTY_SHA256,
        hashlib.sha256(chunk).hexdigest(),
    ])


def decode_streaming(body: bytes, secret: str, cred: Credential,
                     amz_date: str, seed_signature: str) -> bytes:
    """Decode + verify an aws-chunked body: each chunk's signature
    chains off the previous one, seeded by the header signature (ref
    newSignV4ChunkedReader, cmd/streaming-signature-v4.go:156)."""
    key = _signing_key(secret, cred.date, cred.region, cred.service)
    out = bytearray()
    prev = seed_signature
    pos = 0
    while True:
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise ERR_SIGNATURE_DOES_NOT_MATCH
        header = body[pos:nl].decode("ascii", "replace")
        size_s, _, ext = header.partition(";")
        try:
            size = int(size_s, 16)
        except ValueError:
            raise ERR_SIGNATURE_DOES_NOT_MATCH
        sig = ""
        for kv in ext.split(";"):
            k, _, v = kv.partition("=")
            if k.strip() == "chunk-signature":
                sig = v.strip()
        data = body[nl + 2:nl + 2 + size]
        if len(data) != size:
            raise ERR_SIGNATURE_DOES_NOT_MATCH
        want = hmac.new(
            key, _chunk_string_to_sign(amz_date, cred.scope, prev,
                                       data).encode(),
            hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise ERR_SIGNATURE_DOES_NOT_MATCH
        prev = want
        pos = nl + 2 + size
        if body[pos:pos + 2] == b"\r\n":
            pos += 2
        if size == 0:
            break
        out += data
    return bytes(out)


class ChunkedDecoder:
    """Streaming aws-chunked decoder: pulls frames from an inner reader
    one chunk at a time, verifying the chunk-signature chain — the
    incremental twin of decode_streaming for bodies too large to buffer
    (ref newSignV4ChunkedReader, cmd/streaming-signature-v4.go:156).
    read(n) returns decoded payload; raises on any bad signature."""

    def __init__(self, inner, secret: str, cred: Credential,
                 amz_date: str, seed_signature: str):
        self._inner = inner
        self._key = _signing_key(secret, cred.date, cred.region,
                                 cred.service)
        self._scope = cred.scope
        self._amz_date = amz_date
        self._prev = seed_signature
        self._buf = bytearray()  # decoded, not yet returned
        self._raw = bytearray()  # undecoded wire bytes
        self._done = False

    def _fill_raw(self, n: int) -> None:
        while len(self._raw) < n:
            chunk = self._inner.read(64 * 1024)
            if not chunk:
                raise ERR_SIGNATURE_DOES_NOT_MATCH
            self._raw += chunk

    # Chunk headers are tiny ("<hex>;chunk-signature=<64 hex>"); cap the
    # scan so a malformed body can't make us buffer it whole.
    _MAX_HEADER = 4096

    def _read_frame(self) -> None:
        # [hex-size];chunk-signature=<sig>\r\n<data>\r\n
        scanned = 0  # resume the CRLF search where the last one ended
        while True:
            nl = self._raw.find(b"\r\n", max(0, scanned - 1))
            if nl >= 0:
                break
            scanned = len(self._raw)
            if scanned > self._MAX_HEADER:
                raise ERR_SIGNATURE_DOES_NOT_MATCH
            chunk = self._inner.read(4096)
            if not chunk:
                raise ERR_SIGNATURE_DOES_NOT_MATCH
            self._raw += chunk
        if nl > self._MAX_HEADER:
            raise ERR_SIGNATURE_DOES_NOT_MATCH
        header = bytes(self._raw[:nl]).decode("ascii", "replace")
        del self._raw[:nl + 2]
        size_s, _, ext = header.partition(";")
        try:
            size = int(size_s, 16)
        except ValueError:
            raise ERR_SIGNATURE_DOES_NOT_MATCH
        sig = ""
        for kv in ext.split(";"):
            k, _, v = kv.partition("=")
            if k.strip() == "chunk-signature":
                sig = v.strip()
        if size > 0:
            self._fill_raw(size + 2)
            data = bytes(self._raw[:size])
            if bytes(self._raw[size:size + 2]) != b"\r\n":
                raise ERR_SIGNATURE_DOES_NOT_MATCH
            del self._raw[:size + 2]
        else:
            data = b""  # final frame; trailing CRLF optional at EOF
        want = hmac.new(
            self._key,
            _chunk_string_to_sign(self._amz_date, self._scope,
                                  self._prev, data).encode(),
            hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise ERR_SIGNATURE_DOES_NOT_MATCH
        self._prev = want
        if size == 0:
            self._done = True
        else:
            self._buf += data

    def read(self, n: int) -> bytes:
        while len(self._buf) < n and not self._done:
            self._read_frame()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def sign_streaming_request(method: str, path: str, query: str,
                           headers: dict[str, str], body: bytes,
                           access_key: str, secret_key: str,
                           region: str = "us-east-1",
                           chunk_size: int = 64 * 1024,
                           amz_time: float | None = None,
                           ) -> tuple[dict[str, str], bytes]:
    """Client side: produce (headers, aws-chunked body) for a streaming
    upload (what aws-sdk/mc send for large PUTs)."""
    t = time.gmtime(amz_time if amz_time is not None else time.time())
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = time.strftime("%Y%m%d", t)
    out = {k.lower(): v for k, v in headers.items()}
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = STREAMING_PAYLOAD
    out["content-encoding"] = "aws-chunked"
    out["x-amz-decoded-content-length"] = str(len(body))
    signed = sorted(out)
    cred = Credential(access_key, date, region, "s3")
    canonical = _canonical_request(method, path, query, out, signed,
                                   STREAMING_PAYLOAD)
    sts = _string_to_sign(amz_date, cred.scope, canonical)
    key = _signing_key(secret_key, date, region, "s3")
    seed = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    out["authorization"] = (
        f"{SIGN_V4_ALGORITHM} Credential={cred.access_key}/{cred.scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={seed}")

    chunks = []
    prev = seed
    for off in range(0, len(body), chunk_size):
        part = body[off:off + chunk_size]
        sig = hmac.new(key, _chunk_string_to_sign(
            amz_date, cred.scope, prev, part).encode(),
            hashlib.sha256).hexdigest()
        chunks.append(f"{len(part):x};chunk-signature={sig}\r\n".encode()
                      + part + b"\r\n")
        prev = sig
    final = hmac.new(key, _chunk_string_to_sign(
        amz_date, cred.scope, prev, b"").encode(),
        hashlib.sha256).hexdigest()
    chunks.append(f"0;chunk-signature={final}\r\n\r\n".encode())
    wire = b"".join(chunks)
    out["content-length"] = str(len(wire))
    return out, wire


# --- legacy AWS Signature V2 (ref cmd/signature-v2.go) -----------------------

# Sub-resources included in the V2 canonicalized resource, in sorted
# order (ref resourceList, cmd/signature-v2.go).
_V2_SUBRESOURCES = sorted([
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type",
    "response-expires", "select", "select-type", "tagging", "torrent",
    "uploadId", "uploads", "versionId", "versioning", "versions",
    "website", "encryption", "object-lock", "replication", "retention",
    "legal-hold", "cors",
])


def _v2_canonical_resource(raw_path: str, query: str) -> str:
    params = urllib.parse.parse_qsl(query, keep_blank_values=True)
    keep = sorted((k, v) for k, v in params if k in _V2_SUBRESOURCES)
    if not keep:
        return raw_path
    parts = [f"{k}={v}" if v else k for k, v in keep]
    return f"{raw_path}?{'&'.join(parts)}"


def _v2_string_to_sign(method: str, raw_path: str, query: str,
                       headers: dict[str, str]) -> str:
    canon_amz = "".join(
        f"{k}:{headers[k].strip()}\n"
        for k in sorted(h for h in headers if h.startswith("x-amz-")))
    # Spec: when x-amz-date is present it rides in the amz headers
    # and the Date slot is EMPTY (ref doesSignV2Match).
    date_slot = "" if "x-amz-date" in headers else headers.get("date",
                                                               "")
    return "\n".join([
        method.upper(),
        headers.get("content-md5", ""),
        headers.get("content-type", ""),
        date_slot,
    ]) + "\n" + canon_amz + _v2_canonical_resource(raw_path, query)


def verify_header_auth_v2(method: str, raw_path: str, query: str,
                          headers: dict[str, str],
                          lookup_secret) -> str:
    """Verify `Authorization: AWS AKID:signature` (HMAC-SHA1); returns
    the access key (ref doesSignV2Match)."""
    import hashlib as _hashlib
    auth = headers.get("authorization", "")
    if not auth.startswith("AWS "):
        raise ERR_MISSING_AUTH
    try:
        access_key, signature = auth[4:].split(":", 1)
    except ValueError:
        raise ERR_AUTHORIZATION_HEADER_MALFORMED
    secret = lookup_secret(access_key)
    if secret is None:
        raise ERR_INVALID_ACCESS_KEY_ID
    sts = _v2_string_to_sign(method, raw_path, query, headers)
    import base64 as _b64
    want = _b64.b64encode(hmac.new(secret.encode(), sts.encode(),
                                   _hashlib.sha1).digest()).decode()
    if not hmac.compare_digest(want, signature):
        raise ERR_SIGNATURE_DOES_NOT_MATCH
    return access_key


def sign_request_v2(method: str, path: str, query: str,
                    headers: dict[str, str], access_key: str,
                    secret_key: str) -> dict[str, str]:
    """Client-side V2 signing (tests / legacy SDK compatibility)."""
    import base64 as _b64
    import hashlib as _hashlib
    out = {k.lower(): v for k, v in headers.items()}
    out.setdefault("date", time.strftime(
        "%a, %d %b %Y %H:%M:%S GMT", time.gmtime()))
    sts = _v2_string_to_sign(method, path, query, out)
    sig = _b64.b64encode(hmac.new(secret_key.encode(), sts.encode(),
                                  _hashlib.sha1).digest()).decode()
    out["authorization"] = f"AWS {access_key}:{sig}"
    return out
