"""Browser POST form uploads with policy conditions (ref
cmd/postpolicyform.go ~300 LoC + PostPolicyBucketHandler routed at
cmd/api-router.go:304).

A POST to the bucket URL carries multipart/form-data: a base64 policy
document, a SigV4 signature over that exact base64 string, form fields,
and the file payload. The policy lists conditions (eq / starts-with /
content-length-range) that the form fields must satisfy.

The port's own copy of ``minio_tpu/s3/formupload.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field


class FormError(Exception):
    pass


class PolicyViolation(Exception):
    pass


# ---------------------------------------------------------------------------
# multipart/form-data parsing (no cgi module in modern Python)
# ---------------------------------------------------------------------------


@dataclass
class FormData:
    fields: dict[str, str] = field(default_factory=dict)
    file_name: str = ""
    file_data: bytes = b""
    file_content_type: str = ""
    has_file: bool = False


def parse_multipart(content_type: str, body: bytes) -> FormData:
    """Minimal RFC7578 parser: boundary-split, per-part headers, one
    `file` part, everything else text fields."""
    if "boundary=" not in content_type:
        raise FormError("no boundary in content-type")
    boundary = content_type.split("boundary=", 1)[1].strip().strip('"')
    delim = b"--" + boundary.encode()
    out = FormData()
    # Parts sit between delimiters; final delimiter ends with "--".
    chunks = body.split(delim)
    for chunk in chunks[1:-1] if len(chunks) > 2 else chunks[1:]:
        if chunk in (b"--\r\n", b"--"):
            continue
        part = chunk.lstrip(b"\r\n")
        head, sep, payload = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        name = filename = ctype = ""
        for line in head.split(b"\r\n"):
            ls = line.decode("utf-8", "replace")
            low = ls.lower()
            if low.startswith("content-disposition:"):
                for item in ls.split(";")[1:]:
                    k, _, v = item.strip().partition("=")
                    v = v.strip('"')
                    if k == "name":
                        name = v
                    elif k == "filename":
                        filename = v
            elif low.startswith("content-type:"):
                ctype = ls.split(":", 1)[1].strip()
        if name.lower() == "file":
            out.has_file = True
            out.file_name = filename
            out.file_data = payload
            out.file_content_type = ctype
        elif name:
            out.fields[name] = payload.decode("utf-8", "replace")
    return out


# ---------------------------------------------------------------------------
# policy document (ref PostPolicyForm parsing, cmd/postpolicyform.go)
# ---------------------------------------------------------------------------


@dataclass
class PolicyCondition:
    op: str       # "eq" | "starts-with" | "content-length-range"
    name: str     # normalized, no "$", lowercase
    value: str = ""
    range_min: int = 0
    range_max: int = 0


@dataclass
class PostPolicy:
    expiration: float = 0.0
    conditions: list[PolicyCondition] = field(default_factory=list)

    @classmethod
    def from_json(cls, raw: bytes) -> "PostPolicy":
        try:
            doc = json.loads(raw)
        except ValueError:
            raise FormError("policy is not valid JSON")
        p = cls()
        exp = doc.get("expiration", "")
        if not exp:
            # A policy with no expiry would be a permanent upload
            # credential; AWS and the reference both reject it.
            raise FormError("policy must carry an expiration")
        from ..bucket.objectlock import parse_iso8601
        try:
            p.expiration = parse_iso8601(exp)
        except ValueError:
            raise FormError(f"bad expiration {exp!r}")
        for cond in doc.get("conditions", []):
            if isinstance(cond, dict):  # {"bucket": "b"} = eq shorthand
                for k, v in cond.items():
                    p.conditions.append(PolicyCondition(
                        "eq", k.lower(), str(v)))
            elif isinstance(cond, list) and len(cond) == 3:
                op = str(cond[0]).lower()
                if op == "content-length-range":
                    p.conditions.append(PolicyCondition(
                        op, "", range_min=int(cond[1]),
                        range_max=int(cond[2])))
                elif op in ("eq", "starts-with"):
                    name = str(cond[1]).lstrip("$").lower()
                    p.conditions.append(PolicyCondition(
                        op, name, str(cond[2])))
                else:
                    raise FormError(f"unknown condition op {op!r}")
            else:
                raise FormError(f"malformed condition {cond!r}")
        return p

    # Form fields that need no policy condition (ref checkPostPolicy's
    # skip list: the signature machinery itself + file + x-ignore-*).
    SKIP_FIELDS = {"policy", "x-amz-signature", "file", "bucket"}

    def check(self, fields: dict[str, str], size: int,
              now: float | None = None) -> None:
        """Enforce every policy condition against the submitted form,
        AND require every submitted field to be covered by a condition
        — otherwise a signed form becomes a vehicle for arbitrary
        attacker-chosen fields (ref checkPostPolicy,
        cmd/postpolicyform.go)."""
        now = time.time() if now is None else now
        if now > self.expiration:
            raise PolicyViolation("policy has expired")
        lower = {k.lower(): v for k, v in fields.items()}
        covered = {c.name for c in self.conditions if c.name}
        for name in lower:
            if name in self.SKIP_FIELDS or name.startswith("x-ignore-"):
                continue
            if name not in covered:
                raise PolicyViolation(
                    f"form field {name!r} not covered by any policy "
                    "condition")
        # interpolated key: browsers send key templates w/ ${filename}
        for c in self.conditions:
            if c.op == "content-length-range":
                if not (c.range_min <= size <= c.range_max):
                    raise PolicyViolation(
                        f"size {size} outside "
                        f"[{c.range_min},{c.range_max}]")
                continue
            got = lower.get(c.name, "")
            if c.op == "eq":
                if got != c.value:
                    raise PolicyViolation(
                        f"{c.name}: {got!r} != {c.value!r}")
            elif c.op == "starts-with":
                if not got.startswith(c.value):
                    raise PolicyViolation(
                        f"{c.name}: {got!r} !startswith {c.value!r}")


def verify_post_signature(policy_b64: str, fields: dict[str, str],
                          lookup_secret) -> str:
    """SigV4 POST-policy signature: HMAC(signing key, base64 policy)
    (ref doesPolicySignatureV4Match, cmd/signature-v4.go). Returns the
    access key."""
    from . import sigv4
    from .errors import (ERR_INVALID_ACCESS_KEY_ID, ERR_MISSING_AUTH,
                         ERR_SIGNATURE_DOES_NOT_MATCH)
    lower = {k.lower(): v for k, v in fields.items()}
    algo = lower.get("x-amz-algorithm", "")
    if algo != sigv4.SIGN_V4_ALGORITHM:
        raise ERR_MISSING_AUTH
    cred_s = lower.get("x-amz-credential", "")
    signature = lower.get("x-amz-signature", "")
    cred = sigv4._parse_credential(cred_s)
    secret = lookup_secret(cred.access_key)
    if secret is None:
        raise ERR_INVALID_ACCESS_KEY_ID
    key = sigv4._signing_key(secret, cred.date, cred.region, cred.service)
    want = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, signature):
        raise ERR_SIGNATURE_DOES_NOT_MATCH
    return cred.access_key


def build_post_form(bucket: str, key: str, data: bytes, access_key: str,
                    secret_key: str, region: str = "us-east-1",
                    conditions: list | None = None,
                    expires_in: int = 3600,
                    extra_fields: dict | None = None,
                    ) -> tuple[str, bytes]:
    """Client/test helper: a signed multipart form for POST upload.
    Returns (content_type, body)."""
    from . import sigv4
    t = time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = time.strftime("%Y%m%d", t)
    cred = f"{access_key}/{date}/{region}/s3/aws4_request"
    exp = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                        time.gmtime(time.time() + expires_in))
    # Templated keys can't be eq-pinned (the browser substitutes the
    # filename); use starts-with on the static prefix, as AWS docs do.
    if "${filename}" in key:
        key_cond = ["starts-with", "$key",
                    key.split("${filename}", 1)[0]]
    else:
        key_cond = ["eq", "$key", key]
    conds = [{"bucket": bucket}, key_cond,
             ["eq", "$x-amz-algorithm", sigv4.SIGN_V4_ALGORITHM],
             ["eq", "$x-amz-credential", cred],
             ["eq", "$x-amz-date", amz_date]]
    conds += conditions or []
    policy_b64 = base64.b64encode(json.dumps(
        {"expiration": exp, "conditions": conds}).encode()).decode()
    key_sig = sigv4._signing_key(secret_key, date, region, "s3")
    signature = hmac.new(key_sig, policy_b64.encode(),
                         hashlib.sha256).hexdigest()
    fields = {
        "key": key, "policy": policy_b64,
        "x-amz-algorithm": sigv4.SIGN_V4_ALGORITHM,
        "x-amz-credential": cred, "x-amz-date": amz_date,
        "x-amz-signature": signature,
    }
    fields.update(extra_fields or {})
    boundary = "----minio-tpu-form-boundary"
    parts = []
    for k, v in fields.items():
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{k}"\r\n\r\n{v}\r\n'.encode())
    parts.append(
        f"--{boundary}\r\nContent-Disposition: form-data; "
        f'name="file"; filename="upload"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n".encode()
        + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return (f"multipart/form-data; boundary={boundary}",
            b"".join(parts))
