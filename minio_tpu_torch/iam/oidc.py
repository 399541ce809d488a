"""OpenID Connect token validation for STS WebIdentity.

The reference validates WebIdentity JWTs against the provider's
published JWKS (ref cmd/config/identity/openid/jwks.go:30 DecodePublicKey,
cmd/config/identity/openid/jwt.go Validate). This build does the same
with zero dependencies: RSASSA-PKCS1-v1_5/SHA-256 verification is pure
bignum math over the JWK's (n, e), and the JWKS document is fetched
from a configurable URL (a test fixture server stands in for the
provider).

HS256 against a shared secret remains available as an explicit DEV mode
(the earlier scheme), but is only honored when no JWKS URL is
configured: a deployment that points at a provider never silently
accepts symmetric tokens.

The port's own copy of ``minio_tpu/iam/oidc.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import threading
import time
import urllib.request


class OIDCError(ValueError):
    """Token failed validation (malformed, bad signature, expired...)."""


def _b64u(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


# DER DigestInfo prefix for SHA-256 (RFC 8017 section 9.2 note 1).
_SHA256_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def emsa_pkcs1_sha256(message: bytes, em_len: int) -> bytes:
    """EMSA-PKCS1-v1_5 encoding of SHA-256(message) into em_len bytes
    (RFC 8017 section 9.2): 00 01 FF..FF 00 || DigestInfo || H."""
    t = _SHA256_PREFIX + hashlib.sha256(message).digest()
    if em_len < len(t) + 11:
        raise OIDCError("RSA modulus too small")
    ps = b"\xff" * (em_len - len(t) - 3)
    return b"\x00\x01" + ps + b"\x00" + t


def rs256_verify(n: int, e: int, message: bytes, signature: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 verify with SHA-256 over a JWK (n, e) pair —
    pure bignum: EM' = sig^e mod n, compared against the canonical
    encoding (ref jwks.go builds an rsa.PublicKey the same way)."""
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    return hmac.compare_digest(em, emsa_pkcs1_sha256(message, k))


class Jwks:
    """A parsed JWKS document: kid -> (n, e) for RSA keys."""

    def __init__(self, keys: dict[str, tuple[int, int]]):
        self.keys = keys

    @classmethod
    def from_dict(cls, doc: dict) -> "Jwks":
        keys: dict[str, tuple[int, int]] = {}
        for jwk in doc.get("keys", []):
            if jwk.get("kty") != "RSA" or "n" not in jwk or "e" not in jwk:
                continue
            n = int.from_bytes(_b64u(jwk["n"]), "big")
            e = int.from_bytes(_b64u(jwk["e"]), "big")
            keys[jwk.get("kid", "")] = (n, e)
        return cls(keys)

    def candidates(self, kid: str | None) -> list[tuple[int, int]]:
        """Keys to try: the kid's key, or every key when the token
        carries no kid (providers may rotate without kids)."""
        if kid is not None and kid in self.keys:
            return [self.keys[kid]]
        if kid is None:
            return list(self.keys.values())
        return []


class OpenIDValidator:
    """Validates WebIdentity bearer tokens.

    RS256 against a JWKS fetched from `jwks_url` (refreshed on unknown
    kid, rate-limited); HS256 against `hs256_secret` only when no JWKS
    URL is configured (dev mode). Enforces exp/nbf and, when
    `client_id` is set, the aud claim (ref openid/jwt.go Validate).
    """

    def __init__(self, jwks_url: str = "", client_id: str = "",
                 hs256_secret: str = "", claim_name: str = "policy",
                 fetch_timeout: float = 5.0):
        self.jwks_url = jwks_url
        self.client_id = client_id
        self.hs256_secret = hs256_secret
        self.claim_name = claim_name
        self.fetch_timeout = fetch_timeout
        self._jwks: Jwks | None = None
        self._fetched_at = 0.0
        self._mu = threading.Lock()

    @classmethod
    def from_env(cls, env=os.environ) -> "OpenIDValidator | None":
        jwks_url = env.get("MINIO_IDENTITY_OPENID_JWKS_URL", "")
        secret = env.get("MINIO_IDENTITY_OPENID_SECRET", "")
        if not jwks_url and not secret:
            return None
        return cls(jwks_url=jwks_url,
                   client_id=env.get(
                       "MINIO_IDENTITY_OPENID_CLIENT_ID", ""),
                   hs256_secret=secret,
                   claim_name=env.get(
                       "MINIO_IDENTITY_OPENID_CLAIM_NAME", "policy"))

    # -- JWKS cache -----------------------------------------------------

    def _fetch_jwks(self, force: bool = False) -> Jwks:
        # Cache hit without the lock (attribute read is atomic): a slow
        # JWKS endpoint must never stall validations that don't fetch.
        cached = self._jwks
        if cached is not None and not force:
            return cached
        with self._mu:
            now = time.monotonic()
            if self._jwks is not None and (
                    not force or now - self._fetched_at < 30):
                return self._jwks  # fetched meanwhile / rate-limited
            req = urllib.request.Request(
                self.jwks_url, headers={"User-Agent": "minio-tpu"})
            with urllib.request.urlopen(
                    req, timeout=self.fetch_timeout) as resp:
                doc = json.loads(resp.read())
            self._jwks = Jwks.from_dict(doc)
            self._fetched_at = time.monotonic()
            return self._jwks

    # -- validation -----------------------------------------------------

    def validate(self, token: str) -> dict:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64u(header_b64))
            claims = json.loads(_b64u(payload_b64))
            sig = _b64u(sig_b64)
        except Exception:
            raise OIDCError("malformed token")
        if not isinstance(header, dict) or not isinstance(claims, dict):
            raise OIDCError("malformed token")
        alg = header.get("alg", "")
        signing_input = f"{header_b64}.{payload_b64}".encode()

        if alg == "RS256" and self.jwks_url:
            jwks = self._fetch_jwks()
            kid = header.get("kid")
            cands = jwks.candidates(kid)
            ok = any(rs256_verify(n, e, signing_input, sig)
                     for n, e in cands)
            if not ok:
                # Unknown kid OR a no-kid token that no cached key
                # verifies: the provider may have rotated its keys.
                # One rate-limited refresh (30s) covers both shapes.
                jwks = self._fetch_jwks(force=True)
                ok = any(rs256_verify(n, e, signing_input, sig)
                         for n, e in jwks.candidates(kid))
            if not ok:
                raise OIDCError("invalid RS256 signature")
        elif alg == "HS256" and self.hs256_secret and not self.jwks_url:
            want = hmac.new(self.hs256_secret.encode(), signing_input,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise OIDCError("invalid HS256 signature")
        else:
            raise OIDCError(f"unsupported or unconfigured alg {alg!r}")

        now = time.time()
        exp = claims.get("exp")
        if not isinstance(exp, (int, float)) or now > exp:
            raise OIDCError("token expired")
        nbf = claims.get("nbf")
        if isinstance(nbf, (int, float)) and now < nbf:
            raise OIDCError("token not yet valid")
        if self.client_id:
            aud = claims.get("aud", "")
            auds = aud if isinstance(aud, list) else [aud]
            if self.client_id not in auds:
                raise OIDCError("aud mismatch")
        return claims
