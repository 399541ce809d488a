"""External KMS client (ref the reference's KES integration —
cmd/crypto/kms.go + github.com/minio/kes: SSE-S3 object keys seal under
per-object DATA KEYS generated by the KMS, so the master key never
leaves the KMS and key rotation is a KMS-side operation).

KES HTTP API subset used:
    POST /v1/key/generate/<name>  {"context": b64}
        -> {"plaintext": b64(32B), "ciphertext": b64(opaque)}
    POST /v1/key/decrypt/<name>   {"ciphertext": b64, "context": b64}
        -> {"plaintext": b64(32B)}

Auth: KES proper authenticates with mTLS client certs — supported via
an ssl context (utils.certs.client_context + client cert env); an
API-key header is also accepted for fakes/dev.

The port's own copy of ``minio_tpu/crypto/kms.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import json
import os


class KMSError(Exception):
    pass


class KESClient:
    def __init__(self, endpoint: str, key_name: str,
                 api_key: str = "", tls=None, timeout: float = 10.0):
        from ..utils.httpjson import parse_endpoint
        self.host, self.port, self.https = parse_endpoint(endpoint,
                                                          7373)
        self.key_name = key_name
        self.api_key = api_key
        self.tls = tls
        self.timeout = timeout
        self.key_id = f"kes:{key_name}"
        self.configured = True

    def _call(self, path: str, doc: dict) -> dict:
        from ..utils.httpjson import json_post
        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        return json_post(self.host, self.port, self.https, path, doc,
                         self.timeout, KMSError, headers=headers,
                         tls=self.tls)

    @staticmethod
    def _context(bucket: str, key: str) -> str:
        return base64.b64encode(json.dumps(
            {"bucket": bucket, "object": key},
            sort_keys=True).encode()).decode()

    def generate_key(self, bucket: str, key: str) -> tuple[bytes, str]:
        """(plaintext 32B data key, wrapped ciphertext b64) bound to
        the object context."""
        doc = self._call(f"/v1/key/generate/{self.key_name}",
                         {"context": self._context(bucket, key)})
        plaintext = base64.b64decode(doc.get("plaintext", ""))
        if len(plaintext) != 32:
            raise KMSError("KES returned a non-32-byte data key")
        wrapped = doc.get("ciphertext", "")
        if not wrapped:
            # An object sealed under a data key with no stored wrapped
            # copy could NEVER be decrypted again — refuse up front.
            raise KMSError("KES returned no ciphertext for the data key")
        return plaintext, wrapped

    def decrypt_key(self, wrapped_b64: str, bucket: str,
                    key: str) -> bytes:
        doc = self._call(f"/v1/key/decrypt/{self.key_name}",
                         {"ciphertext": wrapped_b64,
                          "context": self._context(bucket, key)})
        plaintext = base64.b64decode(doc.get("plaintext", ""))
        if len(plaintext) != 32:
            raise KMSError("KES decrypt returned a bad data key")
        return plaintext

    @classmethod
    def from_env(cls, env=None) -> "KESClient | None":
        env = env if env is not None else os.environ
        ep = env.get("MINIO_KMS_KES_ENDPOINT", "")
        name = env.get("MINIO_KMS_KES_KEY_NAME", "")
        if not (ep and name):
            return None
        tls = None
        if ep.startswith("https://"):
            from ..utils.certs import client_context_from_env
            tls = client_context_from_env()
        return cls(ep, name,
                   api_key=env.get("MINIO_KMS_KES_API_KEY", ""),
                   tls=tls)
