"""TLS certificate management with hot reload (ref pkg/certs — the
reference watches public.crt/private.key and serves renewed certs to
new handshakes without a restart; 816 LoC of fsnotify plumbing maps to
a small mtime poller here, because ssl.SSLContext.load_cert_chain can
be re-invoked on a LIVE server context and only new handshakes see the
new chain).

Conventions (ref cmd/config-dir.go certsDir):
    MINIO_CERT_FILE / MINIO_KEY_FILE            explicit pair, or
    ~/.minio-tpu/certs/public.crt + private.key default location
    MINIO_CA_FILE                               extra CA for clients
    MINIO_TLS_VERIFY=off                        internal RPC: skip verify

The port's own copy of ``minio_tpu/utils/certs.py``, with no change in
behaviour.
"""

from __future__ import annotations

import os
import ssl
import threading


class CertManager:
    """Server-side TLS context that reloads the cert/key pair when the
    files change (new handshakes pick up the new chain; established
    connections are untouched, like the reference)."""

    def __init__(self, cert_file: str, key_file: str,
                 poll_s: float = 5.0):
        self.cert_file = cert_file
        self.key_file = key_file
        self.poll_s = poll_s
        self.context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self.reloads = 0
        self._mtimes = (0.0, 0.0)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._load()

    def _stat(self) -> tuple[float, float]:
        return (os.path.getmtime(self.cert_file),
                os.path.getmtime(self.key_file))

    def _load(self) -> None:
        # Record mtimes BEFORE loading: a renewal racing the load then
        # looks changed on the next poll and reloads, instead of being
        # recorded-but-never-loaded.
        mt = self._stat()
        # Validate the pair in a THROWAWAY context first: OpenSSL
        # installs the cert into a live context before discovering a
        # key mismatch, which would poison every new handshake during
        # a non-atomic (certbot-style) renewal window.
        probe = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        probe.load_cert_chain(self.cert_file, self.key_file)
        self.context.load_cert_chain(self.cert_file, self.key_file)
        self._mtimes = mt

    def check(self) -> bool:
        """Reload if the files changed; returns True when reloaded.
        A half-written pair (cert updated, key not yet) fails load and
        is retried on the next poll — the old chain keeps serving."""
        try:
            mt = self._stat()
        except OSError:
            return False
        if mt == self._mtimes:
            return False
        try:
            self._load()
        except (ssl.SSLError, OSError):
            return False
        self.reloads += 1
        return True

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        # mtpu-lint: disable=R1 -- cert-reload daemon; no request context exists at boot
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cert-reloader")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:
                pass  # never kill the reloader; next poll retries

    @classmethod
    def from_env(cls, env=None) -> "CertManager | None":
        env = env if env is not None else os.environ
        cert = env.get("MINIO_CERT_FILE", "")
        key = env.get("MINIO_KEY_FILE", "")
        if cert and key:
            # Explicit configuration: a typo'd path must NOT silently
            # downgrade credential-bearing traffic to plaintext.
            if not (os.path.exists(cert) and os.path.exists(key)):
                raise FileNotFoundError(
                    f"MINIO_CERT_FILE/MINIO_KEY_FILE set but missing: "
                    f"{cert} / {key}")
            return cls(cert, key)
        base = os.path.join(os.path.expanduser("~"), ".minio-tpu",
                            "certs")
        cert = os.path.join(base, "public.crt")
        key = os.path.join(base, "private.key")
        if os.path.exists(cert) and os.path.exists(key):
            return cls(cert, key)
        return None


def client_context(ca_file: str = "", verify: bool = True,
                   ) -> ssl.SSLContext:
    """Client-side context for S3/RPC TLS. verify=False is for
    internal cluster RPC with self-signed node certs when no shared CA
    is distributed (the HMAC request signing still authenticates every
    call; ref the reference's --insecure / global skip-verify)."""
    ctx = ssl.create_default_context(
        cafile=ca_file if ca_file else None)
    if not verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


def client_context_from_env(env=None) -> ssl.SSLContext:
    env = env if env is not None else os.environ
    return client_context(env.get("MINIO_CA_FILE", ""),
                          env.get("MINIO_TLS_VERIFY", "on") != "off")
