"""Audit logging: one structured entry per API request, delivered to a
webhook target from a background queue (ref cmd/logger/audit.go:128
AuditLog + cmd/logger/target/http — MINIO_AUDIT_WEBHOOK_* env).

Delivery is async and lossy-on-overflow: the data path never blocks on
the audit sink (same bounded-channel design as the reference's http
target).

The port's own copy of ``minio_tpu/logger/audit.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import urllib.request


def audit_entry(api: str, method: str, path: str, status: int,
                duration_ms: float, rx: int, tx: int,
                access_key: str = "", request_id: str = "",
                remote: str = "", qos_class: str = "",
                blamed_layer: str = "") -> dict:
    """Entry shape follows the reference's audit.Entry fields, plus
    the join keys against this stack's observability planes: trace_id
    (= the request id every span tree is keyed by), the QoS admission
    class, and — when the request landed in the slow-request log — the
    blamed layer, so the webhook stream correlates with the slowlog
    without a second lookup."""
    return {
        "version": "1",
        "deploymentid": "minio-tpu",
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "api": {
            "name": api, "method": method, "path": path,
            "statusCode": status,
            "timeToResponseNs": int(duration_ms * 1e6),
            "rx": rx, "tx": tx,
        },
        "requestID": request_id,
        "trace_id": request_id,
        "qos_class": qos_class,
        "blamed_layer": blamed_layer,
        "accessKey": access_key,
        "remotehost": remote,
    }


class AuditWebhook:
    """Queue + worker POSTing JSON entries to the webhook endpoint."""

    def __init__(self, endpoint: str, auth_token: str = "",
                 queue_size: int = 10_000):
        self.endpoint = endpoint
        self.auth_token = auth_token
        self._q: queue.Queue[dict | None] = queue.Queue(maxsize=queue_size)
        self._stats_mu = threading.Lock()
        self.dropped = 0
        self.sent = 0
        self.failed = 0
        # mtpu-lint: disable=R1 -- audit drain daemon: entries from many requests share one worker
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="audit-webhook")
        self._worker.start()

    @classmethod
    def from_env(cls, env=os.environ) -> "AuditWebhook | None":
        ep = env.get("MINIO_AUDIT_WEBHOOK_ENDPOINT", "")
        if not ep:
            return None
        return cls(ep, env.get("MINIO_AUDIT_WEBHOOK_AUTH_TOKEN", ""))

    def send(self, entry: dict) -> None:
        try:
            self._q.put_nowait(entry)
        except queue.Full:
            with self._stats_mu:
                self.dropped += 1

    def queued(self) -> int:
        """Entries waiting for the delivery worker (status surface —
        admin audit-status must not reach into the private queue)."""
        return self._q.qsize()

    def _run(self) -> None:
        while True:
            entry = self._q.get()
            if entry is None:
                return
            try:
                req = urllib.request.Request(
                    self.endpoint, data=json.dumps(entry).encode(),
                    headers={"Content-Type": "application/json",
                             **({"Authorization":
                                 f"Bearer {self.auth_token}"}
                                if self.auth_token else {})})
                urllib.request.urlopen(req, timeout=5).read()
                with self._stats_mu:
                    self.sent += 1
            except Exception:
                with self._stats_mu:
                    self.failed += 1

    def close(self) -> None:
        self._q.put(None)
