"""Event targets: where notification records get delivered.

Ref pkg/event/targetlist.go:25 (Target interface: ID/Save/Send/Close),
pkg/event/target/webhook.go (HTTP POST sink) and
pkg/event/target/queuestore.go (disk-backed retry queue replayed by a
background sender — delivery survives sink outages and restarts).

The port's own copy of ``minio_tpu/event/targets.py``, with no change in
behaviour.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.parse
import uuid


class Target:
    """Interface (ref pkg/event/targetlist.go Target)."""

    def arn(self) -> str:
        raise NotImplementedError

    def send(self, record: dict) -> None:
        """Deliver one event record; raise on failure."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryTarget(Target):
    """In-process sink for tests and for the admin trace stream."""

    def __init__(self, arn_id: str = "1"):
        self._arn = f"arn:minio-tpu:sqs::{arn_id}:memory"
        self.records: list[dict] = []
        self._mu = threading.Lock()

    def arn(self) -> str:
        return self._arn

    def send(self, record: dict) -> None:
        with self._mu:
            self.records.append(record)


class WebhookTarget(Target):
    """POSTs the event payload to an HTTP endpoint
    (ref pkg/event/target/webhook.go Send)."""

    def __init__(self, endpoint: str, arn_id: str = "1",
                 timeout: float = 5.0):
        self.endpoint = endpoint
        self.timeout = timeout
        self._arn = f"arn:minio-tpu:sqs::{arn_id}:webhook"
        u = urllib.parse.urlsplit(endpoint)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if u.scheme == "https" else 80)
        # Keep the query string — webhook endpoints often carry auth
        # tokens as URL parameters.
        self._path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        self._https = u.scheme == "https"

    def arn(self) -> str:
        return self._arn

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        cls = (http.client.HTTPSConnection if self._https
               else http.client.HTTPConnection)
        conn = cls(self._host, self._port, timeout=self.timeout)
        try:
            conn.request("POST", self._path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status // 100 != 2:
                raise IOError(f"webhook {self.endpoint}: "
                              f"HTTP {resp.status}")
        finally:
            conn.close()


class QueueStoreTarget(Target):
    """Wraps a target with a disk-backed retry queue: failed sends are
    persisted as JSON files and replayed by a background thread (ref
    pkg/event/target/queuestore.go + the target boot replay)."""

    RETRY_INTERVAL = 2.0

    def __init__(self, inner: Target, store_dir: str, limit: int = 10000):
        self.inner = inner
        self.dir = store_dir
        self.limit = limit
        os.makedirs(store_dir, exist_ok=True)
        self._stop = threading.Event()
        self._kick = threading.Event()
        # mtpu-lint: disable=R1 -- queue-store retry daemon: delivery must survive (not inherit) the request deadline
        self._thread = threading.Thread(target=self._retry_loop,
                                        daemon=True)
        self._thread.start()

    def arn(self) -> str:
        return self.inner.arn()

    def send(self, record: dict) -> None:
        # While older failed events sit in the queue, new ones must park
        # BEHIND them — a direct send would reorder (e.g. a Delete
        # overtaking its key's queued Put).
        if self.pending():
            self._persist(record)
            return
        try:
            self.inner.send(record)
        except Exception:
            self._persist(record)

    def _persist(self, record: dict) -> None:
        if len(os.listdir(self.dir)) >= self.limit:
            return  # queue full: drop (ref queuestore limit behavior)
        name = f"{time.time():.6f}-{uuid.uuid4().hex}.json"
        tmp = os.path.join(self.dir, f".tmp-{name}")
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, os.path.join(self.dir, name))
        self._kick.set()

    def pending(self) -> int:
        return len([n for n in os.listdir(self.dir)
                    if not n.startswith(".tmp-")])

    def _retry_loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.RETRY_INTERVAL)
            self._kick.clear()
            for name in sorted(os.listdir(self.dir)):
                if self._stop.is_set() or name.startswith(".tmp-"):
                    continue
                path = os.path.join(self.dir, name)
                try:
                    with open(path) as f:
                        record = json.load(f)
                except (OSError, ValueError):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                try:
                    self.inner.send(record)
                except Exception:
                    break  # sink still down; retry next tick, keep order
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        self._kick.set()
        self._thread.join(timeout=5)
        self.inner.close()
