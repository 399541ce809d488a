"""Tiny thread-safe pub/sub hub (ref pkg/pubsub/pubsub.go, 176 LoC —
the fan-out behind `mc admin trace` and console-log streaming).

Subscribers get a bounded Queue; slow subscribers drop messages rather
than stall publishers (same non-blocking send as the reference's
buffered-channel subscribers).

The port's own copy of ``minio_tpu/utils/pubsub.py``, with no change in
behaviour.
"""

from __future__ import annotations

import queue
import threading


class PubSub:
    def __init__(self, buffer: int = 1000):
        self._mu = threading.Lock()
        self._subs: list[queue.Queue] = []
        self.buffer = buffer

    def publish(self, item) -> None:
        with self._mu:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(item)
            except queue.Full:
                pass  # slow subscriber: drop, never block the data path

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=self.buffer)
        with self._mu:
            self._subs.append(q)
        return q

    def collect(self, timeout: float, cap: int = 10_000) -> list:
        """Subscribe, gather entries for up to `timeout` seconds (or
        until `cap`), unsubscribe — the bounded long-poll behind both
        the local admin trace API and the peer trace RPC."""
        import time as _time
        q = self.subscribe()
        entries: list = []
        deadline = _time.time() + timeout
        try:
            while _time.time() < deadline and len(entries) < cap:
                try:
                    entries.append(q.get(
                        timeout=max(0.01, deadline - _time.time())))
                except queue.Empty:
                    break
        finally:
            self.unsubscribe(q)
        return entries

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._mu:
            try:
                self._subs.remove(q)
            except ValueError:
                pass

    @property
    def subscriber_count(self) -> int:
        with self._mu:
            return len(self._subs)
