"""Per-bucket bandwidth accounting (ref pkg/bandwidth — the monitor
behind `mc admin bwinfo`, tracking replication/data bandwidth per
bucket over a sliding window).

Fixed one-second accumulator slots: O(1) record, O(window) report,
bounded memory regardless of request rate.

The port's own copy of ``minio_tpu/utils/bandwidth.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
import time

WINDOW_SECONDS = 60


class BandwidthMonitor:
    def __init__(self):
        self._mu = threading.Lock()
        # bucket -> {epoch_second: [rx, tx]}
        self._slots: dict[str, dict[int, list[int]]] = {}

    def record(self, bucket: str, rx: int, tx: int) -> None:
        if not bucket or (rx == 0 and tx == 0):
            return
        sec = int(time.time())
        with self._mu:
            slots = self._slots.setdefault(bucket, {})
            slot = slots.get(sec)
            if slot is None:
                slots[sec] = [rx, tx]
                if len(slots) > WINDOW_SECONDS + 2:
                    self._trim(slots, sec)
            else:
                slot[0] += rx
                slot[1] += tx

    @staticmethod
    def _trim(slots: dict[int, list[int]], now_sec: int) -> None:
        cutoff = now_sec - WINDOW_SECONDS
        for s in [s for s in slots if s < cutoff]:
            del slots[s]

    def report(self) -> dict:
        """{bucket: {rxBytesWindow, txBytesWindow, rxRateBps,
        txRateBps}} over the last WINDOW_SECONDS."""
        now_sec = int(time.time())
        out = {}
        with self._mu:
            for bucket, slots in list(self._slots.items()):
                self._trim(slots, now_sec)
                if not slots:
                    del self._slots[bucket]
                    continue
                rx = sum(v[0] for v in slots.values())
                tx = sum(v[1] for v in slots.values())
                out[bucket] = {
                    "rxBytesWindow": rx, "txBytesWindow": tx,
                    "rxRateBps": rx / WINDOW_SECONDS,
                    "txRateBps": tx / WINDOW_SECONDS,
                }
        return out


class TokenBucket:
    """Blocking byte-rate limiter (ref pkg/bandwidth/bandwidth.go:21
    LimitInBytesPerSecond + MonitoredReader throttle): tokens refill
    continuously at `rate_bps`; `throttle(n)` sleeps until n bytes may
    pass. Burst defaults to one second of tokens, so an idle target
    starts instantly but sustained drain converges to the limit."""

    def __init__(self, rate_bps: float, burst: float | None = None):
        if rate_bps <= 0:
            raise ValueError("rate must be positive")
        self.rate = float(rate_bps)
        self.burst = float(burst if burst is not None else rate_bps)
        self._tokens = self.burst
        self._ts = time.monotonic()
        self._mu = threading.Lock()

    def _take(self, want: float) -> float:
        """Take up to `want` tokens; returns seconds to sleep before
        retrying (0 = got them)."""
        with self._mu:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._ts) * self.rate)
            self._ts = now
            if self._tokens >= want:
                self._tokens -= want
                return 0.0
            return (want - self._tokens) / self.rate

    def throttle(self, nbytes: int) -> float:
        """Block until `nbytes` may pass (chunks larger than the burst
        are split internally so they can always eventually pass).
        Returns the seconds actually slept — 0.0 means the transfer
        passed unthrottled, so callers can count only real stalls."""
        remaining = float(nbytes)
        waited = 0.0
        while remaining > 0:
            want = min(remaining, self.burst)
            wait = self._take(want)
            if wait > 0:
                time.sleep(wait)
                waited += wait
                continue
            remaining -= want
        return waited
