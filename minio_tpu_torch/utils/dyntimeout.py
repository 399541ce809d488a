"""Self-tuning operation timeouts from success/failure history (ref
cmd/dynamic-timeouts.go:35-101 — dynamicTimeout tracks the last N op
durations; if too many hit the ceiling the timeout grows 25%, if the
p75 runs far below it the timeout shrinks, never past a floor).

``PercentileBudget`` is the continuous sibling used by the hedged-read
layer (erasure/engine.py): instead of a pass/fail-adjusted ceiling it
tracks a rolling percentile of observed durations directly, so the
straggler budget follows the healthy population as it drifts.

The port's own copy of ``minio_tpu/utils/dyntimeout.py``, with no change
in behaviour.
"""

from __future__ import annotations

import threading

LOG_SIZE = 64          # entries per adjustment window
INCREASE_PCT = 0.33    # >33% timeouts in a window -> grow
SHRINK_FACTOR = 0.75   # shrink step (ref dynamicTimeoutDecrease)
GROW_FACTOR = 1.25     # grow step


class DynamicTimeout:
    """Thread-safe adaptive timeout in seconds."""

    def __init__(self, timeout: float, minimum: float,
                 maximum: float | None = None):
        self._timeout = float(timeout)
        self.minimum = float(minimum)
        # Growth is geometric; without a ceiling repeated failures
        # would inflate it unboundedly.
        self.maximum = float(maximum) if maximum else float(timeout) * 8
        self._mu = threading.Lock()
        self._log: list[float] = []
        self._failures = 0

    @property
    def timeout(self) -> float:
        return self._timeout

    def log_success(self, duration: float) -> None:
        self._record(duration, failed=False)

    def log_failure(self) -> None:
        """An op hit the ceiling (timed out / peer unreachable)."""
        self._record(self._timeout, failed=True)

    def _record(self, duration: float, failed: bool) -> None:
        with self._mu:
            self._log.append(duration)
            if failed:
                self._failures += 1
            if len(self._log) < LOG_SIZE:
                return
            # Window full: adjust once, reset.
            fail_frac = self._failures / len(self._log)
            if fail_frac > INCREASE_PCT:
                self._timeout = min(self.maximum,
                                    self._timeout * GROW_FACTOR)
            else:
                srt = sorted(self._log)
                p75 = srt[(len(srt) * 3) // 4]
                # Plenty of headroom -> tighten, but keep 2x the p75
                # and never fall under the floor.
                if p75 < self._timeout * SHRINK_FACTOR / 2:
                    self._timeout = max(self.minimum, max(
                        self._timeout * SHRINK_FACTOR, p75 * 2))
            self._log.clear()
            self._failures = 0


class PercentileBudget:
    """Adaptive straggler budget: ``multiplier`` x the rolling p75 of
    observed op durations, clamped to [floor, ceiling].

    The hedging layer asks "how long is an unusually slow — but still
    healthy — shard read allowed to take before a backup read fires?".
    DynamicTimeout answers a different question (how long before an op
    is *dead*), so this class derives the budget from the same
    windowed-percentile idea but continuously: a bounded ring of the
    most recent durations, percentile computed on demand (the read
    path asks once per shard-read group, not per sample).

    Cold start: until ``MIN_SAMPLES`` durations are observed the
    budget is the ceiling — hedging stays OFF until the healthy
    population is actually known, so an idle server's first requests
    can never fire spurious backup reads.

    p75, not p90: hedged reads feed the losing straggler's (censored,
    see observe()) duration back into the ring, so under one faulty
    drive in a k+m set the ring carries a persistent ~1-in-(k+1)
    straggler mass. A p75 pivot stays inside the healthy mass for any
    straggler minority under 25%, keeping the budget from ratcheting
    toward the fault latency; a population-WIDE slowdown moves p75
    itself and the budget still adapts.
    """

    RING = 128
    MIN_SAMPLES = 16
    # observe() is on the k-way shard-read fan-out (every successful
    # fetch records a duration) — sorting the ring per sample under
    # the shared lock would serialize the exact fan-out the drive
    # monitor's per-drive locks exist to decontend, so the percentile is
    # recomputed every RECALC_EVERY inserts and observe() clamps
    # against the cached value (censoring is approximate by nature;
    # a slightly stale cap only shifts WHERE a straggler sample is
    # clipped, not the percentile it's kept away from).
    RECALC_EVERY = 16

    def __init__(self, multiplier: float = 4.0, floor: float = 0.050,
                 ceiling: float = 2.0):
        self.multiplier = float(multiplier)
        self.floor = float(floor)
        self.ceiling = float(ceiling)
        self._mu = threading.Lock()
        self._ring: list[float] = []
        self._next = 0
        self._seen = 0
        self._cached = self.ceiling

    def observe(self, duration: float) -> None:
        """Censored observe: the sample is clamped at the current
        (cached) budget. A straggler the hedge raced past must not
        poison the healthy percentile (a few faulty-drive reads at
        100x the median would drag the percentile into the fault mode
        and the budget would stop hedges from ever firing again);
        clamping records it as "at least the budget" evidence
        instead. A genuine population-wide slowdown still walks the
        budget upward: each capped sample raises p75 toward the cap,
        which raises the next recompute's cap, compounding until the
        budget tracks the new population."""
        with self._mu:
            duration = min(duration, self._cached)
            if len(self._ring) < self.RING:
                self._ring.append(duration)
            else:
                self._ring[self._next] = duration
                self._next = (self._next + 1) % self.RING
            self._seen += 1
            if (self._seen >= self.MIN_SAMPLES
                    and self._seen % self.RECALC_EVERY == 0):
                self._cached = self._compute_locked()

    def _compute_locked(self) -> float:
        if self._seen < self.MIN_SAMPLES:
            return self.ceiling
        srt = sorted(self._ring)
        p75 = srt[min(len(srt) - 1, (len(srt) * 3) // 4)]
        return max(self.floor, min(self.ceiling,
                                   self.multiplier * p75))

    def budget(self) -> float:
        """Current straggler budget in seconds (exact — callers ask
        once per shard-read group, not per sample)."""
        with self._mu:
            self._cached = self._compute_locked()
            return self._cached

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()
            self._next = 0
            self._seen = 0
            self._cached = self.ceiling
