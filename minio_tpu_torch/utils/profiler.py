"""Sampling profiler covering ALL threads (the admin /profiling
endpoints' engine; ref cmd/utils.go:230 globalProfiler — the reference
collects whole-process pprof profiles, so a per-thread cProfile would
miss every request handler thread).

A sampler thread walks sys._current_frames() on an interval and
aggregates inclusive sample counts per frame; the report is a flat
"top functions" table like `pprof -top`.  The frame walk itself is
``sample_stacks`` so the continuous profiler (obs/loopmon.py) shares
one stack-capture implementation with the on-demand burst profiler.

The port's own copy of ``minio_tpu/utils/profiler.py``, with no change in
behaviour.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter

# A frame key: (filename, firstlineno, name) — stable across calls and
# cheap to aggregate on (the line is the DEF line, not the executing
# line, so all samples inside one function collapse to one row).
FrameKey = tuple[str, int, str]


def sample_stacks(skip: set[int] | frozenset[int] = frozenset(),
                  ) -> list[list[FrameKey]]:
    """One sys._current_frames() walk: every thread's Python stack,
    LEAF FIRST (stack[0] is the executing frame), excluding thread
    idents in ``skip`` (the sampler itself must not profile its own
    walk loop)."""
    stacks: list[list[FrameKey]] = []
    for tid, frame in sys._current_frames().items():
        if tid in skip:
            continue
        stack: list[FrameKey] = []
        while frame is not None:
            code = frame.f_code
            stack.append((code.co_filename, code.co_firstlineno,
                          code.co_name))
            frame = frame.f_back
        stacks.append(stack)
    return stacks


def frame_label(key: FrameKey) -> str:
    """Human row for a frame key: ``name (file.py:line)``."""
    file, line, name = key
    return f"{name} ({file.rsplit('/', 1)[-1]}:{line})"


class SamplingProfiler:
    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples = 0
        self.leaf_counts: Counter = Counter()   # executing function
        self.stack_counts: Counter = Counter()  # anywhere on stack
        self.started_at = 0.0

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("profiler already running")
        self._stop.clear()
        self.started_at = time.time()
        # mtpu-lint: disable=R1 -- sampling daemon observes ALL threads; a request deadline would truncate the profile
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sampling-profiler")
        self._thread.start()

    def _run(self) -> None:
        me = frozenset((threading.get_ident(),))
        while not self._stop.wait(self.interval):
            self.samples += 1
            for stack in sample_stacks(skip=me):
                if stack:
                    self.leaf_counts[stack[0]] += 1
                for key in set(stack):
                    self.stack_counts[key] += 1

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        return self.report()

    # Wide enough that briefly-active request handlers still make the
    # table: every PARKED thread's wait frames count on every sample,
    # and a long-lived process holds dozens of parked stacks — a
    # 50-row table was all idle frames under full-suite load.
    def report(self, top: int = 100) -> dict:
        def rows(counter: Counter) -> list[dict]:
            total = max(1, self.samples)
            return [{
                "function": frame_label(key),
                "samples": n,
                "pct": round(100.0 * n / total, 1),
            } for key, n in counter.most_common(top)]

        return {
            "durationSeconds": round(time.time() - self.started_at, 2),
            "samples": self.samples,
            "intervalMs": self.interval * 1000,
            "self": rows(self.leaf_counts),
            "cumulative": rows(self.stack_counts),
        }
