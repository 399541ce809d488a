"""Bounded-depth producer/consumer pipeline for the erasure data plane.

The hot paths were phase-serial: a PUT batch was read, encoded, and
only then fanned out to disks; a GET group was fetched, verified,
decoded, yielded — each phase idle while the other ran. RapidRAID
(arXiv:1207.6744) shows pipelining erasure-code stages across the
storage path recovers most of the serial-stage loss, and the XOR-EC
program-optimization results (arXiv:2108.02692) show the codec stops
being the bottleneck once stages overlap — the same
overlap-compute-with-I/O shape every accelerator input pipeline uses.

``Prefetch`` runs a source iterator on ONE worker thread and hands its
items to the consumer in order through a bounded queue:

- memory is strictly bounded: with depth ``d`` the queue holds ``d-1``
  items, the producer holds at most one finished item while blocked on
  a full queue, and the consumer holds the one it is processing — so at
  most ``d+1`` items are ever alive (asserted by tests/test_pipeline.py);
- backpressure propagates: a slow consumer blocks the producer at the
  queue (defer = drain the pipeline, don't grow it — a background-lane
  heal deferring its kernel dispatch therefore stalls production, it
  never accumulates);
- errors propagate in stream order: an exception raised by the source
  is re-raised at the consumer exactly after the items produced before
  it; a consumer that stops early ``close()``s the pipeline, which
  unblocks and stops the worker;
- QoS context crosses the thread: the request deadline and dispatch
  lane (qos/deadline.py, qos/scheduler.py) are captured at construction
  and re-entered on the worker, so a pipelined heal still dispatches in
  the background lane and a pipelined PUT stays deadline-capped.

Observability: every pipeline registers its depth on the
``minio_tpu_v2_pipeline_depth`` gauge, accumulates blocked time per
stage on ``minio_tpu_v2_pipeline_stall_seconds_total`` (stage=produce:
the worker waited on a full queue; stage=consume: the consumer waited
on an empty one), and stalls above ``STALL_EVENT_S`` land as events on
the active trace span — so `mc admin trace` shows exactly where a
pipelined request lost its overlap. ``PIPE_STATS`` aggregates per-run
busy/stall/wall seconds so bench.py can print an overlap factor
(sum of stage busy time / wall time; > 1.0 means stages truly ran
concurrently).

The port's own copy of ``minio_tpu/utils/pipeline.py``, with no change in
behaviour.
"""

from __future__ import annotations

import queue
import threading
import time

# Default number of in-flight items (the depth knob: 2-3).
DEFAULT_DEPTH = 2

# Stalls shorter than this are accounted in metrics but not worth a
# span event (they would flood the bounded per-span event list).
STALL_EVENT_S = 0.005

_END = object()  # sentinel type marker for the end-of-stream record


class PipelineStats:
    """Thread-safe per-pipeline aggregate of run timings (bench + tests
    read this to compute overlap factors)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._by_name: dict[str, dict] = {}

    def record(self, name: str, *, items: int, produce_s: float,
               produce_stall_s: float, consume_s: float,
               consume_stall_s: float, wall_s: float) -> None:
        with self._mu:
            d = self._by_name.setdefault(name, {
                "runs": 0, "items": 0, "produce_s": 0.0,
                "produce_stall_s": 0.0, "consume_s": 0.0,
                "consume_stall_s": 0.0, "wall_s": 0.0})
            d["runs"] += 1
            d["items"] += items
            d["produce_s"] += produce_s
            d["produce_stall_s"] += produce_stall_s
            d["consume_s"] += consume_s
            d["consume_stall_s"] += consume_stall_s
            d["wall_s"] += wall_s

    def snapshot(self) -> dict:
        with self._mu:
            return {k: dict(v) for k, v in self._by_name.items()}

    def reset(self) -> None:
        with self._mu:
            self._by_name.clear()

    @staticmethod
    def overlap_factor(before: dict | None, after: dict,
                       name: str) -> float | None:
        """Overlap factor of pipeline `name` between two snapshots:
        (produce busy + consume busy) / wall. 1.0 = perfectly serial,
        > 1.0 = stages genuinely overlapped; None when the pipeline
        never ran (or ran zero items) in the interval."""
        b = (before or {}).get(name, {})
        a = after.get(name)
        if a is None:
            return None
        wall = a["wall_s"] - b.get("wall_s", 0.0)
        busy = (a["produce_s"] - b.get("produce_s", 0.0)
                + a["consume_s"] - b.get("consume_s", 0.0))
        if wall <= 0 or (a["items"] - b.get("items", 0)) <= 0:
            return None
        return busy / wall


PIPE_STATS = PipelineStats()


class Prefetch:
    """Run `source` on a worker thread, buffering at most depth-1
    finished items; iterate it from the consumer thread in order.
    Depth 1 is SERIAL: the source is pulled directly on the consumer
    thread with no worker at all.

    Also a context manager: exiting (or exhausting the iterator, or an
    error on either side) closes the pipeline — the worker stops, the
    queue drains, and the run's timings land in PIPE_STATS.
    """

    def __init__(self, source, depth: int = DEFAULT_DEPTH,
                 name: str = "pipeline", span=None):
        self.name = name
        self.depth = max(1, int(depth))
        # depth 1 = SERIAL: no worker, no queue — the consumer pulls
        # the source directly and at most 2 items are alive (the d+1
        # bound), so the knob really can dial the pipeline off on a
        # memory-constrained box.
        self._inline = self.depth <= 1
        self._q: queue.Queue = queue.Queue(maxsize=max(1, self.depth - 1))
        self._stop = threading.Event()
        self._source = iter(source)
        self._closed = False
        self._exhausted = False
        # Stall events attach to the span active where the pipeline was
        # built (the worker thread has no span contextvar of its own).
        from ..obs.span import TRACER
        self._span = span if span is not None else TRACER.current()
        # Timings (consumer-side fields touched only by the consumer,
        # producer-side only by the worker; merged at finish).
        self._t0 = time.perf_counter()
        self._items = 0
        self._produce_s = 0.0
        self._produce_stall_s = 0.0
        self._consume_s = 0.0
        self._consume_stall_s = 0.0
        self._t_returned: float | None = None
        self._finished = False
        from ..obs.metrics2 import METRICS2
        METRICS2.set_gauge("minio_tpu_v2_pipeline_depth",
                           {"pipeline": name}, self.depth)
        self._thread = None
        if not self._inline:
            # QoS context crosses the thread boundary through the
            # canonical ctx-wrap helper (qos/ctx.py — captured HERE on
            # the caller's thread, re-entered around _run on the
            # worker), the same carrier every R1-checked hop uses.
            from ..qos.ctx import ctx_wrap
            self._thread = threading.Thread(
                target=ctx_wrap(self._run), daemon=True,
                name=f"pipe-{name}")
            self._thread.start()

    # -- producer side (worker thread) ---------------------------------

    def _run(self) -> None:
        it = iter(self._source)
        end_exc: BaseException | None = None
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                self._produce_s += time.perf_counter() - t0
                if not self._put((None, item)):
                    return  # closed under us; no end marker needed
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            end_exc = e
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            self._put((_END, end_exc))

    def _put(self, record) -> bool:
        """Enqueue with backpressure; False when the pipeline closed
        while waiting (the record is dropped). Only time actually
        spent BLOCKED on a full queue counts as stall — an immediate
        put must not touch the metrics registry per item."""
        if self._stop.is_set():
            return False
        try:
            self._q.put_nowait(record)
            return True
        except queue.Full:
            pass
        waited = 0.0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self._q.put(record, timeout=0.1)
                waited += time.perf_counter() - t0
                self._note_stall("produce", waited)
                return True
            except queue.Full:
                waited += time.perf_counter() - t0
        return False

    # -- consumer side --------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted or self._closed:
            raise StopIteration
        now = time.perf_counter()
        if self._t_returned is not None:
            self._consume_s += now - self._t_returned
        if self._inline:
            t0 = time.perf_counter()
            try:
                payload = next(self._source)
            except BaseException:  # incl. StopIteration: exhausted
                self._exhausted = True
                self._finish()
                raise
            self._produce_s += time.perf_counter() - t0
            self._items += 1
            self._t_returned = time.perf_counter()
            return payload
        try:
            kind, payload = self._q.get_nowait()
            waited = 0.0
        except queue.Empty:
            waited = 0.0
            record = None
            while record is None:
                t0 = time.perf_counter()
                try:
                    record = self._q.get(timeout=0.25)
                    waited += time.perf_counter() - t0
                except queue.Empty:
                    waited += time.perf_counter() - t0
                    if not self._thread.is_alive():
                        # The worker exited. It may have enqueued its
                        # end record BETWEEN our timeout and this
                        # liveness check — drain once more before
                        # concluding (dropping that record would turn
                        # a mid-stream producer error into silent
                        # clean exhaustion). A dead worker with an
                        # empty queue means interpreter teardown ate
                        # the finally — don't hang.
                        try:
                            record = self._q.get_nowait()
                        except queue.Empty:
                            self._exhausted = True
                            self._finish()
                            raise StopIteration
            kind, payload = record
        if waited > 0:
            self._note_stall("consume", waited)
        if kind is _END:
            self._exhausted = True
            self._finish()
            if payload is not None:
                raise payload
            raise StopIteration
        self._items += 1
        self._t_returned = time.perf_counter()
        return payload

    def close(self) -> None:
        """Stop the worker and release everything queued. Idempotent;
        safe after exhaustion (then it only finalizes stats).

        The join is a short grace, not a guarantee: a worker blocked
        inside a source read (a stalled client mid-batch) cannot be
        interrupted, and blocking the caller on it would delay the
        error response behind the client's own stall. An abandoned
        worker consumes at most its current item (the stop flag is
        checked before every next one), drops it, and exits; callers
        whose source is a request body rely on LimitReader's atomic
        reads to keep connection framing exact through that window."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._inline:
            close = getattr(self._source, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            self._finish()
            return
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=0.5)
        self._finish()

    def __enter__(self) -> "Prefetch":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- accounting ------------------------------------------------------

    def _note_stall(self, stage: str, seconds: float) -> None:
        if stage == "produce":
            self._produce_stall_s += seconds
        else:
            self._consume_stall_s += seconds
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_pipeline_stall_seconds_total",
                     {"pipeline": self.name, "stage": stage}, seconds)
        if seconds >= STALL_EVENT_S and self._span is not None:
            self._span.add_event("pipeline.stall", pipeline=self.name,
                                 stage=stage,
                                 ms=round(seconds * 1e3, 3))

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        PIPE_STATS.record(
            self.name, items=self._items, produce_s=self._produce_s,
            produce_stall_s=self._produce_stall_s,
            consume_s=self._consume_s,
            consume_stall_s=self._consume_stall_s,
            wall_s=time.perf_counter() - self._t0)
