"""Per-request deadline budgets (ref the reference's
`MINIO_API_REQUESTS_DEADLINE` + context deadlines threaded through its
storage REST client, cmd/storage-rest-client.go).

A ``Deadline`` is an absolute expiry opened at the S3 handler from
`api.requests_deadline`; every phase below shares it through a
contextvar, so the budget decrements naturally as phases consume wall
time. RPC clients forward the REMAINING budget as an
``x-mtpu-deadline-ms`` header and cap their socket timeout to it; the
RPC server refuses already-expired work outright — a request that can
no longer answer its client must not keep burning peer capacity.

The port's own copy of ``minio_tpu/qos/deadline.py``, with no change in
behaviour.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

# Remaining-budget header on internal RPC (milliseconds, float ok).
H_DEADLINE = "x-mtpu-deadline-ms"

_current: contextvars.ContextVar["Deadline | None"] = \
    contextvars.ContextVar("minio_tpu_deadline", default=None)


class DeadlineExceeded(TimeoutError):
    """The request's time budget ran out (maps to 503 RequestTimeout
    at the S3 boundary; a named wire error across RPC)."""


class Deadline:
    """An absolute expiry on the monotonic clock."""

    __slots__ = ("expires_at", "budget_s")

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.expires_at = time.monotonic() + budget_s

    @classmethod
    def from_remaining_ms(cls, ms: float) -> "Deadline":
        return cls(ms / 1e3)

    def remaining(self) -> float:
        """Seconds left; <= 0 when expired."""
        return self.expires_at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining() * 1e3

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, where: str = "") -> None:
        """Raise DeadlineExceeded (recording the event) when expired."""
        if self.expired():
            record_expiry(where)
            raise DeadlineExceeded(
                f"request deadline exceeded ({where or 'unspecified'}, "
                f"budget {self.budget_s:.3f}s)")


def current_deadline() -> Deadline | None:
    return _current.get()


@contextlib.contextmanager
def deadline_scope(dl: Deadline | None):
    """Make `dl` the context's deadline (None clears — background work
    spawned from a request must not inherit the request's budget)."""
    token = _current.set(dl)
    try:
        yield dl
    finally:
        _current.reset(token)


def open_deadline(budget_s: float):
    """Scope a fresh budget; budget <= 0 means no deadline."""
    return deadline_scope(Deadline(budget_s) if budget_s > 0 else None)


def record_expiry(where: str) -> None:
    """Account a deadline expiry: metrics counter + a span event on the
    request's trace tree (PR-1 observability contract)."""
    from ..obs.metrics2 import METRICS2
    from ..obs.span import current_span
    METRICS2.inc("minio_tpu_v2_qos_deadline_expired_total",
                 {"where": where or "unspecified"})
    span = current_span()
    if span is not None:
        span.add_event("qos.deadline_expired", where=where)


def parse_duration(raw: str) -> float:
    """'250ms' / '10s' / '1m' / bare seconds -> seconds (the config-KV
    duration syntax the reference accepts for requests_deadline)."""
    s = raw.strip().lower()
    if not s:
        return 0.0
    for suffix, mult in (("ms", 1e-3), ("s", 1.0), ("m", 60.0),
                         ("h", 3600.0)):
        if s.endswith(suffix) and s[: -len(suffix)]:
            try:
                return float(s[: -len(suffix)]) * mult
            except ValueError:
                break
    return float(s)
