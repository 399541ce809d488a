"""The canonical thread-boundary QoS context carrier.

Deadlines (``qos.deadline``) and dispatch lanes (``qos.scheduler``)
live in contextvars, which do NOT cross threads: any
``Thread(target=...)`` or executor ``submit`` on a request path would
silently run deadline-uncapped and lane-untagged on the far side of
the hop. ``ctx_wrap`` captures both on the calling thread and re-enters
them around the callable on the worker.

This used to live as ``parallel/quorum._qos_ctx_wrap`` (grown for the
quorum pool in PR 2's post-review hardening) with an ad-hoc copy in
``utils/pipeline.Prefetch``; it is promoted here — and both call sites
now delegate — because lint rule R1 (tools/mtpu_lint) REQUIRES every
thread hop inside ``minio_tpu/`` to route through it: one helper, one
name the AST rule can see.

The port's own copy of ``minio_tpu/qos/ctx.py``, with no change in
behaviour.
"""

from __future__ import annotations

from typing import Callable

from . import deadline as _dl
from . import scheduler as _sched


def ctx_wrap(fn: Callable) -> Callable:
    """Carry the caller's QoS context — request deadline and dispatch
    lane — onto whatever thread eventually runs ``fn``. Returns ``fn``
    unchanged on the default context (no wrap overhead)."""
    ddl = _dl.current_deadline()
    lane = _sched.current_lane()
    if ddl is None and lane == _sched.FOREGROUND:
        return fn

    def wrapped(*a, **kw):
        with _dl.deadline_scope(ddl), _sched.lane_scope(lane):
            return fn(*a, **kw)
    return wrapped
