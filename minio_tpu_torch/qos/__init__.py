"""QoS subsystem: admission control, deadline propagation, and
priority-aware TPU dispatch.

Three cooperating pieces, wired through the whole stack:

- ``admission``: per-API-class (read/write/list/admin) concurrency caps
  with a bounded FIFO wait queue — the analog of the reference's
  maxClients middleware (`MINIO_API_REQUESTS_MAX` /
  `MINIO_API_REQUESTS_DEADLINE`, cmd/generic-handlers.go) extended with
  per-class overrides so a write flood cannot starve reads.
- ``deadline``: a per-request time budget opened at the S3 handler and
  propagated as an ``x-mtpu-deadline-ms`` header across storage/peer
  RPC, so a nearly-expired request cancels remote shard I/O instead of
  burning peer capacity.
- ``scheduler``: two-priority dispatch lanes for the batching layer —
  background heal/crawler/scanner kernel work yields the coalescing
  window to foreground encode/verify, with aging so background is
  deferred, never starved (the foreground/background interference that
  online-EC studies identify as the dominant tail-latency source,
  arXiv:1709.05365; RapidRAID pipelines repair off the critical path,
  arXiv:1207.6744).

The port's own copy of ``minio_tpu/qos/__init__.py``, with no change in
behaviour.
"""

from . import admission, ctx, deadline, scheduler  # noqa: F401
