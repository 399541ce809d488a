"""Structured logging, console ring, audit webhook (ref cmd/logger/).

The port's own copy of ``minio_tpu/logger/__init__.py``, with no change in
behaviour.
"""

from .logger import ConsoleLogRing, LogEntry, Logger  # noqa: F401
