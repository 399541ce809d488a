"""Observability: span-based request tracing (span.py), the metrics-v2
registry with node/cluster Prometheus endpoints (metrics2.py), kernel
accounting (kernel_stats.py), per-dispatch kernel profiling + lane
health (kernprof.py), the per-drive health monitor (drivemon.py), the
cluster timeline sample ring (timeline.py), and the SLO watchdog +
incident recorder (watchdog.py, incidents.py).

The port's own copy of ``minio_tpu/obs/__init__.py``, with the same
exports."""

from .incidents import INCIDENTS
from .kernel_stats import KERNEL
from .kernprof import KERNPROF
from .metrics2 import METRICS2
from .span import TRACER, current_span
from .timeline import TIMELINE
from .watchdog import WATCHDOG

__all__ = ["INCIDENTS", "KERNEL", "KERNPROF", "METRICS2", "TIMELINE",
           "TRACER", "WATCHDOG", "current_span"]
