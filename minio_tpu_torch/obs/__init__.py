"""Observability: span tracing (span.py), the metrics-v2 registry
(metrics2.py) and kernel accounting (kernel_stats.py). The rest of
``minio_tpu/obs`` (kernprof, timeline, watchdog, incidents) is not
ported yet."""
