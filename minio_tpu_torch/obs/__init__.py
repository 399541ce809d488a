"""Observability: span tracing (span.py), the metrics-v2 registry
(metrics2.py), kernel accounting (kernel_stats.py), the per-dispatch
profiler with per-lane health (kernprof.py) and the per-drive health
monitor (drivemon.py). The rest of ``minio_tpu/obs`` (timeline,
watchdog, incidents) is not ported yet."""
