"""QoS: the two-priority dispatch gate (scheduler.py). Admission
control and deadlines from ``minio_tpu/qos`` are not ported yet."""
