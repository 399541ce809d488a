"""QoS: the two-priority dispatch gate (scheduler.py), request deadlines
(deadline.py) and the thread-hop context carrier (ctx.py). Admission
control from ``minio_tpu/qos`` is not ported yet."""
