"""Configuration subsystems (ref cmd/config/ tree).

The port's own copy of ``minio_tpu/config/__init__.py``, with no change in
behaviour.
"""
