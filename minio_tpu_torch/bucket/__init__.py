"""Per-bucket metadata: versioning, policy, tagging, lifecycle,
notification, encryption, quota, object-lock, replication configs.

The port's own copy of ``minio_tpu/bucket/__init__.py``, with no change in
behaviour."""
