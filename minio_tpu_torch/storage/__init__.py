"""Per-disk storage: the StorageAPI contract, local POSIX implementation
(xl-storage analog), and on-disk metadata formats.

The port's own copy of ``minio_tpu/storage/__init__.py``, with no change
in behaviour.
"""
