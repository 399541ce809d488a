"""The port's own copy of ``minio_tpu/fs/__init__.py``, with no change in
behaviour."""

from .backend import FSObjects

__all__ = ["FSObjects"]
