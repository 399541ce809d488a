"""The port's own copy of ``minio_tpu/listing/__init__.py``, with no change in
behaviour."""

from .metacache import MetacacheManager

__all__ = ["MetacacheManager"]
