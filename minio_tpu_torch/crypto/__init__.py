"""Server-side encryption (ref cmd/crypto/, cmd/encryption-v1.go).

The port's own copy of ``minio_tpu/crypto/__init__.py``, with no change in
behaviour.
"""
