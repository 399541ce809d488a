"""S3-compatible API surface: SigV4 auth, routers, handlers, XML wire
format, error codes (ref cmd/api-router.go, cmd/object-handlers.go,
cmd/signature-v4.go).

The port's own copy of ``minio_tpu/s3/__init__.py``, with no change in
behaviour."""
