"""Background data scanner: usage accounting, lifecycle enforcement,
heal sampling (ref cmd/data-crawler.go, cmd/data-usage-cache.go).

The port's own copy of ``minio_tpu/scanner/__init__.py``, with no change in
behaviour.
"""
