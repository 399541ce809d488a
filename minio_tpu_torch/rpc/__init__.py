"""Cluster RPC fabric: storage REST (remote StorageAPI), dsync lock
service, peer control plane — HTTP/1.1 with HMAC node auth, one port per
node alongside the S3 API (ref cmd/routers.go:26-37 internal routers,
cmd/storage-rest-server.go, pkg/dsync).

The port's own copy of ``minio_tpu/rpc/__init__.py``, with no change in
behaviour."""
