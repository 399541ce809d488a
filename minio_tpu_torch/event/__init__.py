"""Bucket event notification subsystem (ref pkg/event/: Target
interface targetlist.go:25, event names event.go, arn.go; fired from the
S3 handlers via NotificationSys, cmd/notification.go:48).

The port's own copy of ``minio_tpu/event/__init__.py``, with no change in
behaviour."""
