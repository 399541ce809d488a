"""Identity & access: users, groups, canned policies, AWS-compatible
policy evaluation, STS temporary credentials (ref cmd/iam.go:204 IAMSys,
pkg/iam/policy, cmd/sts-handlers.go).

The port's own copy of ``minio_tpu/iam/__init__.py``, with no change in
behaviour."""
