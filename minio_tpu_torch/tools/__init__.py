"""Tools that drive a port node from outside: the load generator
(``python -m minio_tpu_torch.tools.loadgen``).

The counterparts of the JAX system's ``tools/`` that a run of the port
needs, with no import of JAX or of the JAX package."""
