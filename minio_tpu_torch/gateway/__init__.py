"""Gateway backends: serve the S3 API over foreign storage (ref
Gateway interface, cmd/gateway-interface.go:34 — NewGatewayLayer(creds)
returns an ObjectLayer; backends cmd/gateway/{nas,s3,...}).

The port's own copy of ``minio_tpu/gateway/__init__.py``, with no change in
behaviour.
"""

from .cloud import AzureGateway, GCSGateway, HDFSGateway  # noqa: F401
from .nas import NASGateway  # noqa: F401
from .s3 import S3Gateway  # noqa: F401
