"""NAS gateway: the S3 front end over one POSIX mount (ref
cmd/gateway/nas/gateway-nas.go, 121 LoC — it literally returns the FS
ObjectLayer over the given path; so do we).

The port's own copy of ``minio_tpu/gateway/nas.py``, with no change in
behaviour but the device seam: ``NASGateway(path, device=...)`` passes
its device to ``FSObjects``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from ..fs.backend import FSObjects


class NASGateway:
    name = "nas"

    def __init__(self, path: str, *, device="cuda"):
        self.path = path
        self.device = device

    def new_gateway_layer(self):
        return FSObjects(self.path, device=self.device)
