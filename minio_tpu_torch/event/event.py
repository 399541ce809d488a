"""S3 event records and event-name matching.

Ref pkg/event/event.go (Event struct, the AWS event-record JSON shape)
and pkg/event/name.go (Name enum + expansion: "s3:ObjectCreated:*"
expands to every ObjectCreated sub-event).

The port's own copy of ``minio_tpu/event/event.py``, with no change in
behaviour.
"""

from __future__ import annotations

import time
import urllib.parse
from dataclasses import dataclass, field

# Canonical event names (subset actively fired; ref pkg/event/name.go).
OBJECT_CREATED_PUT = "s3:ObjectCreated:Put"
OBJECT_CREATED_POST = "s3:ObjectCreated:Post"
OBJECT_CREATED_COPY = "s3:ObjectCreated:Copy"
OBJECT_CREATED_COMPLETE_MULTIPART = \
    "s3:ObjectCreated:CompleteMultipartUpload"
OBJECT_ACCESSED_GET = "s3:ObjectAccessed:Get"
OBJECT_ACCESSED_HEAD = "s3:ObjectAccessed:Head"
OBJECT_REMOVED_DELETE = "s3:ObjectRemoved:Delete"
OBJECT_REMOVED_DELETE_MARKER = "s3:ObjectRemoved:DeleteMarkerCreated"

_EXPANSIONS = {
    "s3:ObjectCreated:*": [
        OBJECT_CREATED_PUT, OBJECT_CREATED_POST, OBJECT_CREATED_COPY,
        OBJECT_CREATED_COMPLETE_MULTIPART,
    ],
    "s3:ObjectAccessed:*": [OBJECT_ACCESSED_GET, OBJECT_ACCESSED_HEAD],
    "s3:ObjectRemoved:*": [OBJECT_REMOVED_DELETE,
                           OBJECT_REMOVED_DELETE_MARKER],
}


def expand_event_name(name: str) -> list[str]:
    """'s3:ObjectCreated:*' -> every concrete ObjectCreated event
    (ref pkg/event/name.go Expand)."""
    return list(_EXPANSIONS.get(name, [name]))


@dataclass
class Event:
    """One S3 notification record (ref pkg/event/event.go:77 Event)."""
    event_name: str
    bucket: str
    key: str
    size: int = 0
    etag: str = ""
    version_id: str = ""
    region: str = "us-east-1"
    user_identity: str = ""
    sequencer: str = ""
    event_time: float = field(default_factory=time.time)

    def to_record(self) -> dict:
        """The AWS-compatible record JSON shape."""
        t = time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                          time.gmtime(self.event_time))
        obj = {
            "key": urllib.parse.quote(self.key),
            "sequencer": self.sequencer or
            format(int(self.event_time * 1e9), "X"),
        }
        if not self.event_name.startswith("s3:ObjectRemoved:"):
            obj["size"] = self.size
            obj["eTag"] = self.etag
        if self.version_id:
            obj["versionId"] = self.version_id
        return {
            "eventVersion": "2.0",
            "eventSource": "minio-tpu:s3",
            "awsRegion": self.region,
            "eventTime": t,
            "eventName": self.event_name,
            "userIdentity": {"principalId": self.user_identity},
            "s3": {
                "s3SchemaVersion": "1.0",
                "bucket": {
                    "name": self.bucket,
                    "arn": f"arn:aws:s3:::{self.bucket}",
                    "ownerIdentity": {
                        "principalId": self.user_identity},
                },
                "object": obj,
            },
        }
