"""S3 API error codes and XML error responses (ref cmd/api-errors.go —
the reference carries ~400 codes; this registry holds the actively-used
subset and grows with the handlers).

The port's own copy of ``minio_tpu/s3/errors.py``, with no change in
behaviour."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class APIError(Exception):
    # NOT frozen: contextlib's generator-contextmanager __exit__ assigns
    # exc.__traceback__ in pure Python, which a frozen dataclass rejects
    # (FrozenInstanceError shadowing the real error).
    code: str
    description: str
    http_status: int
    # Throttling family: seconds the client should back off before
    # retrying; rendered as a Retry-After response header (ref the
    # reference's 503 SlowDown responses, cmd/generic-handlers.go).
    retry_after: int | None = None

    def xml(self, resource: str = "", request_id: str = "") -> bytes:
        from .xmlutil import Element
        e = Element("Error")
        e.child("Code", self.code)
        e.child("Message", self.description)
        e.child("Resource", resource)
        e.child("RequestId", request_id)
        return e.tobytes()

    def headers(self) -> dict[str, str]:
        """Extra response headers this error carries."""
        if self.retry_after is not None:
            return {"Retry-After": str(self.retry_after)}
        return {}

    def with_retry_after(self, seconds: int) -> "APIError":
        """A copy carrying a Retry-After hint (module-level error
        singletons stay immutable-in-practice)."""
        return APIError(self.code, self.description, self.http_status,
                        retry_after=max(1, int(seconds)))


def _e(code: str, desc: str, status: int) -> APIError:
    return APIError(code, desc, status)


ERR_ACCESS_DENIED = _e("AccessDenied", "Access Denied.", 403)
ERR_BAD_DIGEST = _e("BadDigest",
                    "The Content-Md5 you specified did not match what we "
                    "received.", 400)
ERR_BUCKET_ALREADY_EXISTS = _e(
    "BucketAlreadyOwnedByYou",
    "Your previous request to create the named bucket succeeded and you "
    "already own it.", 409)
ERR_BUCKET_NOT_EMPTY = _e("BucketNotEmpty",
                          "The bucket you tried to delete is not empty.",
                          409)
ERR_NO_SUCH_BUCKET = _e("NoSuchBucket",
                        "The specified bucket does not exist.", 404)
ERR_NO_SUCH_KEY = _e("NoSuchKey", "The specified key does not exist.", 404)
ERR_NO_SUCH_VERSION = _e(
    "NoSuchVersion",
    "Indicates that the version ID specified in the request does not "
    "match an existing version.", 404)
ERR_NO_SUCH_UPLOAD = _e(
    "NoSuchUpload",
    "The specified multipart upload does not exist.", 404)
ERR_INVALID_BUCKET_NAME = _e("InvalidBucketName",
                             "The specified bucket is not valid.", 400)
ERR_INVALID_ARGUMENT = _e("InvalidArgument", "Invalid Argument", 400)
ERR_INVALID_RANGE = _e("InvalidRange",
                       "The requested range is not satisfiable", 416)
ERR_INVALID_PART = _e(
    "InvalidPart",
    "One or more of the specified parts could not be found.", 400)
ERR_INVALID_PART_ORDER = _e(
    "InvalidPartOrder",
    "The list of parts was not in ascending order.", 400)
ERR_ENTITY_TOO_SMALL = _e(
    "EntityTooSmall",
    "Your proposed upload is smaller than the minimum allowed object "
    "size.", 400)
ERR_ENTITY_TOO_LARGE = _e(
    "EntityTooLarge",
    "Your proposed upload exceeds the maximum allowed object size.", 400)
ERR_METHOD_NOT_ALLOWED = _e(
    "MethodNotAllowed",
    "The specified method is not allowed against this resource.", 405)
ERR_MALFORMED_XML = _e(
    "MalformedXML",
    "The XML you provided was not well-formed or did not validate "
    "against our published schema.", 400)
ERR_MISSING_CONTENT_LENGTH = _e("MissingContentLength",
                                "You must provide the Content-Length HTTP "
                                "header.", 411)
ERR_INTERNAL_ERROR = _e(
    "InternalError",
    "We encountered an internal error, please try again.", 500)
ERR_SLOW_DOWN = _e("SlowDown", "Please reduce your request rate", 503)
ERR_SERVICE_UNAVAILABLE = _e(
    "ServiceUnavailable",
    "The service is unavailable. Please retry.", 503)
ERR_REQUEST_TIMEOUT = _e(
    "RequestTimeout",
    "A timeout occurred while trying to process the request, please "
    "reduce your request rate", 503)
ERR_NOT_IMPLEMENTED = _e("NotImplemented",
                         "A header you provided implies functionality "
                         "that is not implemented", 501)
ERR_PARENT_IS_OBJECT = _e(
    "XMinioParentIsObject",
    "Object-prefix is already an object, please choose a different "
    "object-prefix name.", 400)
ERR_SIGNATURE_DOES_NOT_MATCH = _e(
    "SignatureDoesNotMatch",
    "The request signature we calculated does not match the signature "
    "you provided. Check your key and signing method.", 403)
ERR_INVALID_ACCESS_KEY_ID = _e(
    "InvalidAccessKeyId",
    "The Access Key Id you provided does not exist in our records.", 403)
ERR_MISSING_AUTH = _e(
    "AccessDenied", "Request is missing authentication credentials.", 403)
ERR_REQUEST_TIME_TOO_SKEWED = _e(
    "RequestTimeTooSkewed",
    "The difference between the request time and the server's time is "
    "too large.", 403)
ERR_AUTHORIZATION_HEADER_MALFORMED = _e(
    "AuthorizationHeaderMalformed",
    "The authorization header is malformed.", 400)
ERR_EXPIRED_PRESIGN = _e("AccessDenied", "Request has expired", 403)
ERR_PRECONDITION_FAILED = _e(
    "PreconditionFailed",
    "At least one of the pre-conditions you specified did not hold", 412)
ERR_NO_SUCH_BUCKET_POLICY = _e(
    "NoSuchBucketPolicy", "The bucket policy does not exist", 404)
ERR_NO_SUCH_TAG_SET = _e("NoSuchTagSet",
                         "The TagSet does not exist", 404)
ERR_NO_SUCH_LIFECYCLE = _e(
    "NoSuchLifecycleConfiguration",
    "The lifecycle configuration does not exist", 404)
ERR_NO_SUCH_LIFECYCLE_CONFIG = ERR_NO_SUCH_LIFECYCLE
ERR_MALFORMED_POLICY = _e(
    "MalformedPolicy", "Policy has invalid resource", 400)
ERR_NO_SUCH_SSE_CONFIG = _e(
    "ServerSideEncryptionConfigurationNotFoundError",
    "The server side encryption configuration was not found", 404)
ERR_NO_SUCH_OBJECT_LOCK_CONFIG = _e(
    "ObjectLockConfigurationNotFoundError",
    "Object Lock configuration does not exist for this bucket", 404)
ERR_NO_SUCH_REPLICATION_CONFIG = _e(
    "ReplicationConfigurationNotFoundError",
    "The replication configuration was not found", 404)
ERR_NO_SUCH_CORS_CONFIG = _e(
    "NoSuchCORSConfiguration",
    "The CORS configuration does not exist", 404)
ERR_SSE_KEY_REQUIRED = _e(
    "InvalidRequest",
    "The object was stored using a form of Server Side Encryption. The "
    "correct parameters must be provided to retrieve the object.", 400)
ERR_SSE_KEY_MISMATCH = _e(
    "AccessDenied",
    "The calculated MD5 hash of the key did not match the hash that "
    "was provided.", 403)
ERR_INVALID_SSE_PARAMS = _e(
    "InvalidArgument",
    "Invalid server side encryption parameters", 400)
ERR_INVALID_BUCKET_STATE = _e(
    "InvalidBucketState",
    "Object Lock configuration cannot be enabled on existing buckets", 409)
ERR_OBJECT_LOCKED = _e(
    "AccessDenied",
    "Object is WORM protected and cannot be overwritten or deleted", 403)
ERR_PAST_OBJECT_LOCK_RETAIN_DATE = _e(
    "InvalidRequest",
    "the retain until date must be in the future", 400)
ERR_INVALID_RETENTION_MODE = _e(
    "InvalidRequest",
    "invalid retention mode, expected GOVERNANCE or COMPLIANCE", 400)
ERR_NO_SUCH_RETENTION = _e(
    "NoSuchObjectLockConfiguration",
    "The specified object does not have a ObjectLock configuration", 404)
ERR_INVALID_STORAGE_CLASS = _e(
    "InvalidStorageClass", "Invalid storage class.", 400)
ERR_QUOTA_EXCEEDED = _e(
    "QuotaExceeded", "Bucket quota exceeded", 409)
ERR_STORAGE_FULL = _e(
    "XMinioStorageFull",
    "Storage backend has reached its minimum free disk threshold. "
    "Please delete a few objects to proceed.", 507)
ERR_OBJECT_CORRUPT = _e(
    "XMinioObjectCorrupted",
    "The object failed integrity verification and could not be "
    "reconstructed from parity.", 500)


# Safety-net mapping for per-disk storage errors that escape the engine
# (ref cmd/object-api-errors.go toObjectErr + cmd/api-errors.go
# toAPIErrorCode). The engine normally reduces per-disk errors into its
# own typed errors (ObjectNotFound, BucketNotFound, ...) which handlers
# map individually; a raw StorageError reaching the top-level handler
# used to answer an opaque 500 InternalError — this map keeps the
# 404/409/503 retry semantics instead. Lint rule R5 (tools/mtpu_lint)
# enforces that every storage/errors.py exception class has an entry,
# so the safety net stays total as the taxonomy grows. (storage/errors
# imports nothing, so this import cannot cycle.)
from ..storage.errors import (DiskFull, DiskNotFound,  # noqa: E402
                              DriveQuarantined, FaultyDisk, FileCorrupt,
                              FileNotFound, RegenRepairFailed,
                              StorageError, VersionNotFound,
                              VolumeExists, VolumeNotFound)

STORAGE_ERROR_MAP = {
    StorageError: ERR_INTERNAL_ERROR,
    DiskNotFound: ERR_SLOW_DOWN,
    FaultyDisk: ERR_SLOW_DOWN,
    VolumeNotFound: ERR_NO_SUCH_BUCKET,
    VolumeExists: ERR_BUCKET_ALREADY_EXISTS,
    FileNotFound: ERR_NO_SUCH_KEY,
    VersionNotFound: ERR_NO_SUCH_VERSION,
    FileCorrupt: ERR_OBJECT_CORRUPT,
    DiskFull: ERR_STORAGE_FULL,
    # A quarantine marker surfacing alone means the engine could not
    # find enough healthy drives either — retryable unavailability.
    DriveQuarantined: ERR_SLOW_DOWN,
    # A failed REGEN repair is a transient helper shortfall, not data
    # loss: the object still decodes from any k nodes.
    RegenRepairFailed: ERR_SLOW_DOWN,
}


def storage_api_error(exc: BaseException) -> APIError | None:
    """The typed S3 APIError for a storage-layer exception, walking the
    MRO so subclasses inherit their base mapping; None for non-storage
    errors."""
    if not isinstance(exc, StorageError):
        return None
    for cls in type(exc).__mro__:
        if cls in STORAGE_ERROR_MAP:
            return STORAGE_ERROR_MAP[cls]
    return ERR_INTERNAL_ERROR
