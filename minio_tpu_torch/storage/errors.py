"""Storage error taxonomy (ref cmd/storage-errors.go).

The port's own copy of ``minio_tpu/storage/errors.py``, with no change in
behaviour.
"""


class StorageError(Exception):
    """Base class for per-disk storage errors."""


class DiskNotFound(StorageError):
    """Disk is offline or gone (ref errDiskNotFound)."""


class FaultyDisk(StorageError):
    """Disk returned an unexpected I/O error (ref errFaultyDisk)."""


class VolumeNotFound(StorageError):
    """Bucket/volume does not exist (ref errVolumeNotFound)."""


class VolumeExists(StorageError):
    """Volume already exists (ref errVolumeExists)."""


class FileNotFound(StorageError):
    """Object/file does not exist (ref errFileNotFound)."""


class VersionNotFound(StorageError):
    """Requested version does not exist (ref errFileVersionNotFound)."""


class FileCorrupt(StorageError):
    """File failed bitrot/format validation (ref errFileCorrupt)."""


class RegenRepairFailed(StorageError):
    """Regenerating-code (REGEN) repair could not complete: the
    minimum-bandwidth helper collection fell short AND the conventional
    any-k fallback had fewer than k readable chunks.  Retryable — a
    flapping helper may answer the next heal pass."""


class DiskFull(StorageError):
    """No space left (ref errDiskFull)."""


class DriveQuarantined(StorageError):
    """Write/read skipped because the drive is quarantined by the
    health monitor (obs/drivemon.py) — a bookkeeping marker for the
    degraded-write path, not evidence from the drive itself."""
