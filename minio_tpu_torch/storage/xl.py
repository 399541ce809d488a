"""XLStorage — local POSIX StorageAPI (ref cmd/xl-storage.go).

On-disk layout per disk root (same shape as the reference):

    <root>/.minio.sys/tmp/<uuid>/...       staging for in-flight writes
    <root>/<bucket>/<object>/xl.meta       version metadata (JSON, metadata.py)
    <root>/<bucket>/<object>/<dataDir>/part.N   bitrot-wrapped shard files

Writes are crash-safe: tmp file + atomic replace (the reference's
reliable-rename pattern, cmd/os-reliable.go); object commit is
rename_data (ref cmd/xl-storage.go:1972). Every commit-path replace
goes through ONE blessed helper, :func:`commit_replace` (enforced by
mtpu-lint R7): by default it is fsync-less (page-cache crash window,
like the reference's default), and the ``storage fsync=on`` config-KV
knob routes the same helper through fsync-file + fsync-parent-dir for
power-cut durability at a measured latency cost (docs/robustness.md).

Crash consistency is TESTED, not assumed: rename_data hosts named
crash points (minio_tpu/faultinject crash kind) at the torn-state
boundaries — before the data-dir replace, between the replace and the
xl.meta merge, and after the meta write — which the subprocess harness
(tests/test_crash_consistency.py) arms to kill -9 the server
mid-commit and assert the restart invariants.

The port's own copy of ``minio_tpu/storage/xl.py``, with no change in
behaviour but one, the device seam: ``XLStorage(root, device=...)``
names where the drive's bitrot hashing runs, and ``verify_file`` (the
deep bitrot scan of the scanner and heal) passes it to every bitrot
call. The default ``"cuda"`` hashes on kernel K2; ``"cpu"`` runs K2's
plain version; ``"auto"`` routes as erasure/bitrot.py does. A drive on
``"cuda"`` without a card raises from ``verify_file``: it never hashes
on the host in the card's place.
"""

from __future__ import annotations

import errno
import os
import shutil
import time
import uuid

import torch

from . import errors as serr
from .interface import StorageAPI
from .metadata import XL_META_FILE, FileInfo, XLMeta
from ..erasure import bitrot
from ..faultinject import FAULTS
from ..obs.drivemon import DRIVEMON, is_drive_fault

# Named crash points on the per-disk commit (rename_data) — the three
# windows a process death leaves distinguishable on-disk state. The
# crash harness arms these with `after` counts to land the kill
# BETWEEN disks of one quorum fan-out.
CRASH_RENAME_PRE = FAULTS.register_crash_point(
    "xl.rename_data.pre_replace")
CRASH_RENAME_MID = FAULTS.register_crash_point(
    "xl.rename_data.post_replace")
CRASH_RENAME_POST = FAULTS.register_crash_point(
    "xl.rename_data.post_meta")
from ..obs.metrics2 import METRICS2
from ..obs.span import TRACER


class _DiskOp:
    """Per-disk-call instrumentation: a child span on the active trace
    (no-op when untraced), the metrics-v2 disk-op histogram, AND the
    drive-health monitor's per-drive latency/error accounting — the
    per-disk attribution layer of the request trace (the reference's
    storage layer exports xl_storage api latencies the same way in
    cmd/metrics-v2.go; per-drive health in pkg/smart / admin obd)."""

    __slots__ = ("op", "_cm", "_t0", "_disk")

    def __init__(self, op: str, disk: "XLStorage"):
        self.op = op
        self._disk = disk
        self._cm = TRACER.span("disk." + op, disk=disk.root)

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._cm.__enter__()
        # Fault-injection hook (minio_tpu/faultinject): injected
        # latency sleeps — and injected errors raise — INSIDE the
        # measured op window, exactly what a degraded physical drive
        # looks like to the monitor. A raise must still close the
        # span and feed the drive-health error accounting, so it is
        # routed through our own __exit__ before propagating.
        try:
            FAULTS.disk_op(self._disk.root, self.op)
        except BaseException as e:
            self.__exit__(type(e), e, e.__traceback__)
            raise
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)
        ms = (time.perf_counter() - self._t0) * 1e3
        METRICS2.observe("minio_tpu_v2_disk_op_duration_ms",
                         {"op": self.op}, ms)
        DRIVEMON.record(self._disk.root, self.op, ms,
                        error=bool(exc) and is_drive_fault(exc[0]))
        return False

MINIO_META_BUCKET = ".minio.sys"
TMP_DIR = ".minio.sys/tmp"
# Staging prefix inside the MINIO_META_BUCKET volume (engine + healer
# share this single source of truth).
TMP_PATH = "tmp"
# Recovery breadcrumb the engine drops into each staging dir (tiny
# JSON: bucket/object/versionId/dataDir): after a crash, the boot
# recovery sweep (storage/recovery.py) reads it to requeue the object
# for heal before GC-ing the orphaned stage.
INTENT_FILE = "intent.json"

_RESERVED_VOLUMES = {MINIO_META_BUCKET}

# `storage fsync=on` (config-KV; env MINIO_STORAGE_FSYNC): when True,
# commit_replace fsyncs the source (each file of a staged data dir)
# and the destination's parent directory around the rename, closing
# the power-cut window the fsync-less default leaves open. Process-
# wide on purpose — durability is a deployment property, not a
# per-call one.
FSYNC = False


def set_fsync(on: bool) -> None:
    """Flip the commit-path fsync policy (config apply hook)."""
    global FSYNC
    FSYNC = bool(on)


def _fsync_fd_of(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_src(path: str) -> None:
    """Flush a commit source: a staged data DIR syncs each shard file
    then the dir entries; a plain file syncs itself."""
    if os.path.isdir(path):
        for entry in os.scandir(path):
            if entry.is_file(follow_symlinks=False):
                _fsync_fd_of(entry.path)
        _fsync_fd_of(path)
    else:
        _fsync_fd_of(path)


def commit_replace(src: str, dst: str) -> None:
    """The ONE blessed commit-path rename (mtpu-lint R7): every
    os.replace/os.rename under minio_tpu/storage/ must route here, so
    the fsync policy — and any future commit-ordering change — has a
    single choke point instead of N hand-synced call sites.
    FileNotFoundError propagates unchanged (callers resolve it into
    their typed volume/race conditions)."""
    if FSYNC:
        _fsync_src(src)
    # mtpu-lint: disable=R7 -- the blessed helper itself; every other replace routes here
    os.replace(src, dst)
    if FSYNC:
        _fsync_fd_of(os.path.dirname(dst))


def _is_valid_volume(volume: str) -> bool:
    return (volume not in ("", ".", "..") and "/" not in volume
            and "\\" not in volume)


class XLStorage(StorageAPI):
    def __init__(self, root: str, *, device="cuda"):
        if not (isinstance(device, str) and device == bitrot.AUTO) and \
                torch.device(device).type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported bitrot device {device!r}")
        self.root = os.path.abspath(root)
        self.disk_id = ""
        self.device = device
        os.makedirs(os.path.join(self.root, TMP_DIR), exist_ok=True)

    def __repr__(self) -> str:
        return f"XLStorage({self.root})"

    # --- path helpers ---

    def _vol_path(self, volume: str) -> str:
        if not _is_valid_volume(volume) and volume != MINIO_META_BUCKET:
            raise serr.VolumeNotFound(volume)
        return os.path.join(self.root, volume)

    def _file_path(self, volume: str, path: str) -> str:
        base = self._vol_path(volume)
        full = os.path.normpath(os.path.join(base, path))
        if not full.startswith(base + os.sep) and full != base:
            raise serr.FileNotFound(path)  # path traversal
        return full

    def _check_vol(self, volume: str) -> str:
        p = self._vol_path(volume)
        if not os.path.isdir(p):
            if volume == MINIO_META_BUCKET:
                # The system volume self-creates (a freshly swapped disk
                # must accept heal writes immediately).
                os.makedirs(os.path.join(self.root, TMP_DIR),
                            exist_ok=True)
                return p
            raise serr.VolumeNotFound(volume)
        return p

    # --- identity / health ---

    def disk_info(self) -> dict:
        with _DiskOp("disk_info", self):
            st = os.statvfs(self.root)
        return {
            "total": st.f_blocks * st.f_frsize,
            "free": st.f_bavail * st.f_frsize,
            "used": (st.f_blocks - st.f_bfree) * st.f_frsize,
            "root": self.root,
            "id": self.disk_id,
        }

    def endpoint(self) -> str:
        return self.root

    # --- volumes ---

    def make_volume(self, volume: str) -> None:
        if not _is_valid_volume(volume):
            raise serr.VolumeNotFound(volume)
        p = os.path.join(self.root, volume)
        if os.path.isdir(p):
            raise serr.VolumeExists(volume)
        try:
            os.makedirs(p)
        except FileExistsError:
            # TOCTOU with a concurrent make_volume: same outcome as the
            # isdir check above.
            raise serr.VolumeExists(volume) from None

    def list_volumes(self) -> list[str]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name in _RESERVED_VOLUMES or name.startswith("."):
                continue
            if os.path.isdir(os.path.join(self.root, name)):
                out.append(name)
        return out

    def stat_volume(self, volume: str) -> dict:
        with _DiskOp("stat_volume", self):
            p = self._check_vol(volume)
            st = os.stat(p)
        return {"name": volume, "created": st.st_mtime}

    def delete_volume(self, volume: str, force: bool = False) -> None:
        if volume in _RESERVED_VOLUMES:
            raise serr.VolumeNotFound(f"{volume} is reserved")
        p = self._check_vol(volume)
        try:
            if force:
                shutil.rmtree(p)
            else:
                os.rmdir(p)
        except OSError as e:
            if e.errno == errno.ENOTEMPTY:
                raise serr.VolumeExists(f"{volume} not empty")
            raise serr.FaultyDisk(str(e))

    # --- flat files ---

    def _makedirs_for(self, volume: str, dirpath: str) -> None:
        """makedirs with the volume re-checked IMMEDIATELY before: an
        implicit mkdir on a write path must never resurrect a bucket
        volume that a racing delete_bucket just removed — otherwise a
        deleted bucket and a stored object/metadata write can both
        report success with the volume left on a random disk subset.
        (The microsecond residual window is absorbed by the engine's
        majority checks and heal sweeps.)"""
        self._check_vol(volume)
        try:
            os.makedirs(dirpath, exist_ok=True)
        except FileNotFoundError as e:
            # A parent vanished mid-walk (racing force delete-bucket
            # rmtree): re-check the volume — gone is the typed
            # bucket-deleted condition the engine maps to NoSuchBucket;
            # still present means the race interleaved mid-create, one
            # retry rebuilds the chain. A second ENOENT means the
            # volume is mid-rmtree right now: same typed condition.
            self._check_vol(volume)
            try:
                os.makedirs(dirpath, exist_ok=True)
            except FileNotFoundError:
                raise serr.VolumeNotFound(volume) from e

    def _atomic_write(self, full: str, data: bytes,
                      volume: str | None = None,
                      dir_ready: bool = False) -> None:
        """dir_ready: the caller created (or just verified) the target
        directory within this same storage call — skip the repeat
        stat/mkdir. The replace below still fails ENOENT if a racing
        delete removed the directory; that surfaces as FaultyDisk,
        same as any other mid-commit disk mutation."""
        if not dir_ready:
            if volume is not None:
                self._makedirs_for(volume, os.path.dirname(full))
            else:
                os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = os.path.join(self.root, TMP_DIR, str(uuid.uuid4()))
        try:
            try:
                f = open(tmp, "wb")
            except FileNotFoundError:
                # tmp dir wiped under us (disk swap mid-flight): the
                # system volume self-creates, then retry once.
                os.makedirs(os.path.dirname(tmp), exist_ok=True)
                f = open(tmp, "wb")
            with f:
                f.write(data)
            try:
                commit_replace(tmp, full)
            except FileNotFoundError:
                # Target dir vanished mid-write (racing force
                # delete-bucket rmtree, or delete()'s empty-parent
                # pruning). Re-derive the TYPED cause: volume gone ->
                # VolumeNotFound (the engine's commit guard maps it to
                # NoSuchBucket, never a quorum 5xx); volume intact ->
                # only the object dir was pruned, recreate + retry.
                # _makedirs_for re-checks the volume first, so this
                # never resurrects a deleted bucket.
                if volume is None:
                    raise
                self._makedirs_for(volume, os.path.dirname(full))
                try:
                    commit_replace(tmp, full)
                except FileNotFoundError as e:
                    # Deleted again between retry-mkdir and replace:
                    # the volume is being torn down right now.
                    raise serr.VolumeNotFound(volume) from e
        except serr.StorageError:
            raise
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise serr.DiskFull(str(e))
            raise serr.FaultyDisk(str(e))

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        # Volume check happens in _makedirs_for, adjacent to the mkdir.
        with _DiskOp("write_all", self):
            self._atomic_write(
                self._file_path(volume, path),
                FAULTS.filter_write(self.root, "write_all",
                                    bytes(data)),
                volume=volume)

    def read_all(self, volume: str, path: str) -> bytes:
        self._check_vol(volume)
        full = self._file_path(volume, path)
        try:
            with _DiskOp("read_all", self), open(full, "rb") as f:
                return FAULTS.filter_read(self.root, "read_all",
                                          f.read())
        except FileNotFoundError:
            raise serr.FileNotFound(f"{volume}/{path}")
        except IsADirectoryError:
            raise serr.FileNotFound(f"{volume}/{path}")
        except OSError as e:
            raise serr.FaultyDisk(str(e))

    def read_file(self, volume: str, path: str, offset: int,
                  length: int) -> bytes:
        self._check_vol(volume)
        full = self._file_path(volume, path)
        try:
            with _DiskOp("read_file", self), open(full, "rb") as f:
                f.seek(offset)
                return FAULTS.filter_read(self.root, "read_file",
                                          f.read(length))
        except FileNotFoundError:
            raise serr.FileNotFound(f"{volume}/{path}")
        except OSError as e:
            raise serr.FaultyDisk(str(e))

    def create_file(self, volume: str, path: str, data) -> None:
        """bytes -> atomic write; iterable of chunks -> incremental
        streaming write (ref streaming CreateFile,
        cmd/xl-storage.go:1575). Streamed files land directly at the
        target path: callers always stage under tmp/ and commit via
        rename_data, so a torn stream never becomes visible.
        (Volume check happens in _makedirs_for, adjacent to mkdir.)"""
        full = self._file_path(volume, path)
        if isinstance(data, (bytes, bytearray, memoryview)):
            with _DiskOp("create_file", self):
                self._atomic_write(
                    full,
                    FAULTS.filter_write(self.root, "create_file",
                                        bytes(data)),
                    volume=volume)
            return
        self._makedirs_for(volume, os.path.dirname(full))
        try:
            with open(full, "wb") as f:
                for chunk in data:
                    f.write(chunk)
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise serr.DiskFull(str(e))
            raise serr.FaultyDisk(str(e))

    def append_file(self, volume: str, path: str, data: bytes) -> None:
        full = self._file_path(volume, path)
        data = FAULTS.filter_write(self.root, "append_file", data)
        try:
            with _DiskOp("append_file", self):
                try:
                    f = open(full, "ab")
                except FileNotFoundError:
                    # First append of a staged stream: create the
                    # directory (volume-guarded) and retry. Later
                    # appends of the same stream skip the stat/mkdir
                    # pair — on the pipelined PUT path that's one
                    # fewer round of metadata syscalls per disk per
                    # batch.
                    self._makedirs_for(volume, os.path.dirname(full))
                    f = open(full, "ab")
                with f:
                    f.write(data)
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise serr.DiskFull(str(e))
            raise serr.FaultyDisk(str(e))

    def delete(self, volume: str, path: str, recursive: bool = False,
               ) -> None:
        self._check_vol(volume)
        full = self._file_path(volume, path)
        try:
            with _DiskOp("delete", self):
                if os.path.isdir(full):
                    if recursive:
                        shutil.rmtree(full)
                    else:
                        os.rmdir(full)
                else:
                    os.remove(full)
        except FileNotFoundError:
            raise serr.FileNotFound(f"{volume}/{path}")
        except OSError as e:
            raise serr.FaultyDisk(str(e))
        # Prune now-empty parent dirs up to the volume root (the reference
        # deletes parent prefixes as they empty).
        parent = os.path.dirname(full)
        vol = self._vol_path(volume)
        while parent != vol:
            try:
                os.rmdir(parent)
            except OSError:
                break
            parent = os.path.dirname(parent)

    def link_file(self, src_volume: str, src_path: str,
                  dst_volume: str, dst_path: str) -> None:
        """Hard-link src to dst (same disk root, so same filesystem),
        REPLACING dst if present — the zero-copy lane multipart
        complete uses to stage immutable part shards into the commit
        data dir without rewriting their bytes. Callers must treat the
        linked file as immutable (shard files are append-once, read-
        only after commit). Storage backends without link support
        (remote RPC disks) simply don't expose this method; callers
        fall back to read+write copy."""
        self._check_vol(src_volume)
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        self._makedirs_for(dst_volume, os.path.dirname(dst))
        tmp = os.path.join(self.root, TMP_DIR, str(uuid.uuid4()))
        try:
            with _DiskOp("link_file", self):
                # link to a tmp name then replace: os.link alone fails
                # EEXIST on a dst left by a retried complete.
                try:
                    os.link(src, tmp)
                except FileNotFoundError:
                    os.makedirs(os.path.dirname(tmp), exist_ok=True)
                    os.link(src, tmp)
                commit_replace(tmp, dst)
        except FileNotFoundError:
            raise serr.FileNotFound(f"{src_volume}/{src_path}")
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise serr.DiskFull(str(e))
            raise serr.FaultyDisk(str(e))

    def rename_file(self, src_volume: str, src_path: str, dst_volume: str,
                    dst_path: str) -> None:
        self._check_vol(src_volume)
        self._check_vol(dst_volume)
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        if not os.path.exists(src):
            raise serr.FileNotFound(f"{src_volume}/{src_path}")
        self._makedirs_for(dst_volume, os.path.dirname(dst))
        try:
            commit_replace(src, dst)
        except OSError as e:
            raise serr.FaultyDisk(str(e))

    def list_dir(self, volume: str, path: str) -> list[str]:
        self._check_vol(volume)
        full = self._file_path(volume, path) if path else self._vol_path(
            volume)
        try:
            out = []
            for name in sorted(os.listdir(full)):
                if os.path.isdir(os.path.join(full, name)):
                    out.append(name + "/")
                else:
                    out.append(name)
            return out
        except FileNotFoundError:
            raise serr.FileNotFound(f"{volume}/{path}")
        except NotADirectoryError:
            raise serr.FileNotFound(f"{volume}/{path}")

    # --- object versions ---

    def _read_xlmeta(self, volume: str, path: str) -> XLMeta:
        raw = self.read_all(volume, os.path.join(path, XL_META_FILE))
        try:
            return XLMeta.load(raw)
        except ValueError as e:
            raise serr.FileCorrupt(str(e))

    def _write_xlmeta(self, volume: str, path: str, meta: XLMeta) -> None:
        self._atomic_write(
            self._file_path(volume, os.path.join(path, XL_META_FILE)),
            meta.dump(), volume=volume)

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Commit: move <src>/<dataDir> under dst object dir, then merge
        fi as a version into dst xl.meta (ref cmd/xl-storage.go:1972)."""
        with _DiskOp("rename_data", self):
            self._rename_data(src_volume, src_path, fi, dst_volume,
                              dst_path)

    def _rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                     dst_volume: str, dst_path: str) -> None:
        self._check_vol(src_volume)
        dst_obj_dir = self._file_path(dst_volume, dst_path)
        self._makedirs_for(dst_volume, dst_obj_dir)
        if fi.data_dir:
            src_dd = self._file_path(src_volume,
                                     os.path.join(src_path, fi.data_dir))
            dst_dd = os.path.join(dst_obj_dir, fi.data_dir)
            if not os.path.isdir(src_dd):
                raise serr.FileNotFound(f"{src_volume}/{src_path}")
            if os.path.isdir(dst_dd):
                shutil.rmtree(dst_dd)
            # Crash window A: shards fully staged, nothing visible yet
            # — a death here must leave the OLD version intact and the
            # stage for the boot sweep to GC.
            FAULTS.crash_point(CRASH_RENAME_PRE)
            try:
                commit_replace(src_dd, dst_dd)
            except FileNotFoundError:
                # dst object dir vanished between the makedirs above
                # and the replace (racing force delete-bucket, or a
                # concurrent delete's empty-parent pruning): typed
                # re-check — VolumeNotFound when the bucket is gone,
                # recreate + retry when only the object dir was pruned
                # (_makedirs_for re-checks the volume, so a deleted
                # bucket is never resurrected).
                self._makedirs_for(dst_volume, dst_obj_dir)
                try:
                    commit_replace(src_dd, dst_dd)
                except FileNotFoundError as e:
                    raise serr.VolumeNotFound(dst_volume) from e
        # Crash window B: the new data dir is in place but xl.meta
        # still names the old version — a death here must read as the
        # OLD version (the orphaned new data dir is invisible until
        # the meta merge below lands, and heal GCs it).
        FAULTS.crash_point(CRASH_RENAME_MID)
        try:
            meta = self._read_xlmeta(dst_volume, dst_path)
        except serr.FileNotFound:
            meta = XLMeta()
        # Null-version overwrite frees the PREVIOUS NULL version's data dir
        # only (real versions keep theirs; ref xlMetaV2.AddVersion null-
        # version replacement semantics). Crash safety: the new xl.meta is
        # persisted BEFORE the orphaned data dir is removed, so metadata
        # never points at deleted shards.
        old = None
        if fi.version_id == "":
            for v in meta.versions:
                if v.get("versionId", "") == "":
                    old = v
                    break
        meta.add_version(fi)
        # dir_ready: dst_obj_dir was created at the top of this call;
        # xl.meta lives directly in it. volume still passed so a
        # mid-commit ENOENT (racing delete) resolves typed.
        self._atomic_write(
            self._file_path(dst_volume,
                            os.path.join(dst_path, XL_META_FILE)),
            meta.dump(), volume=dst_volume, dir_ready=True)
        # Crash window C: the NEW version is fully committed on this
        # disk; only garbage collection (old data dir, stage dir)
        # remains — a death here must read as the new version with
        # the leftovers swept at next boot.
        FAULTS.crash_point(CRASH_RENAME_POST)
        if old and old.get("dataDir") and old["dataDir"] != fi.data_dir:
            old_dd = os.path.join(dst_obj_dir, old["dataDir"])
            if os.path.isdir(old_dd):
                shutil.rmtree(old_dd, ignore_errors=True)
        # Clean the tmp staging dir — after the data-dir replace only
        # the recovery intent breadcrumb remains, so one targeted
        # unlink + bare rmdir does it (rmtree's listdir walk only for
        # the unusual leftover case).
        src_dir = self._file_path(src_volume, src_path)
        try:
            os.remove(os.path.join(src_dir, INTENT_FILE))
        except OSError:
            pass
        try:
            os.rmdir(src_dir)
        except OSError:
            shutil.rmtree(src_dir, ignore_errors=True)

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        try:
            meta = self._read_xlmeta(volume, path)
        except serr.FileNotFound:
            meta = XLMeta()
        meta.add_version(fi)
        self._write_xlmeta(volume, path, meta)

    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo:
        meta = self._read_xlmeta(volume, path)
        v = meta.find_version(version_id)
        if v is None:
            if version_id:
                raise serr.VersionNotFound(f"{path}@{version_id}")
            raise serr.FileNotFound(path)
        return FileInfo.from_version_dict(volume, path, v)

    def read_versions(self, volume: str, path: str) -> list[FileInfo]:
        meta = self._read_xlmeta(volume, path)
        return [FileInfo.from_version_dict(volume, path, v)
                for v in meta.versions]

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        meta = self._read_xlmeta(volume, path)
        v = meta.delete_version(fi.version_id)
        if v is None:
            raise serr.VersionNotFound(f"{path}@{fi.version_id}")
        obj_dir = self._file_path(volume, path)
        # Metadata first, data-dir removal second (crash-safe ordering).
        if meta.versions:
            self._write_xlmeta(volume, path, meta)
            dd = v.get("dataDir")
            if dd and not any(x.get("dataDir") == dd
                              for x in meta.versions):
                shutil.rmtree(os.path.join(obj_dir, dd),
                              ignore_errors=True)
        else:
            self.delete(volume, path, recursive=True)

    def read_parts(self, volume: str, path: str, data_dir: str,
                   ) -> list[str]:
        full = self._file_path(volume, os.path.join(path, data_dir))
        try:
            return sorted(n for n in os.listdir(full)
                          if n.startswith("part."))
        except FileNotFoundError:
            raise serr.FileNotFound(f"{volume}/{path}/{data_dir}")

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep bitrot scan of every part shard on this disk
        (ref cmd/xl-storage.go:2312,2380), hashed on the drive's
        ``device``."""
        shard_size = fi.erasure.shard_size()
        for part in fi.parts:
            rel = os.path.join(path, fi.data_dir, f"part.{part.number}")
            stream = self.read_all(volume, rel)
            algo = bitrot.DEFAULT_ALGORITHM
            for cs in fi.erasure.checksums:
                if cs.get("part") == part.number:
                    algo = cs.get("algorithm", algo)
            if bitrot.is_streaming(algo):
                if not bitrot.verify_stream(stream, shard_size, algo,
                                            self.device):
                    raise serr.FileCorrupt(f"{path} part {part.number}")
            else:
                want = ""
                for cs in fi.erasure.checksums:
                    if cs.get("part") == part.number:
                        want = cs.get("hash", "")
                if want and bitrot.digest(algo, stream,
                                          self.device).hex() != want:
                    raise serr.FileCorrupt(f"{path} part {part.number}")
