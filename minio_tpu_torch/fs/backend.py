"""Single-disk POSIX ObjectLayer — no erasure coding (ref FSObjects,
cmd/fs-v1.go:53; metadata cmd/fs-v1-metadata.go; multipart
cmd/fs-v1-multipart.go).

Layout under one root directory:
    <root>/<bucket>/<object>                          object data (plain file)
    <root>/.minio.sys/buckets/<bucket>/<object>/fs.json   per-object metadata
    <root>/.minio.sys/tmp/                            staging for atomic commit
    <root>/.minio.sys/multipart/<obj-hash>/<upload_id>/   part files + session

Like the reference FS backend, versioning APIs are not supported
(ref cmd/fs-v1.go:1090,1444 return NotImplemented); delete removes the
object, puts overwrite in place via temp-write + rename.

The port's own copy of ``minio_tpu/fs/backend.py``, with no change in
behaviour but the device seam: ``FSObjects(root, device=...)`` names
where its kernels run (S3 Select's scan, the meta drive's bitrot), the
card unless the caller asks for the CPU, as ``XLStorage`` does.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import shutil
import time
import uuid

from ..erasure.engine import (BucketExists, BucketNotFound,
                              MethodNotAllowed, ObjectInfo, ObjectNotFound)
from ..erasure.multipart import (InvalidPart, MIN_PART_SIZE, PartTooSmall,
                                 UploadNotFound, multipart_etag)
from ..storage.metadata import ObjectPartInfo

META_DIR = ".minio.sys"
_RESERVED = {META_DIR}


def _valid_bucket(bucket: str) -> bool:
    return (bucket not in _RESERVED and bucket == os.path.basename(bucket)
            and bucket not in ("", ".", ".."))


class ParentIsObject(Exception):
    """A parent prefix of the key already exists as an object, or the
    key itself is an existing prefix (ref errFileParentIsFile /
    parentDirIsObject, cmd/fs-v1.go:1067)."""


class FSObjects:
    """Filesystem ObjectLayer over a single directory (no EC, no quorum)."""

    # The versioning APIs are unsupported (ref cmd/fs-v1.go:1090,1444).
    supports_versioning = False

    def __init__(self, root: str, *, device="cuda"):
        self.root = os.path.abspath(root)
        os.makedirs(os.path.join(self.root, META_DIR, "tmp"), exist_ok=True)
        os.makedirs(os.path.join(self.root, META_DIR, "buckets"),
                    exist_ok=True)
        os.makedirs(os.path.join(self.root, META_DIR, "multipart"),
                    exist_ok=True)
        # Single meta "disk" so IAM/bucket-metadata ConfigStores work
        # unchanged on FS deployments (ref .minio.sys reuse) — and so
        # admin metrics/health that iterate set.disks see one drive.
        from ..storage.xl import XLStorage
        self.meta_disk = XLStorage(self.root, device=device)
        self.device = device
        self.disks = [self.meta_disk]
        self.k, self.m = 1, 0

    # -- paths ------------------------------------------------------------

    def _bucket_dir(self, bucket: str) -> str:
        return os.path.join(self.root, bucket)

    def _obj_path(self, bucket: str, object_name: str) -> str:
        p = os.path.normpath(os.path.join(self._bucket_dir(bucket),
                                          *object_name.split("/")))
        if not p.startswith(self._bucket_dir(bucket) + os.sep):
            raise ObjectNotFound(object_name)
        return p

    def _meta_path(self, bucket: str, object_name: str) -> str:
        return os.path.join(self.root, META_DIR, "buckets", bucket,
                            *object_name.split("/"), "fs.json")

    def _tmp_path(self) -> str:
        return os.path.join(self.root, META_DIR, "tmp", uuid.uuid4().hex)

    def _check_bucket(self, bucket: str) -> None:
        if not _valid_bucket(bucket):
            raise BucketNotFound(bucket)
        if not os.path.isdir(self._bucket_dir(bucket)):
            raise BucketNotFound(bucket)

    def _check_key_placement(self, bucket: str, dst: str) -> None:
        """Reject parent/child key conflicts the POSIX namespace cannot
        hold: 'a' as a file forbids 'a/b', and 'a/' as a prefix forbids
        object 'a' (ref parentDirIsObject, cmd/fs-v1.go:1067)."""
        if os.path.isdir(dst):
            raise ParentIsObject(dst)
        p = os.path.dirname(dst)
        stop = self._bucket_dir(bucket)
        while p != stop:
            if os.path.isfile(p):
                raise ParentIsObject(p)
            p = os.path.dirname(p)

    # -- buckets ----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        if not _valid_bucket(bucket):
            raise BucketNotFound(bucket)
        d = self._bucket_dir(bucket)
        if os.path.isdir(d):
            raise BucketExists(bucket)
        os.makedirs(d)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self._check_bucket(bucket)
        d = self._bucket_dir(bucket)
        if not force:
            if any(os.scandir(d)):
                raise OSError(errno.ENOTEMPTY, "bucket not empty", bucket)
            os.rmdir(d)
        else:
            shutil.rmtree(d)
        shutil.rmtree(os.path.join(self.root, META_DIR, "buckets", bucket),
                      ignore_errors=True)

    def list_buckets(self) -> list[dict]:
        out = []
        for e in sorted(os.scandir(self.root), key=lambda e: e.name):
            if e.is_dir() and _valid_bucket(e.name):
                out.append({"name": e.name,
                            "created": e.stat().st_mtime})
        return out

    def bucket_exists(self, bucket: str) -> bool:
        return _valid_bucket(bucket) and os.path.isdir(
            self._bucket_dir(bucket))

    # -- objects ----------------------------------------------------------

    supports_streaming_put = True

    def put_object(self, bucket: str, object_name: str, data,
                   metadata: dict | None = None,
                   versioned: bool = False,
                   parity_shards: int | None = None) -> ObjectInfo:
        # parity_shards is an EC knob; a single POSIX disk has no shards.
        if versioned:
            # ref cmd/fs-v1.go:1090: versioned PUT -> NotImplemented
            raise MethodNotAllowed("FS backend does not support versioning")
        from ..utils import streams
        self._check_bucket(bucket)
        reader = streams.ensure_reader(data)
        md5 = None if hasattr(reader, "etag") else hashlib.md5()
        size = 0
        dst = self._obj_path(bucket, object_name)
        self._check_key_placement(bucket, dst)
        tmp = self._tmp_path()
        try:
            # Chunked copy: O(chunk) memory for any object size (the
            # reference streams through fsCreateFile, cmd/fs-v1.go).
            with open(tmp, "wb") as f:
                while chunk := reader.read(1 << 20):
                    if md5 is not None:
                        md5.update(chunk)
                    size += len(chunk)
                    f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
            if hasattr(reader, "verify"):
                reader.verify()
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.replace(tmp, dst)  # atomic commit (ref fsRenameFile)
        except (NotADirectoryError, FileExistsError, IsADirectoryError):
            # Lost a race with a conflicting key creation.
            raise ParentIsObject(dst) from None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        meta = dict(metadata or {})
        meta["etag"] = reader.etag() if md5 is None else md5.hexdigest()
        self._write_fs_json(bucket, object_name, meta, size=size)
        return self.get_object_info(bucket, object_name)

    def _write_fs_json(self, bucket: str, object_name: str, meta: dict,
                       size: int, parts: list[dict] | None = None) -> None:
        mp = self._meta_path(bucket, object_name)
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        doc = {"version": "1.0.2", "meta": meta, "size": size,
               "parts": parts or []}
        tmp = self._tmp_path()
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, mp)

    def _read_fs_json(self, bucket: str, object_name: str) -> dict:
        try:
            with open(self._meta_path(bucket, object_name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            # Objects written out-of-band get defaults
            # (ref defaultFsJSON, cmd/fs-v1.go:897).
            return {"meta": {}, "parts": []}

    def get_object_info(self, bucket: str, object_name: str,
                        version_id: str = "") -> ObjectInfo:
        self._check_bucket(bucket)
        if version_id:
            raise MethodNotAllowed("FS backend does not support versioning")
        p = self._obj_path(bucket, object_name)
        try:
            st = os.stat(p)
        except OSError:
            raise ObjectNotFound(f"{bucket}/{object_name}") from None
        if not os.path.isfile(p):
            raise ObjectNotFound(f"{bucket}/{object_name}")
        doc = self._read_fs_json(bucket, object_name)
        meta = doc.get("meta", {})
        parts = [ObjectPartInfo(number=q["number"], size=q["size"],
                                actual_size=q.get("actual_size", q["size"]),
                                etag=q.get("etag", ""))
                 for q in doc.get("parts", [])]
        return ObjectInfo(bucket=bucket, name=object_name, size=st.st_size,
                          etag=meta.get("etag", ""), mod_time=st.st_mtime,
                          metadata=meta, parts=parts)

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1, version_id: str = "",
                   ) -> tuple[bytes, ObjectInfo]:
        info = self.get_object_info(bucket, object_name,
                                    version_id=version_id)
        if offset < 0 or offset > info.size:
            raise ValueError("invalid range")
        if length < 0:
            length = info.size - offset
        if offset + length > info.size:
            raise ValueError("invalid range")
        with open(self._obj_path(bucket, object_name), "rb") as f:
            f.seek(offset)
            return f.read(length), info

    def get_object_stream(self, bucket: str, object_name: str,
                          offset: int = 0, length: int = -1,
                          version_id: str = ""):
        """(info, chunk iterator) — the FS streaming GET twin of the
        erasure engine's, O(chunk) memory for any range."""
        info = self.get_object_info(bucket, object_name,
                                    version_id=version_id)
        if offset < 0 or offset > info.size:
            raise ValueError("invalid range")
        if length < 0:
            length = info.size - offset
        if offset + length > info.size:
            raise ValueError("invalid range")
        path = self._obj_path(bucket, object_name)

        def gen():
            left = length
            with open(path, "rb") as f:
                f.seek(offset)
                while left > 0:
                    chunk = f.read(min(1 << 20, left))
                    if not chunk:
                        break
                    left -= len(chunk)
                    yield chunk

        return info, gen()

    def delete_object(self, bucket: str, object_name: str,
                      version_id: str = "",
                      versioned: bool = False) -> ObjectInfo:
        self._check_bucket(bucket)
        if version_id or versioned:
            raise MethodNotAllowed("FS backend does not support versioning")
        p = self._obj_path(bucket, object_name)
        if not os.path.isfile(p):
            raise ObjectNotFound(f"{bucket}/{object_name}")
        os.remove(p)
        self._prune_dirs(os.path.dirname(p), self._bucket_dir(bucket))
        mp = self._meta_path(bucket, object_name)
        shutil.rmtree(os.path.dirname(mp), ignore_errors=True)
        return ObjectInfo(bucket=bucket, name=object_name)

    @staticmethod
    def _prune_dirs(path: str, stop: str) -> None:
        while path != stop:
            try:
                os.rmdir(path)
            except OSError:
                return
            path = os.path.dirname(path)

    def object_exists(self, bucket: str, object_name: str) -> bool:
        try:
            self.get_object_info(bucket, object_name)
            return True
        except (BucketNotFound, ObjectNotFound):
            return False

    def put_object_tags(self, bucket: str, object_name: str, tags: str,
                        version_id: str = "") -> None:
        self.update_object_metadata(bucket, object_name,
                                    {"x-amz-tagging": tags or None},
                                    version_id)

    def update_object_metadata(self, bucket: str, object_name: str,
                               updates: dict, version_id: str = "") -> None:
        """Metadata-only fs.json update; None value deletes the key."""
        info = self.get_object_info(bucket, object_name,
                                    version_id=version_id)
        meta = dict(info.metadata)
        for k, v in updates.items():
            if v is None:
                meta.pop(k, None)
            else:
                meta[k] = v
        doc = self._read_fs_json(bucket, object_name)
        self._write_fs_json(bucket, object_name, meta, size=info.size,
                            parts=doc.get("parts"))

    # -- listing ----------------------------------------------------------

    def walk_object_names(self, bucket: str) -> list[str]:
        self._check_bucket(bucket)
        base = self._bucket_dir(bucket)
        names = []
        for dirpath, _dirs, files in os.walk(base):
            rel = os.path.relpath(dirpath, base)
            for fn in files:
                names.append(fn if rel == "." else
                             "/".join((*rel.split(os.sep), fn)))
        names.sort()
        return names

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000,
                     marker: str = "") -> list[ObjectInfo]:
        out = []
        for name in self.walk_object_names(bucket):
            if prefix and not name.startswith(prefix):
                continue
            if marker and name <= marker:
                continue
            try:
                out.append(self.get_object_info(bucket, name))
            except ObjectNotFound:
                continue
            if len(out) >= max_keys:
                break
        return out

    def list_object_versions(self, bucket: str, prefix: str = "",
                             max_keys: int = 1000,
                             marker: str = "") -> list[ObjectInfo]:
        # ref cmd/fs-v1.go:1444: NotImplemented
        raise MethodNotAllowed("FS backend does not support versioning")

    # -- subsystems -------------------------------------------------------

    @property
    def multipart(self):
        return _FSMultipart(self)

    @property
    def healer(self):
        return _FSHealer()


class _FSHealer:
    """FS has no redundancy: heal is a no-op report (ref FS heal APIs
    return NotImplemented / success-no-op)."""

    def heal_object(self, bucket, object_name, dry_run=False):
        from ..erasure.heal import HealResult
        return HealResult(bucket=bucket, object_name=object_name,
                          total_disks=1, before_ok=1, after_ok=1)

    heal_object_or_queue = heal_object

    def heal_bucket(self, bucket):
        return None

    def heal_all(self):
        return []


class _FSMultipart:
    """Multipart over the FS backend (ref cmd/fs-v1-multipart.go)."""

    def __init__(self, fs: FSObjects):
        self.fs = fs
        self.min_part_size = MIN_PART_SIZE

    def _base(self, bucket: str, object_name: str, upload_id: str) -> str:
        h = hashlib.sha256(f"{bucket}/{object_name}".encode()
                           ).hexdigest()[:16]
        return os.path.join(self.fs.root, META_DIR, "multipart", h,
                            upload_id)

    def new_multipart_upload(self, bucket: str, object_name: str,
                             metadata: dict | None = None) -> str:
        self.fs._check_bucket(bucket)
        upload_id = uuid.uuid4().hex
        base = self._base(bucket, object_name, upload_id)
        os.makedirs(base, exist_ok=True)
        with open(os.path.join(base, "upload.json"), "w") as f:
            json.dump({"bucket": bucket, "object": object_name,
                       "meta": dict(metadata or {}),
                       "created": time.time()}, f)
        return upload_id

    def _load(self, bucket: str, object_name: str, upload_id: str) -> dict:
        base = self._base(bucket, object_name, upload_id)
        try:
            with open(os.path.join(base, "upload.json")) as f:
                return json.load(f)
        except OSError:
            raise UploadNotFound(upload_id) from None

    def get_upload_meta(self, bucket: str, object_name: str,
                        upload_id: str) -> dict:
        return self._load(bucket, object_name, upload_id).get("meta", {})

    def put_object_part(self, bucket: str, object_name: str,
                        upload_id: str, part_number: int,
                        data,
                        actual_size: int | None = None) -> dict:
        """`data` is bytes or a chunk reader — parts stream to disk in
        O(chunk) memory like single PUTs."""
        from ..utils import streams
        if not 1 <= part_number <= 10000:
            raise InvalidPart(f"part number {part_number}")
        self._load(bucket, object_name, upload_id)
        base = self._base(bucket, object_name, upload_id)
        reader = streams.ensure_reader(data)
        md5 = None if hasattr(reader, "etag") else hashlib.md5()
        size = 0
        tmp = self.fs._tmp_path()
        try:
            with open(tmp, "wb") as f:
                while chunk := reader.read(1 << 20):
                    if md5 is not None:
                        md5.update(chunk)
                    size += len(chunk)
                    f.write(chunk)
            if hasattr(reader, "verify"):
                reader.verify()
            os.replace(tmp, os.path.join(base, f"part.{part_number}"))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        etag = reader.etag() if md5 is None else md5.hexdigest()
        rec = {"number": part_number, "size": size, "etag": etag,
               "actualSize": (actual_size if actual_size is not None
                              else size)}
        with open(os.path.join(base, f"part.{part_number}.json"), "w") as f:
            json.dump(rec, f)
        return {"number": part_number, "size": size, "etag": etag}

    def list_parts(self, bucket: str, object_name: str,
                   upload_id: str) -> list[dict]:
        self._load(bucket, object_name, upload_id)
        base = self._base(bucket, object_name, upload_id)
        parts = []
        for fn in os.listdir(base):
            if fn.startswith("part.") and fn.endswith(".json"):
                with open(os.path.join(base, fn)) as f:
                    parts.append(json.load(f))
        parts.sort(key=lambda p: p["number"])
        return parts

    def list_uploads(self, bucket: str, prefix: str = "") -> list[dict]:
        self.fs._check_bucket(bucket)
        root = os.path.join(self.fs.root, META_DIR, "multipart")
        out = []
        for dirpath, _dirs, files in os.walk(root):
            if "upload.json" not in files:
                continue
            with open(os.path.join(dirpath, "upload.json")) as f:
                rec = json.load(f)
            if rec.get("bucket") != bucket:
                continue
            if prefix and not rec.get("object", "").startswith(prefix):
                continue
            out.append({"object": rec["object"],
                        "upload_id": os.path.basename(dirpath),
                        "created": rec.get("created", 0)})
        out.sort(key=lambda u: (u["object"], u["upload_id"]))
        return out

    def complete_multipart_upload(self, bucket: str, object_name: str,
                                  upload_id: str,
                                  parts: list[tuple[int, str]],
                                  ) -> ObjectInfo:
        rec = self._load(bucket, object_name, upload_id)
        have = {p["number"]: p for p in self.list_parts(
            bucket, object_name, upload_id)}
        base = self._base(bucket, object_name, upload_id)

        if not parts:
            raise InvalidPart("empty part list")
        etags, infos = [], []
        prev = 0
        for i, (num, etag) in enumerate(parts):
            if num <= prev:
                raise InvalidPart("parts not in ascending order")
            prev = num
            p = have.get(num)
            if p is None or p["etag"].strip('"') != etag.strip('"'):
                raise InvalidPart(f"part {num}")
            logical = p.get("actualSize", p["size"])
            if i < len(parts) - 1 and logical < self.min_part_size:
                raise PartTooSmall(f"part {num}")
            etags.append(p["etag"])
            infos.append(p)

        dst = self.fs._obj_path(bucket, object_name)
        self.fs._check_key_placement(bucket, dst)
        tmp = self.fs._tmp_path()
        total = 0
        try:
            with open(tmp, "wb") as out:
                for p in infos:
                    with open(os.path.join(base, f"part.{p['number']}"),
                              "rb") as f:
                        shutil.copyfileobj(f, out)
                    total += p["size"]
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.replace(tmp, dst)
        except (NotADirectoryError, FileExistsError, IsADirectoryError):
            raise ParentIsObject(dst) from None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

        meta = dict(rec.get("meta", {}))
        meta["etag"] = multipart_etag(etags)
        self.fs._write_fs_json(
            bucket, object_name, meta, size=total,
            parts=[{"number": p["number"], "size": p["size"],
                    "actual_size": p.get("actualSize", p["size"]),
                    "etag": p["etag"]} for p in infos])
        self._cleanup(bucket, object_name, upload_id)
        return self.fs.get_object_info(bucket, object_name)

    def abort_multipart_upload(self, bucket: str, object_name: str,
                               upload_id: str) -> None:
        self._load(bucket, object_name, upload_id)
        self._cleanup(bucket, object_name, upload_id)

    def _cleanup(self, bucket: str, object_name: str,
                 upload_id: str) -> None:
        base = self._base(bucket, object_name, upload_id)
        shutil.rmtree(base, ignore_errors=True)
        try:
            os.rmdir(os.path.dirname(base))
        except OSError:
            pass
