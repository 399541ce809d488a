"""Multipart uploads: each part independently erasure-coded, complete
stitches parts into one versioned object (ref cmd/erasure-multipart.go:
NewMultipartUpload:314, PutObjectPart:342, CompleteMultipartUpload:678).

On-disk (per disk, inside .minio.sys):
    mpu/<obj-hash>/<upload_id>/upload.json   upload session record
    mpu/<obj-hash>/<upload_id>/part.N        bitrot-wrapped shard of part N
    mpu/<obj-hash>/<upload_id>/part.N.json   part metadata (size, etag)

Complete moves the part shards into a fresh data dir and commits via the
same rename_data path as a single PUT; the object's FileInfo carries the
per-part sizes so ranged reads address (part, block) pairs.

The port's own copy of ``minio_tpu/erasure/multipart.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import json
import uuid

from ..faultinject import FAULTS
from ..parallel.quorum import (QuorumError, first_success, hash_order,
                               parallel_map, reduce_quorum_errs,
                               write_quorum)
from ..storage import errors as serr
from ..storage.metadata import (ErasureInfo, FileInfo, ObjectPartInfo,
                                new_data_dir, now)
from ..storage.xl import INTENT_FILE, MINIO_META_BUCKET, TMP_PATH
from . import bitrot

MPU_PATH = "mpu"
MIN_PART_SIZE = 5 * 1024 * 1024  # S3 minimum for all but the last part

# Crash points on multipart complete — the windows where a process
# death leaves the upload staged, half-linked, or committed-but-not-
# garbage-collected (tests/test_crash_consistency.py).
CRASH_MPU_PRE = FAULTS.register_crash_point(
    "engine.multipart.pre_commit")
CRASH_MPU_LINK = FAULTS.register_crash_point(
    "engine.multipart.mid_link")
CRASH_MPU_POST = FAULTS.register_crash_point(
    "engine.multipart.post_commit")


class UploadNotFound(Exception):
    pass


class InvalidPart(Exception):
    pass


class PartTooSmall(Exception):
    pass


def _upload_base(bucket: str, object_name: str, upload_id: str) -> str:
    h = hashlib.sha256(f"{bucket}/{object_name}".encode()).hexdigest()[:16]
    return f"{MPU_PATH}/{h}/{upload_id}"


def multipart_etag(part_etags: list[str]) -> str:
    """S3 multipart etag: md5 of concatenated binary part md5s + -N."""
    binmd5 = b"".join(bytes.fromhex(e) for e in part_etags)
    return f"{hashlib.md5(binmd5).hexdigest()}-{len(part_etags)}"


class MultipartUploads:
    """Multipart operations over an ErasureObjects engine."""

    def __init__(self, engine, min_part_size: int = MIN_PART_SIZE):
        self.engine = engine
        self.min_part_size = min_part_size

    # -- session ----------------------------------------------------------

    def new_multipart_upload(self, bucket: str, object_name: str,
                             metadata: dict | None = None) -> str:
        eng = self.engine
        eng._check_bucket(bucket)
        upload_id = uuid.uuid4().hex
        base = _upload_base(bucket, object_name, upload_id)
        record = json.dumps({
            "bucket": bucket, "object": object_name,
            "meta": dict(metadata or {}), "created": now(),
            "distribution": hash_order(f"{bucket}/{object_name}",
                                       len(eng.disks)),
        }).encode()
        _, errs = parallel_map(
            [lambda d=d: d.write_all(MINIO_META_BUCKET,
                                     f"{base}/upload.json", record)
             for d in eng.disks])
        reduce_quorum_errs(errs, write_quorum(eng.k, eng.m),
                           "new_multipart_upload")
        return upload_id

    def _load_upload(self, bucket: str, object_name: str,
                     upload_id: str) -> dict:
        """First-SUCCESS parallel probe for the upload record: all
        disks are asked at once and the first healthy answer wins —
        the old serial try/except walk paid a slow or dead disk's full
        timeout on EVERY part upload before the next disk was even
        asked, and a join-all fan-out would still wait for the
        slowest. Under pool saturation first_success degrades to the
        serial early-exit walk (never run-all); the n-1 discarded
        straggler reads are a few hundred bytes each, noise next to
        the n shard-append RPCs every part batch already fans out. A
        torn record (ValueError) propagates, as before."""
        base = _upload_base(bucket, object_name, upload_id)
        try:
            raw = first_success(
                [lambda d=d: d.read_all(MINIO_META_BUCKET,
                                        f"{base}/upload.json")
                 for d in self.engine.disks],
                swallow=serr.StorageError)
        except QuorumError:
            raise UploadNotFound(upload_id) from None
        return json.loads(raw)

    def get_upload_meta(self, bucket: str, object_name: str,
                        upload_id: str) -> dict:
        """The metadata captured at initiate time (SSE envelope,
        content-type, user meta — ref fs/erasure multipart meta)."""
        return dict(self._load_upload(bucket, object_name,
                                      upload_id).get("meta", {}))

    # -- parts ------------------------------------------------------------

    def put_object_part(self, bucket: str, object_name: str,
                        upload_id: str, part_number: int,
                        data,
                        actual_size: int | None = None) -> dict:
        """Streaming part write — the same pipelined data plane as a
        single PUT (engine._stream_shard_writes): batch N+1 is read and
        erasure-encoded (with the etag md5 overlapped) while batch N's
        shards fan out to disks, with the ec.encode / ec.write /
        ec.shard_write tracing spans PutObject already had (ref
        PutObjectPart block loop, cmd/erasure-multipart.go:342).
        `data` is bytes or a chunk reader; memory stays
        O(pipeline_depth × batch). actual_size: pre-transform
        (plaintext/uncompressed) length when the handler encrypted or
        compressed the part body."""
        from ..utils import streams
        eng = self.engine
        if not 1 <= part_number <= 10000:
            raise InvalidPart(f"part number {part_number}")
        up = self._load_upload(bucket, object_name, upload_id)
        dist = up["distribution"]
        base = _upload_base(bucket, object_name, upload_id)
        reader = streams.ensure_reader(data)
        n = len(eng.disks)
        wq = write_quorum(eng.k, eng.m)
        stage = f"{base}/part.{part_number}.{uuid.uuid4().hex}.stage"
        md5 = None if hasattr(reader, "etag") else hashlib.md5()
        alive = [True] * n
        disk_errs: list = [None] * n
        # Degraded write past quarantined drives (same policy as a
        # single PUT; the completed object's missing shards heal via
        # the engine's MRF requeue at complete time).
        eng._quarantine_skip(alive, disk_errs, wq)

        def cleanup(indices):
            parallel_map([
                lambda i=i: eng.disks[i].delete(MINIO_META_BUCKET, stage)
                for i in indices])

        def append_shard(i: int, payload, parent=None):
            if parent is None:  # untraced fast path
                eng.disks[i].append_file(MINIO_META_BUCKET, stage,
                                         payload)
                return
            from ..obs.span import TRACER
            with TRACER.span("ec.shard_write", parent=parent, disk=i,
                             endpoint=str(eng.disks[i]),
                             bytes=len(payload)):
                eng.disks[i].append_file(MINIO_META_BUCKET, stage,
                                         payload)

        def quorum_msg() -> str:
            return f"part write quorum lost ({sum(alive)}/{n})"

        try:
            total, _, _ = eng._stream_shard_writes(
                reader, eng.k, eng.m, eng.codec, dist, append_shard,
                alive, disk_errs, wq, quorum_msg, md5)
            if hasattr(reader, "verify"):
                reader.verify()

            etag = reader.etag() if md5 is None else md5.hexdigest()
            part_meta = json.dumps({
                "number": part_number, "size": total, "etag": etag,
                "actualSize": (actual_size if actual_size is not None
                               else total),
            }).encode()

            def commit_one(i: int):
                if not alive[i]:
                    raise disk_errs[i]
                disk = eng.disks[i]
                if total > 0:
                    disk.rename_file(MINIO_META_BUCKET, stage,
                                     MINIO_META_BUCKET,
                                     f"{base}/part.{part_number}")
                else:
                    # Zero-byte parts still get an (empty) shard file so
                    # the commit/verify/heal paths see every part.N.
                    disk.write_all(MINIO_META_BUCKET,
                                   f"{base}/part.{part_number}", b"")
                disk.write_all(MINIO_META_BUCKET,
                               f"{base}/part.{part_number}.json",
                               part_meta)

            _, errs = parallel_map(
                [lambda i=i: commit_one(i) for i in range(n)])
            reduce_quorum_errs(errs, wq, "put_object_part")
        except BaseException:
            cleanup(range(n))
            raise
        return {"number": part_number, "size": total, "etag": etag}

    def list_parts(self, bucket: str, object_name: str,
                   upload_id: str) -> list[dict]:
        """Union of part records across disks — a part missing on one
        disk (tolerated by write quorum) must still be listable."""
        self._load_upload(bucket, object_name, upload_id)
        base = _upload_base(bucket, object_name, upload_id)
        parts: dict[int, dict] = {}
        for disk in self.engine.disks:
            try:
                entries = disk.list_dir(MINIO_META_BUCKET, base)
            except serr.StorageError:
                continue
            for e in entries:
                if e.startswith("part.") and e.endswith(".json"):
                    try:
                        rec = json.loads(disk.read_all(
                            MINIO_META_BUCKET, f"{base}/{e}"))
                    except serr.StorageError:
                        continue
                    parts.setdefault(rec["number"], rec)
        return [parts[n] for n in sorted(parts)]

    def list_uploads(self, bucket: str,
                     prefix: str = "") -> list[dict]:
        """All in-progress uploads for a bucket (scan the mpu tree)."""
        eng = self.engine
        out = []
        seen = set()
        for disk in eng.disks:
            try:
                hashes = disk.list_dir(MINIO_META_BUCKET, MPU_PATH)
            except serr.StorageError:
                continue
            for h in hashes:
                if not h.endswith("/"):
                    continue
                try:
                    uploads = disk.list_dir(MINIO_META_BUCKET,
                                            f"{MPU_PATH}/{h}")
                except serr.StorageError:
                    continue
                for u in uploads:
                    u = u.rstrip("/")
                    if u in seen:
                        continue
                    try:
                        rec = json.loads(disk.read_all(
                            MINIO_META_BUCKET,
                            f"{MPU_PATH}/{h}{u}/upload.json"))
                    except serr.StorageError:
                        continue
                    if rec["bucket"] != bucket:
                        continue
                    if prefix and not rec["object"].startswith(prefix):
                        continue
                    seen.add(u)
                    out.append({"upload_id": u, "object": rec["object"],
                                "created": rec["created"]})
        return sorted(out, key=lambda x: (x["object"], x["upload_id"]))

    # -- complete / abort -------------------------------------------------

    def complete_multipart_upload(self, bucket: str, object_name: str,
                                  upload_id: str,
                                  parts: list[tuple[int, str]]):
        """parts: [(part_number, etag), ...] as sent by the client."""
        eng = self.engine
        up = self._load_upload(bucket, object_name, upload_id)
        dist = up["distribution"]
        base = _upload_base(bucket, object_name, upload_id)
        have = {p["number"]: p for p in self.list_parts(
            bucket, object_name, upload_id)}

        # Validate the client's part list (ref CompleteMultipartUpload
        # part checks).
        if not parts:
            raise InvalidPart("empty part list")
        last_idx = len(parts) - 1
        prev = 0
        part_infos: list[ObjectPartInfo] = []
        for idx, (num, etag) in enumerate(parts):
            if num <= prev:
                raise InvalidPart("parts not in ascending order")
            prev = num
            meta = have.get(num)
            if meta is None or meta["etag"].strip('"') != etag.strip('"'):
                raise InvalidPart(f"part {num}")
            # Size floor applies to the LOGICAL (pre-SSE/compression)
            # length — ciphertext expansion must not mask a too-small
            # part (ref globalMinPartSize check on actual size).
            logical = meta.get("actualSize", meta["size"])
            if idx != last_idx and logical < self.min_part_size:
                raise PartTooSmall(f"part {num}: {logical} bytes")
            part_infos.append(ObjectPartInfo(
                number=num, size=meta["size"],
                actual_size=meta.get("actualSize", meta["size"]),
                etag=meta["etag"]))

        total_size = sum(p.size for p in part_infos)
        total_actual = sum(p.actual_size for p in part_infos)
        etag = multipart_etag([p.etag for p in part_infos])
        data_dir = new_data_dir()
        mod_time = now()
        meta = dict(up.get("meta") or {})
        meta["etag"] = etag
        if total_actual != total_size:
            # Handler-transformed parts (SSE/compression): record the
            # logical object length (ref X-Minio-Internal-actual-size).
            meta["x-internal-actual-size"] = str(total_actual)
        wq = write_quorum(eng.k, eng.m)

        from .engine import _stage_intent_blob
        intent_blob = _stage_intent_blob(bucket, object_name, "",
                                         data_dir)

        def commit_one(i: int):
            disk = eng.disks[i]
            tmp_path = f"{TMP_PATH}/{uuid.uuid4()}"
            link = getattr(disk, "link_file", None)
            try:
                if total_size > 0:
                    # Recovery breadcrumb before the link/copy loop:
                    # a crash mid-commit leaves this stage dir for the
                    # boot sweep to map back to the object.
                    try:
                        disk.append_file(MINIO_META_BUCKET,
                                         f"{tmp_path}/{INTENT_FILE}",
                                         intent_blob)
                    except serr.StorageError:
                        pass
                # Stage this disk's part shards into the commit data
                # dir, KEEPING the client's part numbers (SSE derives
                # per-part keys from them, and ListParts reports them;
                # ref AWS part-number semantics). Not a rename: a
                # failed quorum must leave the upload intact so the
                # client can retry complete (cleanup happens only after
                # quorum success). Local disks HARD-LINK the immutable
                # shard files (zero bytes moved — the dominant cost of
                # complete for multi-GiB uploads); backends without
                # link support fall back to read+write copy.
                if total_size > 0:
                    for p in part_infos:
                        # Crash window: fires per part, so an `after`
                        # count lands the kill MID hard-link loop —
                        # some parts staged, some not, nothing
                        # visible.
                        FAULTS.crash_point(CRASH_MPU_LINK)
                        if link is not None:
                            try:
                                link(MINIO_META_BUCKET,
                                     f"{base}/part.{p.number}",
                                     MINIO_META_BUCKET,
                                     f"{tmp_path}/{data_dir}"
                                     f"/part.{p.number}")
                                continue
                            except serr.FileNotFound:
                                raise
                            except serr.StorageError:
                                # Filesystem without hard-link support
                                # (FAT, some NFS/overlay mounts): take
                                # the copy lane for the rest of this
                                # disk's parts.
                                link = None
                        shard = disk.read_all(MINIO_META_BUCKET,
                                              f"{base}/part.{p.number}")
                        disk.create_file(
                            MINIO_META_BUCKET,
                            f"{tmp_path}/{data_dir}/part.{p.number}",
                            shard)
                fi = FileInfo(
                    volume=bucket, name=object_name, version_id="",
                    data_dir=data_dir if total_size > 0 else "",
                    size=total_size, mod_time=mod_time, metadata=meta,
                    parts=list(part_infos),
                    erasure=ErasureInfo(
                        data_blocks=eng.k, parity_blocks=eng.m,
                        block_size=eng.block_size, index=dist[i],
                        distribution=list(dist),
                        checksums=[{"part": p.number,
                                    "algorithm": bitrot.DEFAULT_ALGORITHM,
                                    "hash": ""}
                                   for p in part_infos]),
                )
                if total_size > 0:
                    disk.rename_data(MINIO_META_BUCKET, tmp_path, fi,
                                     bucket, object_name)
                else:
                    disk.write_metadata(bucket, object_name, fi)
                return fi
            except BaseException:
                try:
                    disk.delete(MINIO_META_BUCKET, tmp_path,
                                recursive=True)
                except Exception:
                    pass
                raise

        # Crash window: upload validated, nothing staged into tmp yet
        # — a death here must leave the upload intact and retryable.
        FAULTS.crash_point(CRASH_MPU_PRE)
        # Exclusive commit against concurrent put/delete on the same key
        # (ref CompleteMultipartUpload NSLock, cmd/erasure-multipart.go).
        with eng.ns_lock.write_locked(bucket, object_name):
            _, errs = parallel_map(
                [lambda i=i: commit_one(i)
                 for i in range(len(eng.disks))])
            from .engine import BucketNotFound
            try:
                eng.guard_commit_bucket_gone(errs, bucket, object_name,
                                             "", wq=wq)
            except BucketNotFound:
                # Terminal failure: reclaim the staged parts too — the
                # client won't abort an upload of a bucket that no
                # longer exists.
                self._cleanup(bucket, object_name, upload_id)
                raise
            reduce_quorum_errs(errs, wq, "complete_multipart_upload")
        # Crash window: the object is quorum-committed but the upload
        # session (mpu dir) hasn't been reclaimed — a death here must
        # serve the completed object; the leftover upload stays
        # abortable/listable (ref stale-upload cleanup).
        FAULTS.crash_point(CRASH_MPU_POST)
        if any(e is not None for e in errs):
            eng.mrf.add(bucket, object_name)
        self._cleanup(bucket, object_name, upload_id)
        eng._mark_update(bucket, object_name)
        # Multipart complete is an overwrite of the key: invalidate
        # the hot-object cache (local + peer fan-out).
        from ..cache.hotcache import HOTCACHE
        HOTCACHE.invalidate(bucket, object_name)

        from .engine import ObjectInfo
        return ObjectInfo(bucket=bucket, name=object_name,
                          size=total_size, etag=etag, mod_time=mod_time,
                          metadata=meta, parts=part_infos)

    def abort_multipart_upload(self, bucket: str, object_name: str,
                               upload_id: str) -> None:
        self._load_upload(bucket, object_name, upload_id)
        self._cleanup(bucket, object_name, upload_id)

    def _cleanup(self, bucket: str, object_name: str,
                 upload_id: str) -> None:
        base = _upload_base(bucket, object_name, upload_id)
        parallel_map(
            [lambda d=d: d.delete(MINIO_META_BUCKET, base, recursive=True)
             for d in self.engine.disks])
