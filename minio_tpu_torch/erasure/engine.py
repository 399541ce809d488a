"""ErasureObjects — one erasure set's object engine.

The analog of the reference's erasureObjects (ref cmd/erasure.go:48,
cmd/erasure-object.go): quorum metadata read/write, shard I/O
orchestration over StorageAPI disks, encode via the TPU codec, bitrot
wrap/verify, degraded reads with reconstruction.

Write path (ref putObject, cmd/erasure-object.go:582 / call stack §3.2):
    split blocks -> batched encode (TPU) -> bitrot-wrap shard streams ->
    parallel tmp write on all disks (write-quorum tolerant) ->
    rename_data commit (atomic per disk, quorum again).

Read path (ref getObjectWithFileInfo, cmd/erasure-object.go:240):
    read xl.meta all disks -> FileInfo quorum -> read k shards
    (first-k-wins with fallback to parity disks) -> reconstruct missing ->
    join + trim.

The port's own copy of ``minio_tpu/erasure/engine.py``, with no change in
behaviour but the device seam. An engine has one backend and one device:
``ErasureObjects(disks, k, m, block_size, *, backend="gpu", device=None)``
resolves its device once (``codec.codec_device``), builds every codec --
its own, per-object geometries, heal's and REGEN repair's -- on that
backend and device, and passes ``bitrot_device`` to every bitrot call:
``"auto"`` for an ``"auto"`` engine, so the reference's host routing
holds, else the resolved device. A ``"gpu"`` engine encodes on kernel K1
and hashes on kernel K2 and raises at construction without a card; a
``"cpu"`` engine runs their plain versions. A pinned engine always frames
a PUT batch centrally (``_frame_split``: one K2 dispatch over all k+m
shards); an ``"auto"`` engine keeps the reference's ``_device_hash_ok``
test. The bytes on disk are the same either way. The per-set device
affinity is assigned only for an engine on a card, and a failure to
assign raises instead of being swallowed.
"""

from __future__ import annotations

import hashlib
import time
import uuid
from dataclasses import dataclass, field

import numpy as np

from ..faultinject import FAULTS
from ..parallel.quorum import (MULTICORE, QuorumError, hash_order,
                               parallel_map, read_quorum,
                               reduce_quorum_errs, submit, write_quorum)
from ..storage import errors as serr
from ..storage.interface import StorageAPI
from ..storage.metadata import (ERASURE_ALGORITHM, ErasureInfo, FileInfo,
                                ObjectPartInfo, new_data_dir,
                                new_version_id, now)
from ..storage.xl import INTENT_FILE, MINIO_META_BUCKET, TMP_PATH
from ..utils import ceil_frac
from . import bitrot
from .codec import BLOCK_SIZE, Erasure, codec_device

from ..storage.interface import DATA_DIR_RE


def _looks_like_data_dir(name: str) -> bool:
    """Data dirs are uuid4 names (metadata.new_data_dir)."""
    return bool(DATA_DIR_RE.match(name))


# Crash points on the engine-level PUT commit (the per-disk windows
# live in storage/xl.py rename_data): staged-but-uncommitted, and
# quorum-committed-but-ungarbage-collected. Armed via the fault plan
# (kind "crash"); tests/test_crash_consistency.py asserts the restart
# invariants for each.
CRASH_PUT_STAGED = FAULTS.register_crash_point("engine.put.post_stage")
CRASH_PUT_COMMITTED = FAULTS.register_crash_point(
    "engine.put.post_commit")


def _stage_intent_blob(bucket: str, object_name: str, version_id: str,
                       data_dir: str) -> bytes:
    """The recovery breadcrumb dropped into every staging dir
    (storage/recovery.py reads it at boot to requeue the object for
    heal before GC-ing the orphaned stage)."""
    import json
    return json.dumps({"bucket": bucket, "object": object_name,
                       "versionId": version_id,
                       "dataDir": data_dir}).encode()


class ObjectNotFound(Exception):
    pass


class MethodNotAllowed(Exception):
    """GET/HEAD of a delete marker addressed by explicit versionId
    (S3 returns 405; ref toAPIErrorCode MethodNotAllowed mapping)."""
    pass


class BucketNotFound(Exception):
    pass


class BucketExists(Exception):
    pass


@dataclass
class ObjectInfo:
    bucket: str
    name: str
    size: int = 0
    etag: str = ""
    mod_time: float = 0.0
    version_id: str = ""
    delete_marker: bool = False
    metadata: dict = field(default_factory=dict)
    parts: list[ObjectPartInfo] = field(default_factory=list)

    @classmethod
    def from_file_info(cls, fi: FileInfo) -> "ObjectInfo":
        return cls(bucket=fi.volume, name=fi.name, size=fi.size,
                   etag=fi.metadata.get("etag", ""), mod_time=fi.mod_time,
                   version_id=fi.version_id, delete_marker=fi.deleted,
                   metadata=dict(fi.metadata), parts=list(fi.parts))


class _LockedStream:
    """Chunk iterator that owns a namespace read lock: released on
    exhaustion, close(), error, or GC — so an abandoned streaming GET
    can't pin the object's lock."""

    def __init__(self, lock_ctx, gen):
        self._ctx = lock_ctx  # already entered
        self._gen = gen
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._closed:
            raise StopIteration
        try:
            return next(self._gen)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._gen.close()
        finally:
            self._ctx.__exit__(None, None, None)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ErasureObjects:
    """Object engine over one erasure set of k+m disks."""

    # PUT accepts chunk readers (O(batch) streaming pipeline).
    supports_streaming_put = True

    def __init__(self, disks: list[StorageAPI],
                 data_shards: int | None = None,
                 parity_shards: int | None = None,
                 block_size: int = BLOCK_SIZE, *, backend: str = "gpu",
                 device=None):
        n = len(disks)
        if n < 2:
            raise ValueError("an erasure set needs >= 2 disks")
        # One backend and one device for every codec and bitrot call of
        # this engine (resolved here: raises without a card for "gpu").
        self.backend = backend
        self.device = codec_device(backend, device)
        self.bitrot_device = bitrot.AUTO if backend == "auto" \
            else self.device
        if data_shards is None:
            # Default split: half data, half parity (ref default
            # storage-class N/2:N/2, cmd/config/storageclass).
            parity_shards = n // 2
            data_shards = n - parity_shards
        elif parity_shards is None:
            parity_shards = n - data_shards
        if data_shards + parity_shards != n:
            raise ValueError("k + m must equal the number of disks")
        self.disks = list(disks)
        self.k = data_shards
        self.m = parity_shards
        self.block_size = block_size
        # Drive-health peer group: this set's disks score each other's
        # latency EWMAs relative to the set median (obs/drivemon.py) —
        # a laggard drive is only an outlier against its own quorum
        # peers, never against unrelated pools.
        from ..obs.drivemon import DRIVEMON, drive_key

        # Per-disk health identity, index-aligned with self.disks: the
        # read-selection, hedging, and quarantine paths all key the
        # monitor by it.
        self.endpoints = [drive_key(d) for d in self.disks]
        DRIVEMON.register_set(self.endpoints)
        # Hedged shard reads (the reaction half of drive health): when
        # a shard read straggles past the adaptive budget — multiplier
        # x rolling p75 of healthy shard reads (utils/dyntimeout.py
        # PercentileBudget) — a backup read of a spare shard fires on
        # the background QoS lane; first response wins, the loser is
        # discarded. This bounds GET tail latency by the budget, not
        # the straggler (arXiv:1709.05365's regime; any-k-of-n reads
        # per arXiv:1504.07038).
        from ..utils.dyntimeout import PercentileBudget
        self.hedge_enabled = True
        # Floor sits above OS-scheduler jitter (tens of ms under
        # contention): a stall the scheduler alone can cause must not
        # fire backup I/O, or a busy box hedges every read.
        self.hedge_budget = PercentileBudget(
            multiplier=4.0, floor=0.050, ceiling=2.0)
        # Streaming-pipeline knobs: how many bytes one encode dispatch /
        # one read window group covers, and how many batches/groups may
        # be in flight at once (utils/pipeline.py). Peak data-plane
        # memory is O(pipeline_depth × batch), independent of object
        # size. Batches are sized so a multi-batch stream actually
        # pipelines (several batches per large part) while one encode
        # dispatch still clears the device-batching threshold
        # (codec.TPU_MIN_BYTES).
        from ..utils.pipeline import DEFAULT_DEPTH
        from ..utils.streams import DEFAULT_BATCH_BYTES, PUT_BATCH_BYTES
        self.put_batch_bytes = PUT_BATCH_BYTES
        self.read_group_bytes = DEFAULT_BATCH_BYTES // 2
        self.pipeline_depth = DEFAULT_DEPTH
        self.codec = Erasure(data_shards, parity_shards, block_size,
                             backend=self.backend, device=self.device)
        self._codec_cache: dict[tuple[int, int], Erasure] = {}
        from ..parallel.nslock import LocalNSLock
        from .heal import Healer, MRFQueue, NewDiskMonitor
        from .multipart import MultipartUploads
        from .heal import QuarantineProber
        self.healer = Healer(self)
        self.mrf = MRFQueue(self.healer)
        # Not started by default; the server boot starts it (tests and
        # library users drive tick() directly).
        self.new_disk_monitor = NewDiskMonitor(self.healer)
        # Probation probes for quarantined drives (same start contract
        # as the new-disk monitor: server boot starts it, tests drive
        # tick() directly).
        self.quarantine_prober = QuarantineProber(self)
        self.multipart = MultipartUploads(self)
        # Namespace locks: in-process by default; distributed deployments
        # inject a dsync-backed provider (ref ObjectLayer.NewNSLock).
        self.ns_lock = LocalNSLock()
        # Listing engine + change tracking (ref metacache + bloom
        # dataUpdateTracker; cmd/metacache-server-pool.go:38).
        from ..listing.metacache import MetacacheManager
        from ..scanner.tracker import DataUpdateTracker
        self.update_tracker = DataUpdateTracker()
        self.metacache = MetacacheManager(self)
        # Hot-object serving tier namespace (cache/hotcache.py): GETs
        # consult the process-wide HOTCACHE under this engine-unique
        # prefix, so two unrelated engines in one process (test
        # fixtures, multi-pool layouts) can never serve each other's
        # bytes; invalidation addresses (bucket, key) and clears every
        # namespace.
        self.cache_ns = uuid.uuid4().hex[:16]
        # Per-set device affinity (parallel/mesh.py DeviceAffinity):
        # on a multi-chip mesh each erasure set gets a home device, so
        # concurrent sets' codec dispatches spread across chips
        # instead of all queueing on device 0 (None off-mesh, and for
        # an engine off the card, which never asks for the census).
        from ..parallel.mesh import MESH_AFFINITY
        self.device_affinity = (MESH_AFFINITY.assign(self.cache_ns)
                                if self.device.type == "cuda" else None)
        self.codec.affinity = self.device_affinity

    def shutdown(self) -> None:
        """Stop this engine's background daemons — the MRF heal queue
        worker, the new-disk monitor, and the quarantine prober. A
        stopped deployment's daemons must not keep healing into the
        void: a test or embedder that drops the engine otherwise leaks
        threads that churn dead disks (and steal CPU from whatever
        runs next in the process). Server shutdown calls this; safe to
        call twice."""
        self.healer.shutdown()
        self.mrf.stop()
        self.new_disk_monitor.stop()
        self.quarantine_prober.stop()
        if getattr(self, "device_affinity", None) is not None:
            from ..parallel.mesh import MESH_AFFINITY
            MESH_AFFINITY.release(self.cache_ns)

    def _mark_update(self, bucket: str, object_name: str = "") -> None:
        self.update_tracker.mark(bucket, object_name)

    # ------------------------------------------------------------------
    # buckets

    # Bucket create/delete serialize on a meta lock (ref MakeBucket /
    # DeleteBucket taking the bucket's lock, cmd/erasure-server-pool.go):
    # two racing, per-disk-parallel ops could otherwise BOTH "succeed"
    # while leaving the volume on half the disks.
    def _bucket_meta_lock(self, bucket: str):
        return self.ns_lock.write_locked(MINIO_META_BUCKET,
                                         f"buckets/{bucket}")

    def make_bucket(self, bucket: str) -> None:
        self._check_not_reserved(bucket)
        with self._bucket_meta_lock(bucket):
            self._make_bucket_locked(bucket)

    def _make_bucket_locked(self, bucket: str) -> None:
        _, errs = parallel_map(
            [lambda d=d: d.make_volume(bucket) for d in self.disks])
        exists = [isinstance(e, serr.VolumeExists) for e in errs]
        if any(exists) and not any(e is None for e in errs):
            # No disk actually created it -> it already exists (faulty
            # disks tolerated; heal converges stragglers later).
            raise BucketExists(bucket)
        # A disk where the volume already exists counts as success.
        eff = [None if ex else e for e, ex in zip(errs, exists)]
        try:
            reduce_quorum_errs(eff, len(self.disks) // 2 + 1, "make_bucket")
        except QuorumError:
            # Roll back partial creates.
            parallel_map([lambda d=d: d.delete_volume(bucket, force=True)
                          for d, e in zip(self.disks, errs) if e is None])
            raise

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self._check_not_reserved(bucket)
        with self._bucket_meta_lock(bucket):
            self._delete_bucket_locked(bucket, force)

    def _delete_bucket_locked(self, bucket: str, force: bool) -> None:
        _, errs = parallel_map(
            [lambda d=d: d.delete_volume(bucket, force=force)
             for d in self.disks])
        def undo_removals():
            # Restore volumes on disks where OUR delete succeeded (ref
            # undoDeleteBucketSets, cmd/erasure-sets.go:723) — the
            # bucket must stay fully present, not on a random subset.
            parallel_map([lambda d=d: d.make_volume(bucket)
                          for d, e in zip(self.disks, errs) if e is None])

        if any(isinstance(e, serr.VolumeExists) for e in errs):
            # Non-empty somewhere (e.g. a racing PUT committed there).
            undo_removals()
            raise BucketExists(f"{bucket} not empty")
        if all(isinstance(e, serr.VolumeNotFound) for e in errs):
            raise BucketNotFound(bucket)
        # A disk where the volume is already absent counts as success:
        # deletion is idempotent, and a concurrent delete_bucket racing
        # this one may have removed some volumes first — the combined
        # outcome (bucket gone) is what both callers asked for.
        eff = [None if isinstance(e, serr.VolumeNotFound) else e
               for e in errs]
        try:
            reduce_quorum_errs(eff, len(self.disks) // 2 + 1,
                               "delete_bucket")
        except QuorumError:
            # Below quorum (real disk errors): undo what we removed.
            undo_removals()
            raise
        self.metacache.drop_bucket(bucket)
        from ..cache.hotcache import HOTCACHE
        HOTCACHE.invalidate_bucket(bucket)
        self._mark_update(bucket)

    def list_buckets(self) -> list[dict]:
        """Volumes held by a MAJORITY of responding disks.

        First-healthy-disk semantics (ref cmd/erasure-bucket.go) break
        when a wiped replacement disk answers with an empty listing;
        a plain union breaks the other way, resurrecting buckets that
        were deleted at write quorum while one disk was offline (the
        stale minority copy would reappear). Majority-of-responding
        matches both: a fresh disk is a minority of absences, a stale
        survivor is a minority of presences."""
        def one(disk):
            return [disk.stat_volume(v) for v in disk.list_volumes()]

        results, errs = parallel_map(
            [lambda d=d: one(d) for d in self.disks])
        responding = sum(1 for e in errs if e is None)
        seen: dict[str, dict] = {}
        counts: dict[str, int] = {}
        for stats, e in zip(results, errs):
            if e is not None:
                continue
            for st in stats or []:
                counts[st["name"]] = counts.get(st["name"], 0) + 1
                cur = seen.get(st["name"])
                if cur is None or st.get("created", 0) < cur.get(
                        "created", 0):
                    seen[st["name"]] = st
        return sorted(
            (st for name, st in seen.items()
             if counts[name] * 2 > responding),
            key=lambda s: s["name"])

    def bucket_exists(self, bucket: str) -> bool:
        """True if any reachable disk has the bucket and no not-found
        majority exists (reads tolerate offline disks; ref getBucketInfo
        first-healthy-disk semantics, cmd/erasure-bucket.go)."""
        _, errs = parallel_map(
            [lambda d=d: d.stat_volume(bucket) for d in self.disks])
        ok = sum(1 for e in errs if e is None)
        not_found = sum(1 for e in errs
                        if isinstance(e, serr.VolumeNotFound))
        return ok >= 1 and not_found <= len(self.disks) // 2

    @staticmethod
    def _check_not_reserved(bucket: str) -> None:
        """The system namespace is never reachable through the object API
        (ref isReservedOrInvalidBucket checks on every handler)."""
        if bucket == MINIO_META_BUCKET or bucket.startswith(
                MINIO_META_BUCKET + "/"):
            raise BucketNotFound(bucket)

    def _raise_if_bucket_gone(self, errs, bucket: str, *,
                              for_write: bool = False,
                              wq: int | None = None) -> None:
        """Map VolumeNotFound evidence to NoSuchBucket instead of a
        quorum 5xx (ref toObjectErr mapping errVolumeNotFound ->
        BucketNotFound, cmd/typed-errors.go).

        Reads require a MAJORITY of missing volumes — agreeing with
        bucket_exists and the make/delete-bucket quorum, so a settled
        bucket never reads as both present and gone. Writes map a
        write-quorum of VolumeNotFound to NoSuchBucket (the reference's
        reduceWriteQuorumErrs bar); BELOW that bar a partial
        VolumeNotFound is ambiguous — freshly wiped disks awaiting heal
        (bucket exists; the quorum error is retryable) vs a racing
        delete_bucket mid-flight (will finish or roll back within
        moments) — so the write path lets the race settle and takes the
        majority vote before deciding."""
        vnf = sum(1 for e in errs if isinstance(e, serr.VolumeNotFound))
        if vnf == 0:
            return
        n = len(self.disks)
        if not for_write:
            if vnf >= n // 2 + 1:
                raise BucketNotFound(bucket)
            return
        if wq is None:
            wq = write_quorum(self.k, self.m)
        ok = sum(1 for e in errs if e is None)
        if ok >= wq:
            # The write LANDED despite stray VolumeNotFound disks (e.g.
            # a wiped replacement awaiting heal): no settle, no stall —
            # the per-write cost of this helper must be zero in the
            # steady degraded state.
            return
        if vnf >= wq:
            raise BucketNotFound(bucket)
        time.sleep(0.05)
        # Decisive only on a RESPONDING majority saying the volume is
        # absent; zero responders is an outage (retryable 5xx), not 404.
        _, st = parallel_map(
            [lambda d=d: d.stat_volume(bucket) for d in self.disks])
        absent = sum(1 for e in st if isinstance(e, serr.VolumeNotFound))
        if absent >= n // 2 + 1:
            raise BucketNotFound(bucket)

    def guard_commit_bucket_gone(self, errs, bucket: str,
                                 object_name: str, version_id: str, *,
                                 wq: int | None = None) -> None:
        """Commit-path wrapper over _raise_if_bucket_gone: when the
        bucket vanished mid-commit, UNDO the copies that landed (disks
        where errs[i] is None) before re-raising — 1-copy danglers
        would otherwise block the racing delete_bucket with a phantom
        "not empty". Shared by put_object, the delete-marker write and
        complete_multipart_upload."""
        try:
            self._raise_if_bucket_gone(errs, bucket, for_write=True,
                                       wq=wq)
        except BucketNotFound:
            undo_fi = FileInfo(volume=bucket, name=object_name,
                               version_id=version_id)
            parallel_map(
                [lambda d=d: d.delete_version(bucket, object_name,
                                              undo_fi)
                 for d, e in zip(self.disks, errs) if e is None])
            raise

    def _check_bucket(self, bucket: str) -> None:
        self._check_not_reserved(bucket)
        if not self.bucket_exists(bucket):
            raise BucketNotFound(bucket)

    # ------------------------------------------------------------------
    # write path

    def codec_for(self, k: int, m: int, block_size: int | None = None,
                  algorithm: str | None = None):
        """Codec for a per-object geometry (storage class may override
        the set default parity, ref GetParityForSC,
        cmd/config/storageclass/storage-class.go; old objects may also
        carry a different block size) and erasure algorithm (the REGEN
        storage class stamps pm-mbr-rbt in xl.meta; absent/rs means
        plain RS, so every pre-REGEN object resolves unchanged)."""
        algo = algorithm or ERASURE_ALGORITHM
        bs = self.block_size if block_size is None else block_size
        if (k, m, bs, algo) == (self.k, self.m, self.block_size,
                                ERASURE_ALGORITHM):
            return self.codec
        key = (k, m, bs, algo)
        codec = self._codec_cache.get(key)
        if codec is None:
            from .codec import codec_for_algorithm
            codec = codec_for_algorithm(
                algo, k, m, bs, backend=self.backend,
                # Per-object geometries still dispatch from THIS set:
                # they share its home device.
                affinity=getattr(self, "device_affinity", None),
                device=self.device)
            self._codec_cache[key] = codec
        return codec

    def put_object(self, bucket: str, object_name: str, data,
                   metadata: dict | None = None,
                   versioned: bool = False,
                   parity_shards: int | None = None,
                   algorithm: str | None = None) -> ObjectInfo:
        """Streaming block pipeline (ref Erasure.Encode block loop,
        cmd/erasure-encode.go:73-109 + parallelWriter :36-70): `data` is
        bytes OR a chunk reader/iterable. The stream is consumed in
        multiples of block_size, each batch erasure-encoded in one
        (TPU-batched) dispatch, bitrot-wrapped, and appended to the k+m
        staged shard files under write-quorum tolerance — peak memory is
        O(batch), never O(object)."""
        from ..utils import streams
        self._check_bucket(bucket)
        n = len(self.disks)
        m = self.m if parity_shards is None else parity_shards
        if not (0 < m <= n // 2):
            raise ValueError(f"parity {m} out of range for {n} disks")
        k = n - m
        codec = self.codec_for(k, m, algorithm=algorithm)
        distribution = hash_order(f"{bucket}/{object_name}", n)
        wq = write_quorum(k, m)
        reader = streams.ensure_reader(data)

        version_id = new_version_id() if versioned else ""
        data_dir = new_data_dir()
        tmp_id = str(uuid.uuid4())
        tmp_path = f"{TMP_PATH}/{tmp_id}"
        shard_rel = f"{tmp_path}/{data_dir}/part.1"
        mod_time = now()

        # Reuse the hash a verifying reader already computes over the
        # consumed stream; otherwise tee our own (etag = md5 of stored
        # bytes).
        md5 = None if hasattr(reader, "etag") else hashlib.md5()
        total = 0
        # Failed writers are nilled out and skipped for the rest of the
        # stream; quorum is re-checked per batch (ref parallelWriter
        # degradation + reduceWriteQuorumErrs, cmd/erasure-encode.go:56-70).
        alive = [True] * n
        disk_errs: list = [None] * n
        # Quarantined drives are skipped up front (degraded write):
        # their shards ride the same dead-disk path below — tmp
        # cleanup + MRF heal requeue — so the object converges back to
        # full redundancy once the drive is reinstated.
        self._quarantine_skip(alive, disk_errs, wq)

        # Recovery breadcrumb: the first shard append per disk drops
        # intent.json into the staging dir (riding the existing write
        # fan-out — no extra parallel round on the PUT hot path; the
        # 6-thunk parallel_map scheduler cost alone measured 3-20ms on
        # this box). Best-effort: a disk that can't take the intent
        # will fail its shard append right after and ride the normal
        # dead-disk path.
        intent_blob = _stage_intent_blob(bucket, object_name,
                                         version_id, data_dir)
        intent_rel = f"{tmp_path}/{INTENT_FILE}"
        wrote_intent = [False] * n

        def _intent_first(i: int) -> None:
            if wrote_intent[i]:
                return
            wrote_intent[i] = True
            try:
                self.disks[i].append_file(MINIO_META_BUCKET,
                                          intent_rel, intent_blob)
            except Exception:
                pass

        def append_one(i: int, payload: bytes, parent=None):
            _intent_first(i)
            if parent is None:  # untraced fast path
                self.disks[i].append_file(MINIO_META_BUCKET, shard_rel,
                                          payload)
                return
            # Explicit parent: parallel_map workers don't inherit the
            # request thread's contextvar; entering this span seeds it
            # so nested disk/RPC spans stitch under the right write.
            from ..obs.span import TRACER
            with TRACER.span("ec.shard_write", parent=parent, disk=i,
                             endpoint=str(self.disks[i]),
                             bytes=len(payload)):
                self.disks[i].append_file(MINIO_META_BUCKET, shard_rel,
                                          payload)

        def cleanup_tmp(indices):
            parallel_map([
                lambda i=i: self.disks[i].delete(
                    MINIO_META_BUCKET, tmp_path, recursive=True)
                for i in indices])

        from ..obs.span import TRACER
        from ..utils.phasetimer import PUT as _PUT

        def quorum_msg() -> str:
            causes = "; ".join(
                f"disk{i}: {type(e).__name__}: {e}"
                for i, e in enumerate(disk_errs)
                if e is not None)
            return ("write quorum lost mid-stream "
                    f"({sum(alive)}/{n}, need {wq}): {causes}")

        try:
            # Staging happens OUTSIDE the namespace lock: a slow
            # client-paced stream must not block readers of the key.
            # Only the commit below takes the write lock (ref NSLock
            # placement just before the metadata write + rename,
            # cmd/erasure-object.go:694-700).
            total, _t_enc, _t_wr = self._stream_shard_writes(
                reader, k, m, codec, distribution, append_one,
                alive, disk_errs, wq, quorum_msg, md5)
            # A hash-verifying reader raises here when the declared
            # md5/sha256/size doesn't match what streamed through —
            # the staged shards are discarded, nothing committed
            # (ref pkg/hash/reader.go verification at EOF).
            if hasattr(reader, "verify"):
                reader.verify()
            # Crash window: every shard staged, nothing committed — a
            # death here must leave the old version (or 404) intact
            # and the stages for the boot sweep.
            FAULTS.crash_point(CRASH_PUT_STAGED)

            etag = reader.etag() if md5 is None else md5.hexdigest()
            meta = dict(metadata or {})
            meta["etag"] = etag
            part = ObjectPartInfo(number=1, size=total,
                                  actual_size=total, etag=etag)

            def commit_one(i: int, parent=None):
                if not alive[i]:
                    raise disk_errs[i]
                if parent is not None:
                    from ..obs.span import TRACER as _TR
                    with _TR.span("ec.shard_commit", parent=parent,
                                  disk=i, endpoint=str(self.disks[i])):
                        return _commit_inner(i)
                return _commit_inner(i)

            def _commit_inner(i: int):
                fi = FileInfo(
                    volume=bucket, name=object_name,
                    version_id=version_id,
                    data_dir=data_dir if total > 0 else "",
                    size=total, mod_time=mod_time, metadata=meta,
                    parts=[part],
                    erasure=ErasureInfo(
                        algorithm=algorithm or ERASURE_ALGORITHM,
                        data_blocks=k, parity_blocks=m,
                        block_size=self.block_size,
                        index=distribution[i],
                        distribution=list(distribution),
                        checksums=[{
                            "part": 1,
                            "algorithm": bitrot.DEFAULT_ALGORITHM,
                            "hash": ""}],
                    ),
                )
                try:
                    self.disks[i].rename_data(
                        MINIO_META_BUCKET, tmp_path, fi,
                        bucket, object_name)
                except BaseException:
                    try:
                        self.disks[i].delete(MINIO_META_BUCKET,
                                             tmp_path, recursive=True)
                    except Exception:
                        pass
                    raise
                return fi

            # Exclusive commit: the lock covers only metadata write +
            # rename, not the body transfer.
            _t2 = time.perf_counter()
            with self.ns_lock.write_locked(bucket, object_name):
                with TRACER.span("ec.commit") as _cs:
                    _, errs = parallel_map(
                        [lambda i=i: commit_one(i, _cs)
                         for i in range(n)])
                self.guard_commit_bucket_gone(errs, bucket,
                                              object_name, version_id,
                                              wq=wq)
                reduce_quorum_errs(errs, wq, "put_object")
                # Crash window: quorum-committed, but dead-disk stage
                # cleanup + MRF requeue haven't run — a death here
                # must serve the NEW version on restart, with the boot
                # sweep GC-ing the leftovers and requeueing the heal.
                FAULTS.crash_point(CRASH_PUT_COMMITTED)
            _PUT.record("engine_commit",
                        (time.perf_counter() - _t2) * 1e3)
            _PUT.record("engine_encode", _t_enc * 1e3)
            _PUT.record("engine_write", _t_wr * 1e3)
        except BaseException:
            # Don't leak staged shards (the reference deletes the
            # tmp prefix on every error path).
            cleanup_tmp(range(n))
            raise
        # Failed disks keep no stage and feed the MRF heal queue
        # (ref addPartial, cmd/erasure-object.go:1082).
        dead = [i for i in range(n) if errs[i] is not None]
        if dead:
            cleanup_tmp(dead)
            self.mrf.add(bucket, object_name)
        self._mark_update(bucket, object_name)
        # Write-through invalidation: drop every cached decoded copy
        # of the old version, locally and (async) on every peer.
        from ..cache.hotcache import HOTCACHE
        HOTCACHE.invalidate(bucket, object_name)
        return ObjectInfo(bucket=bucket, name=object_name, size=total,
                          etag=etag, mod_time=mod_time,
                          version_id=version_id, metadata=meta,
                          parts=[part])

    def _stream_shard_writes(self, reader, k: int, m: int, codec,
                             distribution, append_shard, alive,
                             disk_errs, wq: int, quorum_msg, md5,
                             name: str = "put",
                             ) -> tuple[int, float, float]:
        """The pipelined PUT/part data plane (shared by put_object and
        multipart.put_object_part): consume `reader` in encode batches;
        while batch N's k+m shards fan out to disks, batch N+1 is
        already being read from the client and erasure-encoded on the
        pipeline's worker thread (utils/pipeline.py, bounded depth —
        at most depth+1 encoded batches alive). Write quorum is
        re-checked per batch at the join point, exactly as the serial
        loop did. A single-batch stream (object <= put_batch_bytes)
        never starts the worker: small PUTs stay thread-free.

        append_shard(disk_index, payload, parent_span) performs one
        shard append; alive/disk_errs are the caller's per-disk
        degradation state (mutated in place); quorum_msg() renders the
        caller's quorum-loss error text.

        Returns (total_bytes, encode_seconds, write_seconds) — the two
        phase sums overlap under the pipeline, so their total may
        exceed wall time (that ratio is the bench's overlap factor).
        """
        from ..obs.span import TRACER
        from ..utils import streams
        from ..utils.pipeline import Prefetch
        n = k + m
        shard_size = codec.shard_size()
        root = TRACER.current()
        state = {"total": 0, "enc_s": 0.0, "wr_s": 0.0}

        def encode_one(batch: bytes):
            t0 = time.perf_counter()
            with TRACER.span("ec.encode", parent=root,
                             bytes=len(batch)):
                # The etag md5 overlaps the erasure encode on multicore
                # hosts: both walk the same batch, md5 releases the GIL
                # on big buffers, and stream order is preserved because
                # each batch joins before the next submits (~1.7ms off
                # a 1MiB PUT's critical path).
                md5_fut = (submit(md5.update, batch)
                           if md5 is not None and MULTICORE else None)
                if md5 is not None and md5_fut is None:
                    md5.update(batch)
                state["total"] += len(batch)
                full_sm, tails = self._encode_batch_split(batch, k, m,
                                                          codec)
                framed = None
                if self.backend != "auto" or (
                        full_sm is not None and bitrot._device_hash_ok(
                            bitrot.DEFAULT_ALGORITHM, shard_size,
                            full_sm.nbytes)):
                    # Device bitrot stays one coalesced dispatch over
                    # all shards; per-shard hashing in the writer
                    # fan-out would fragment it below the threshold.
                    # A pinned engine always frames here: one dispatch
                    # per batch, the tail block's included.
                    framed = self._frame_split(full_sm, tails, codec)
                if md5_fut is not None:
                    md5_fut.result()
            state["enc_s"] += time.perf_counter() - t0
            return len(batch), full_sm, tails, framed

        def write_batch(item) -> None:
            nbytes, full_sm, tails, framed = item
            t1 = time.perf_counter()
            live = [i for i in range(n) if alive[i]]
            with TRACER.span("ec.write", bytes=nbytes) as _ws:
                def one(i: int) -> None:
                    j = distribution[i] - 1
                    if framed is not None:
                        payload = framed[j]
                    else:
                        # Host bitrot rides the writer fan-out: the
                        # hash of shard j (GIL-released native kernel)
                        # overlaps the disk writes of the other shards.
                        payload = bitrot.frame_shard(
                            None if full_sm is None else full_sm[j],
                            None if tails is None else tails[j],
                            device=self.bitrot_device)
                    append_shard(i, payload, _ws)
                _, errs = parallel_map(
                    [lambda i=i: one(i) for i in live])
            state["wr_s"] += time.perf_counter() - t1
            for i, e in zip(live, errs):
                if e is not None:
                    alive[i] = False
                    disk_errs[i] = e
            if sum(alive) < wq:
                raise QuorumError(
                    quorum_msg(),
                    [e for e in disk_errs if e is not None])

        per = streams.batch_size(self.block_size, self.put_batch_bytes)
        first = streams.read_exactly(reader, per)
        if not first:
            return 0, 0.0, 0.0
        # One-byte lookahead: a stream of EXACTLY one full batch must
        # also take the inline path — without it, an 8MiB part would
        # spin up the worker for a single item. The probe blocks no
        # longer than the next batch read would have.
        probe = b"" if len(first) < per else streams.read_exactly(
            reader, 1)
        if len(first) < per or not probe:
            # The whole stream fit in one batch: encode + write inline
            # on the request thread (no worker, no queue — a small PUT
            # must not pay a thread handoff for nothing to overlap).
            write_batch(encode_one(first))
            return state["total"], state["enc_s"], state["wr_s"]
        batches = streams.iter_batches(
            streams.PushbackReader(probe, reader), self.block_size,
            self.put_batch_bytes)

        def produce():
            yield encode_one(first)
            for batch in batches:
                yield encode_one(batch)

        with Prefetch(produce(), depth=self.pipeline_depth,
                      name=name, span=root) as pf:
            for item in pf:
                write_batch(item)
        return state["total"], state["enc_s"], state["wr_s"]

    def _encode_batch_split(self, data: bytes, k: int, m: int, codec,
                            ) -> tuple:
        """RS-encode one batch WITHOUT bitrot framing: returns
        (full_sm, tails) where full_sm is a shard-major
        (k+m, n_blocks, shard_size) uint8 array of the full blocks'
        shards (None when the batch is shorter than one block) and
        tails the k+m per-shard byte strings of the final short block
        (None when the batch is block-aligned). Framing happens either
        centrally (_frame_split — the device-hash path) or per shard
        in the writer fan-out (bitrot.frame_shard)."""
        n = k + m
        if len(data) == 0:
            return None, None
        from ..obs.span import TRACER
        if getattr(codec, "is_regen", False):
            # REGEN encode: no k-way pre-split — the product-matrix
            # code consumes raw block bytes (pack_blocks_batch stripes
            # them B-wide) and emits n equal non-systematic chunks.
            # Same (full_sm, tails) contract, so framing and the
            # writer fan-out are untouched.
            with TRACER.span("kernel.regen_encode", bytes=len(data),
                             k=k, m=m):
                full_sm = None
                nfull = len(data) // self.block_size
                if nfull:
                    full = np.frombuffer(
                        data[:nfull * self.block_size], dtype=np.uint8,
                    ).reshape(nfull, self.block_size)
                    full_sm = codec.encode_blocks_batch_bytes(full)
                rest = data[nfull * self.block_size:]
                tails = None
                if rest:
                    shards = codec.encode_data(rest)
                    tails = [shards[j].tobytes()
                             for j in range(codec.total_shards)]
                return full_sm, tails
        with TRACER.span("kernel.rs_encode", bytes=len(data),
                         k=k, m=m):
            shard_size = codec.shard_size()
            full_sm = None
            nfull = len(data) // self.block_size
            if nfull:
                # Each block is zero-padded to k*shard_size (split
                # padding semantics, ref dependency Split of
                # cmd/erasure-coding.go:74).
                full = np.frombuffer(
                    data[:nfull * self.block_size], dtype=np.uint8,
                ).reshape(nfull, self.block_size)
                if self.block_size != k * shard_size:
                    padded = np.zeros((nfull, k * shard_size),
                                      dtype=np.uint8)
                    padded[:, :self.block_size] = full
                    full = padded
                full = full.reshape(nfull, k, shard_size)
                # Shard-major framing: each full block is exactly one
                # bitrot sub-block, so (n_blocks, S) rows frame
                # directly — no per-shard byte reassembly.
                full_sm = codec.encode_blocks_batch_shardmajor(full)
            rest = data[nfull * self.block_size:]
            tails = None
            if rest:
                shards = codec.encode_data(rest)
                tails = [shards[j].tobytes() for j in range(n)]
            return full_sm, tails

    def _frame_split(self, full_sm, tails, codec) -> list:
        """Bitrot-frame a split-encoded batch into per-shard chunks —
        byte-identical to the pre-split _encode_batch output (golden
        tests): consecutive batches concatenate into a valid
        streaming-bitrot shard file (ref cmd/bitrot-streaming.go:46)."""
        shard_size = codec.shard_size()
        full_frames = None
        if full_sm is not None:
            full_frames = bitrot.encode_stream_arrays(
                list(full_sm), device=self.bitrot_device)
        if tails is None:
            return full_frames
        tail_frames = bitrot.encode_streams(tails, shard_size,
                                            device=self.bitrot_device)
        if full_frames is None:
            return tail_frames
        return [np.concatenate([ff, np.frombuffer(tf, np.uint8)])
                for ff, tf in zip(full_frames, tail_frames)]

    def _encode_batch(self, data: bytes, k: int | None = None,
                      m: int | None = None,
                      codec=None) -> list[bytes]:
        """Encode one batch (a multiple of block_size, except a final
        short tail) into k+m bitrot-wrapped shard chunks: one batched
        device dispatch for the full blocks (ref EncodeData per block,
        cmd/erasure-encode.go:80 — here many blocks per dispatch), host
        encode for the tail. Chunk framing aligns with shard_size
        sub-blocks, so consecutive batches concatenate into a valid
        streaming-bitrot shard file (ref cmd/bitrot-streaming.go:46)."""
        k = self.k if k is None else k
        m = self.m if m is None else m
        codec = self.codec if codec is None else codec
        n = k + m
        if len(data) == 0:
            return [b""] * n
        # The kernel child span (RS math + any coalescer window wait)
        # opens inside _encode_batch_split; which device actually ran
        # it is in the kernel counters (obs/kernel_stats.py).
        full_sm, tails = self._encode_batch_split(data, k, m, codec)
        return self._frame_split(full_sm, tails, codec)

    def _encode_object(self, data: bytes, k: int | None = None,
                       m: int | None = None,
                       codec=None) -> list[bytes]:
        """Whole-object encode -> k+m bitrot-wrapped shard streams
        (multipart parts and heal re-encode, which already hold the
        part in memory)."""
        return self._encode_batch(data, k, m, codec)

    # ------------------------------------------------------------------
    # read path

    def _read_file_infos(self, bucket: str, object_name: str,
                         version_id: str = "",
                         ) -> tuple[list[FileInfo | None], list]:
        # Quarantined drives serve NO data-plane reads — the metadata
        # fan-out included (parallel_map joins every thunk, so one
        # quarantined-and-stalling drive would drag every stat/GET).
        # They answer as pre-failed; the quorum math treats that like
        # any other down disk.
        from ..obs.drivemon import DRIVEMON

        def one(i: int):
            if DRIVEMON.is_quarantined(self.endpoints[i]):
                raise serr.DriveQuarantined(self.endpoints[i])
            return self.disks[i].read_version(bucket, object_name,
                                              version_id)

        results, errs = parallel_map(
            [lambda i=i: one(i) for i in range(len(self.disks))])
        fis = [r if e is None else None for r, e in zip(results, errs)]
        # Availability over hygiene: when the healthy drives alone
        # can't produce k readable shards (quarantine plus a real
        # failure), the quarantined drives ARE the remaining copies —
        # probe them after all, serially (they may stall; never let
        # them drag the healthy fan-out's join). Without this second
        # pass the shard map never includes a quarantined drive and
        # _read_order's last-resort re-entry has nothing to extend
        # with — m+1 quarantined drives would fail every GET in the
        # set despite byte-exact data. A healthy disk answering a
        # namespace miss is DEFINITIVE (the object simply isn't
        # there) — without that guard every 404-path request would
        # block on a possibly-hung quarantined drive, the exact stall
        # the pre-fail above exists to avoid (same policy as
        # iam.ConfigStore).
        definitive = (serr.FileNotFound, serr.VersionNotFound,
                      serr.VolumeNotFound)
        if (sum(f is not None for f in fis) < self.k
                and not any(isinstance(e, definitive) for e in errs)):
            for i, e in enumerate(errs):
                if not isinstance(e, serr.DriveQuarantined):
                    continue
                try:
                    fis[i] = self.disks[i].read_version(
                        bucket, object_name, version_id)
                    errs[i] = None
                except Exception as e2:  # keep the quorum math exact
                    errs[i] = e2
        return fis, errs

    def _quorum_file_info(self, bucket: str, object_name: str,
                          version_id: str = "", *,
                          reduce_notfound: bool = True,
                          ) -> tuple[FileInfo, list[FileInfo | None]]:
        """FileInfo agreed by >= read-quorum disks (ref
        findFileInfoInQuorum, cmd/erasure-metadata.go).

        reduce_notfound: serving paths map a not-found majority to
        ObjectNotFound (ref reduceReadQuorumErrs + errFileNotFound,
        cmd/erasure-object.go:388-391); the HEALER passes False so a
        below-quorum straggler copy surfaces as QuorumError and gets
        classified dangling instead of skipped."""
        fis, errs = self._read_file_infos(bucket, object_name, version_id)
        nf = sum(1 for e in errs if isinstance(
            e, (serr.FileNotFound, serr.VersionNotFound)))
        if all(f is None for f in fis):
            if nf < read_quorum(self.k):
                # Disks failed with REAL errors (IO, unmounted) and
                # fewer than a read quorum said not-found: a backend
                # outage is unavailability, not a 404 — unless the
                # BUCKET itself is gone (racing delete-bucket).
                self._raise_if_bucket_gone(errs, bucket)
                raise QuorumError(
                    f"all disks failed reading {bucket}/{object_name}",
                    list(errs))
            if any(isinstance(e, serr.VersionNotFound) for e in errs):
                raise ObjectNotFound(f"{bucket}/{object_name}@{version_id}")
            raise ObjectNotFound(f"{bucket}/{object_name}")
        groups: dict[tuple, list[int]] = {}
        for i, fi in enumerate(fis):
            if fi is not None:
                groups.setdefault(fi.quorum_key(), []).append(i)
        key, members = max(groups.items(), key=lambda kv: len(kv[1]))
        fi = fis[members[0]]
        rq = read_quorum(fi.erasure.data_blocks or self.k)
        if len(members) < rq:
            # Reduce read errors before quorum-failing (ref
            # reduceReadQuorumErrs + the errFileNotFound mapping,
            # cmd/erasure-object.go:388-391): when enough disks agree
            # the key is ABSENT — a lock-free stat racing a delete or a
            # commit — that's not-found (404), not a 5xx. The healer
            # opts out so straggler copies classify dangling.
            if reduce_notfound and nf >= rq:
                raise ObjectNotFound(f"{bucket}/{object_name}")
            self._raise_if_bucket_gone(errs, bucket)
            raise QuorumError(
                f"metadata quorum not met for {bucket}/{object_name} "
                f"({len(members)}/{len(self.disks)}, need {rq})",
                list(errs))
        # Null out disks outside the quorum group.
        agreed = [fis[i] if i in members else None
                  for i in range(len(fis))]
        return fi, agreed

    def _uncached_info(self, bucket: str, object_name: str,
                       ) -> ObjectInfo:
        """Metadata-quorum ObjectInfo bypassing the hot-object cache —
        the cache's ETag-revalidation oracle (calling the public stat
        would recurse straight back into the cache)."""
        with self.ns_lock.read_locked(bucket, object_name):
            fi, _ = self._quorum_file_info(bucket, object_name)
        if fi.deleted:
            raise ObjectNotFound(f"{bucket}/{object_name}")
        return ObjectInfo.from_file_info(fi)

    def get_object_info(self, bucket: str, object_name: str,
                        version_id: str = "") -> ObjectInfo:
        from ..cache.hotcache import HOTCACHE
        if HOTCACHE.enabled and not version_id:
            # Memory-tier stat: a hot GET's HEAD/stat half also skips
            # the metadata fan-out (latest-only; versioned stats take
            # the quorum path below).
            info = HOTCACHE.lookup_info(
                self.cache_ns, bucket, object_name,
                lambda: self._uncached_info(bucket, object_name))
            if info is not None:
                return info
        self._check_bucket(bucket)
        # Same read lock as the data path: a stat racing a concurrent
        # commit/delete must see before-or-after state, never the
        # mid-parallel-write mixture (ref getObjectInfo taking the
        # shared ns lock, cmd/erasure-object.go:383).
        with self.ns_lock.read_locked(bucket, object_name):
            fi, _ = self._quorum_file_info(bucket, object_name,
                                           version_id)
        if fi.deleted:
            if version_id:
                raise MethodNotAllowed(f"{bucket}/{object_name}")
            raise ObjectNotFound(f"{bucket}/{object_name}")
        return ObjectInfo.from_file_info(fi)

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1, version_id: str = "",
                   ) -> tuple[bytes, ObjectInfo]:
        info, stream = self.get_object_stream(bucket, object_name,
                                              offset, length, version_id)
        return b"".join(stream), info

    def get_object_stream(self, bucket: str, object_name: str,
                          offset: int = 0, length: int = -1,
                          version_id: str = "",
                          ) -> tuple[ObjectInfo, "object"]:
        """(info, chunk iterator) — the streaming GET: blocks are
        fetched, bitrot-verified, and reconstructed group-by-group, so
        peak memory is O(group), never O(range) (ref blockwise decode,
        cmd/erasure-decode.go:248-263). The read lock is held for the
        stream's lifetime, like the reference holds its read lock across
        the response write (cmd/erasure-object.go:134); exhaust or
        close() the iterator to release it.

        The hot-object cache is consulted twice (cache/hotcache.py):
        a tier hit up front serves decoded bytes with NO disk I/O at
        all; past the metadata quorum read, a concurrent fill of the
        same key+etag is joined (coalesced wait — N cold GETs of one
        hot key perform exactly one shard fan-out + decode), and a
        full-object read registers itself as the single-flight fill."""
        from ..cache.hotcache import HOTCACHE
        if HOTCACHE.enabled and not version_id:
            served = HOTCACHE.serve(
                self.cache_ns, bucket, object_name, offset, length,
                lambda: self._uncached_info(bucket, object_name))
            if served is not None:
                return served
        self._check_bucket(bucket)
        # The read lock covers metadata + data so a concurrent overwrite
        # cannot swap the data dir between the two reads.
        ctx = self.ns_lock.read_locked(bucket, object_name)
        ctx.__enter__()
        try:
            fi, agreed = self._quorum_file_info(bucket, object_name,
                                                version_id)
            if fi.deleted:
                if version_id:
                    raise MethodNotAllowed(f"{bucket}/{object_name}")
                raise ObjectNotFound(f"{bucket}/{object_name}")
            info = ObjectInfo.from_file_info(fi)
            if offset < 0 or offset > fi.size:
                raise ValueError("invalid range")
            if length < 0:
                length = fi.size - offset
            if offset + length > fi.size:
                raise ValueError("invalid range")
            if length == 0 or fi.size == 0:
                ctx.__exit__(None, None, None)
                return info, iter(())
            if HOTCACHE.enabled and not version_id:
                cached = self._cache_fill_or_join(
                    ctx, fi, agreed, info, bucket, object_name,
                    offset, length)
                if cached is not None:
                    return cached
            gen = self._iter_ranges(fi, agreed, offset, length)
            return info, _LockedStream(ctx, gen)
        except BaseException:
            ctx.__exit__(None, None, None)
            raise

    def _cache_fill_or_join(self, ctx, fi, agreed, info, bucket: str,
                            object_name: str, offset: int, length: int):
        """Single-flight integration past the metadata read: join an
        in-flight fill of this key+etag (releasing our read lock — the
        filler's lock covers the data), or register as the fill when
        this is a cacheable full-object read. Returns (info, stream)
        or None to proceed with a plain erasure read."""
        from ..cache.hotcache import HOTCACHE

        def resume(pos: int, _off=offset, _len=length):
            # Waiter fallback when the fill dies under it: re-read the
            # remainder ourselves — but never stitch bytes of a
            # DIFFERENT object version onto what the waiter already
            # streamed.
            info2, stream = self.get_object_stream(
                bucket, object_name, offset=_off + pos,
                length=_len - pos)
            if info2.etag != fi.metadata.get("etag", ""):
                try:
                    stream.close()
                except Exception:
                    pass
                raise QuorumError(
                    f"{bucket}/{object_name} changed while a coalesced "
                    "read was streaming from a failed fill", [])
            return stream

        waiter = HOTCACHE.join_fill(
            self.cache_ns, bucket, object_name,
            fi.metadata.get("etag", ""), offset, length, resume)
        if waiter is not None:
            ctx.__exit__(None, None, None)
            return info, waiter
        if offset != 0 or length != fi.size:
            return None
        fill = HOTCACHE.begin_fill(self.cache_ns, bucket, object_name,
                                   info)
        if fill is None:
            return None
        handed = False
        try:
            rdr = fill.reader(
                self._iter_ranges(fi, agreed, 0, fi.size))
            handed = True
            return info, _LockedStream(ctx, rdr)
        finally:
            if not handed:
                fill.abort(RuntimeError("fill setup failed"))

    def _quarantine_skip(self, alive: list, disk_errs: list,
                         wq: int) -> list[int]:
        """Degraded write: pre-mark quarantined drives dead for a write
        fan-out, so their shards fall to the MRF heal queue exactly
        like a failed write would — but only while enough healthy
        drives remain for write quorum. With quorum at stake,
        availability wins and the quarantined drives are attempted
        anyway. Returns the skipped disk indices."""
        from ..obs.drivemon import DRIVEMON
        q = [i for i in range(len(self.disks))
             if alive[i] and DRIVEMON.is_quarantined(self.endpoints[i])]
        if not q or sum(alive) - len(q) < wq:
            return []
        for i in q:
            alive[i] = False
            disk_errs[i] = serr.DriveQuarantined(
                f"{self.endpoints[i]}: write skipped (quarantined)")
        return q

    def _read_order(self, by_shard: list[int | None], k: int,
                    m: int) -> list[int]:
        """Health-ranked shard read order: pick the k healthiest of
        k+m. Sort key is (health state, parity flag, read EWMA) — an
        OK data shard beats an OK parity shard (reading parity forces
        a reconstruct), and ANY healthy shard beats a suspect one (a
        reconstruct is cheaper than waiting on a dragging drive; the
        Mojette any-k-of-n argument, arXiv:1504.07038). Quarantined
        drives serve no data-plane reads at all — they re-enter only
        if exclusion would leave fewer than k readable shards
        (availability over hygiene)."""
        from ..obs.drivemon import DRIVEMON, OK, SUSPECT
        ranked: list[tuple] = []
        quarantined: list[int] = []
        for j, pos in enumerate(by_shard):
            if pos is None:
                continue
            ep = self.endpoints[pos]
            if DRIVEMON.is_quarantined(ep):
                quarantined.append(j)
                continue
            state = DRIVEMON.state_of(ep)
            srank = 0 if state == OK else (1 if state == SUSPECT else 2)
            ewma = DRIVEMON.ewma_for(ep).get("read", 0.0)
            ranked.append((srank, 0 if j < k else 1, ewma, j))
        ranked.sort()
        order = [t[3] for t in ranked]
        if len(order) < k:
            order.extend(quarantined)
        return order

    def _hedged_fetch(self, primary: list[int], spares: list[int],
                      fetch, win_off: int, n_cov: int, windows: dict,
                      k: int, parent_span) -> None:
        """Fan the k primary shard reads out, hedging stragglers: when
        the group hasn't assembled k windows within the adaptive
        budget (hedge_budget), backup reads of spare shards fire on
        the BACKGROUND QoS lane — they defer to foreground kernel
        work, so hedges can never amplify an overload. First response
        wins; straggler futures are cancelled if unstarted, otherwise
        their late results are simply discarded (the group only ever
        consumes k verified windows)."""
        from concurrent.futures import FIRST_COMPLETED
        from concurrent.futures import wait as _fwait
        from ..obs.metrics2 import METRICS2
        from ..qos.scheduler import BACKGROUND, lane_scope
        budget_s = self.hedge_budget.budget()
        METRICS2.set_gauge("minio_tpu_v2_hedge_budget_ms", None,
                           round(budget_s * 1e3, 3))
        pending = {submit(lambda j=j: fetch(j, win_off, n_cov, windows))
                   for j in primary}
        hedge_futs: dict = {}
        deadline = time.monotonic() + budget_s
        while pending:
            if len(windows) >= k:
                break
            timeout = (None if hedge_futs else
                       max(0.0, deadline - time.monotonic()))
            _done, pending = _fwait(pending, timeout=timeout,
                                    return_when=FIRST_COMPLETED)
            if (not hedge_futs and pending and spares
                    and len(windows) < k
                    and time.monotonic() >= deadline):
                need = min(len(pending), len(spares),
                           k - len(windows))
                fired = spares[:need]
                for j in fired:
                    def hedge(j=j):
                        with lane_scope(BACKGROUND):
                            return fetch(j, win_off, n_cov, windows)
                    hedge_futs[submit(hedge)] = j
                    METRICS2.inc("minio_tpu_v2_hedged_reads_total",
                                 {"result": "fired"})
                if parent_span is not None:
                    parent_span.add_event(
                        "ec.hedge", shards=list(fired),
                        budget_ms=round(budget_s * 1e3, 1))
                pending |= set(hedge_futs)
        for f in pending:
            f.cancel()
        if hedge_futs:
            # Outcome accounting for the bench's wasted-read fraction:
            # a hedge "won" when it filled a slot a straggling primary
            # never did; completed hedges beyond that were wasted I/O.
            missing = sum(1 for j in primary if j not in windows)
            won = 0
            for f, j in hedge_futs.items():
                if not f.done() or f.cancelled():
                    continue
                if j in windows and won < missing:
                    won += 1
                    METRICS2.inc("minio_tpu_v2_hedged_reads_total",
                                 {"result": "won"})
                else:
                    METRICS2.inc("minio_tpu_v2_hedged_reads_total",
                                 {"result": "wasted"})

    def _shard_readers(self, fi: FileInfo,
                       agreed: list[FileInfo | None]) -> list[int | None]:
        """Map shard index j (0-based) -> disk position, using each disk's
        own erasure.index from its metadata."""
        n = self.k + self.m
        by_shard: list[int | None] = [None] * n
        for i, f in enumerate(agreed):
            if f is not None and 1 <= f.erasure.index <= n:
                by_shard[f.erasure.index - 1] = i
        return by_shard

    def _iter_ranges(self, fi: FileInfo,
                     agreed: list[FileInfo | None],
                     offset: int, length: int):
        """Walk the object's parts, streaming the covered range from
        each (multipart objects carry one erasure-coded shard file per
        part, ref cmd/erasure-object.go:240 per-part loop)."""
        parts = fi.parts or [ObjectPartInfo(number=1, size=fi.size,
                                            actual_size=fi.size)]
        failed: set[int] = set()
        pos = 0
        for p in parts:
            part_start, part_end = pos, pos + p.size
            pos = part_end
            if part_end <= offset or part_start >= offset + length:
                continue
            local_off = max(0, offset - part_start)
            local_len = min(part_end, offset + length) - (
                part_start + local_off)
            yield from self._iter_part_range(fi, agreed, p.number,
                                             p.size, local_off,
                                             local_len, failed)

    def _read_and_decode(self, fi: FileInfo,
                         agreed: list[FileInfo | None],
                         offset: int, length: int) -> bytes:
        return b"".join(self._iter_ranges(fi, agreed, offset, length))

    def _iter_part_range(self, fi: FileInfo,
                         agreed: list[FileInfo | None],
                         part_number: int, part_size: int,
                         offset: int, length: int,
                         failed: set[int]):
        """Yield decoded plaintext of [offset, offset+length) within one
        part, group-by-group: shard windows covering a bounded group of
        blocks are fetched in parallel, verified, and reconstructed, so
        memory stays O(group) for any range (ref the per-block decode
        loop, cmd/erasure-decode.go:248-263)."""
        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        shard_size = fi.erasure.shard_size()
        by_shard = self._shard_readers(fi, agreed)
        # Codec geometry AND algorithm come from the object's metadata
        # (they may differ from this engine's default — mixed-class
        # buckets hold RS and REGEN objects side by side).
        codec = self.codec_for(k, m, fi.erasure.block_size,
                               algorithm=fi.erasure.algorithm)
        is_regen = getattr(codec, "is_regen", False)

        # Block coverage of [offset, offset+length).
        start_block = offset // fi.erasure.block_size
        end_block = (offset + length - 1) // fi.erasure.block_size

        # Bitrot algorithm comes from the object's own metadata, not the
        # current default — framing stride depends on it.
        algo = bitrot.DEFAULT_ALGORITHM
        for cs in fi.erasure.checksums:
            if cs.get("part") == part_number:
                algo = cs.get("algorithm", algo)

        # Each full block contributes [hash][shard_size] to the shard
        # stream (ref streamingBitrotReader stream offset math,
        # cmd/bitrot-streaming.go:125). Whole-file (non-streaming)
        # algorithms have no interleaved hashes: stride is bare
        # shard_size and per-frame verify is skipped (their checksum
        # lives in metadata and is checked by verify_file deep scans).
        hsz = bitrot.hash_size(algo) if bitrot.is_streaming(algo) else 0
        stride = hsz + shard_size
        group = max(1, self.read_group_bytes // fi.erasure.block_size)
        # Health-ranked candidate order, computed once per part:
        # healthy data shards first, suspect/faulty drives demoted to
        # last resort, quarantined drives excluded (obs/drivemon.py).
        candidates = self._read_order(by_shard, k, m)

        want_end = offset + length

        from ..obs.span import TRACER
        # Captured ONCE on the consumer's thread: both the pipeline's
        # prefetch worker and parallel_map fetch workers attach their
        # shard-read spans to it (the contextvar doesn't cross threads).
        _read_parent = TRACER.current()

        def fetch(j: int, win_off: int, n_cov: int,
                  windows: dict) -> bool:
            """Fetch shard j's window for one group; False if
            unavailable. Successful read durations feed the hedge
            budget (the healthy-population percentile)."""
            if j in windows:
                return True
            if j in failed or by_shard[j] is None:
                return False
            disk = self.disks[by_shard[j]]
            f = agreed[by_shard[j]]
            rel = f"{fi.name}/{f.data_dir}/part.{part_number}"
            t0 = time.perf_counter()
            try:
                if _read_parent is None:
                    data = disk.read_file(fi.volume, rel, win_off,
                                          n_cov * stride)
                else:
                    with TRACER.span("ec.shard_read",
                                     parent=_read_parent, shard=j,
                                     endpoint=str(disk),
                                     bytes=n_cov * stride):
                        data = disk.read_file(fi.volume, rel, win_off,
                                              n_cov * stride)
            except Exception:
                failed.add(j)
                return False
            self.hedge_budget.observe(time.perf_counter() - t0)
            windows[j] = data
            return True

        def fetch_group(g0: int) -> tuple:
            """Stage 1 (pipeline producer): pull one group's shard
            windows — the k healthiest first (hedged against
            stragglers), then CONCURRENT fallback bursts bounded by
            how many shards are still missing, so a 2-lost read pays
            one extra read RTT instead of two sequential ones (ref
            parallelReader, cmd/erasure-decode.go:104)."""
            g1 = min(g0 + group - 1, end_block)
            n_cov = g1 - g0 + 1
            win_off = g0 * stride
            windows: dict[int, bytes] = {}
            order = [j for j in candidates if j not in failed]
            primary, spares = order[:k], order[k:]
            if self.hedge_enabled and spares and len(primary) == k:
                self._hedged_fetch(primary, spares, fetch, win_off,
                                   n_cov, windows, k, _read_parent)
            else:
                parallel_map(
                    [lambda j=j: fetch(j, win_off, n_cov, windows)
                     for j in primary])
            have = [j for j in candidates if j in windows]
            # Known-dead shards (condemned in an earlier group, or
            # with no mapped disk) would burn the first burst's slots
            # on instant-False fetches — the burst must hold real
            # parity reads.
            rest = [j for j in candidates
                    if j not in windows and j not in failed]
            while len(have) < k and rest:
                burst = rest[:k - len(have)]
                rest = rest[len(burst):]
                oks, _ = parallel_map(
                    [lambda j=j: fetch(j, win_off, n_cov, windows)
                     for j in burst])
                have.extend(j for j, ok in zip(burst, oks) if ok)
            if len(have) < k:
                raise QuorumError(
                    f"read quorum not met: only {len(have)}/{k} "
                    "shards readable", [])
            return g0, g1, n_cov, win_off, windows, have

        def decode_group(item):
            """Stage 2 (consumer): verify, reconstruct, and trim one
            fetched group; yields the plaintext chunks in range order."""
            g0, g1, n_cov, win_off, windows, have = item
            # Pass 1: gather + bitrot-verify every block's chunk in this
            # group (views into the fetched windows, no copies). All
            # frames of all fetched windows verify in ONE batched call —
            # bitrot.verify_frames coalesces equal-length frames into a
            # single device dispatch (the read half of the TPU bitrot
            # path; ref streamingBitrotReader verifies per chunk on the
            # CPU, cmd/bitrot-streaming.go:115).
            metas = []
            for b in range(g0, g1 + 1):
                blk_len = (min(fi.erasure.block_size,
                               part_size - b * fi.erasure.block_size))
                metas.append((b, blk_len, codec.chunk_size(blk_len)))

            frame_ok: dict[tuple[int, int], np.ndarray] = {}
            verified: set[int] = set()

            def verify_window(js: list[int]) -> None:
                """Batch-verify all frames of windows js; populate
                frame_ok, mark bad shards failed + heal-queued."""
                datas, wants, keys = [], [], []
                bad: set[int] = set()
                for j in js:
                    win = windows.get(j)
                    if win is None:
                        continue
                    for bi, (b, _bl, chunk) in enumerate(metas):
                        base = bi * stride
                        if len(win) < base + hsz + chunk:
                            bad.add(j)
                            continue
                        if bitrot.is_streaming(algo):
                            datas.append(np.frombuffer(
                                win, np.uint8, count=chunk,
                                offset=base + hsz))
                            wants.append(bytes(win[base:base + hsz]))
                            keys.append((j, b))
                        else:
                            frame_ok[(j, b)] = np.frombuffer(
                                win, np.uint8, count=chunk, offset=base)
                oks = bitrot.verify_frames(
                    datas, wants, algo, device=self.bitrot_device) \
                    if datas else []
                for (j, b), okv, raw in zip(keys, oks, datas):
                    if okv:
                        frame_ok[(j, b)] = raw
                    else:
                        bad.add(j)
                for j in js:
                    if j in bad:
                        # Drop the shard's surviving frames too: one
                        # rotten frame distrusts the whole window (the
                        # reference aborts the shard stream likewise).
                        for b, _bl, _c in metas:
                            frame_ok.pop((j, b), None)
                        failed.add(j)
                        windows.pop(j, None)
                        if j in have:
                            have.remove(j)
                        # heal required (ref errHealRequired ->
                        # deepHealObject, cmd/erasure-object.go:324)
                        self.mrf.add(fi.volume, fi.name)
                    elif j in windows:
                        verified.add(j)

            verify_window(list(have))
            # Top up: if corruption dropped us below k shards, pull in
            # spare candidates (parity first-fallback order) until k
            # verified windows exist or candidates run out.
            for j in candidates:
                if len(verified) >= k:
                    break
                if j not in verified and fetch(j, win_off, n_cov,
                                               windows):
                    verify_window([j])

            # (A vectorized group-gather fast path was tried here and
            # REVERTED: numpy's strided (n_cov, k, S) assignment
            # measured ~27% slower than the per-block tobytes+join
            # below on the host — bytes.join over contiguous views is
            # already near-memcpy speed.)
            gathered: list[tuple[int, int, list]] = []
            for b, blk_len, chunk in metas:
                shards: list[np.ndarray | None] = [None] * (k + m)
                good = 0
                for j in sorted(verified):
                    if good >= k:
                        break
                    raw = frame_ok.get((j, b))
                    if raw is not None:
                        shards[j] = raw
                        good += 1
                if good < k:
                    raise QuorumError(
                        f"block {b}: only {good}/{k} shards valid", [])
                gathered.append((b, blk_len, shards))

            if is_regen:
                # REGEN is non-systematic: EVERY read decodes the
                # message stripes from its k verified chunks — one
                # batched dispatch per (mask, stripe-count) group.
                with TRACER.span("kernel.regen_decode",
                                 parent=_read_parent,
                                 blocks=len(gathered)):
                    texts = codec.decode_blocks_batch(
                        [sh for _b, _bl, sh in gathered],
                        [bl for _b, bl, _sh in gathered])
                for (b, blk_len, _sh), block_data in zip(gathered,
                                                         texts):
                    bstart = b * fi.erasure.block_size
                    lo = max(offset, bstart) - bstart
                    hi = min(want_end, bstart + blk_len) - bstart
                    if hi > lo:
                        yield block_data[lo:hi]
                return

            # Pass 2: batch-reconstruct blocks with data loss — blocks
            # of one object share an erasure mask, so the whole group is
            # a single coalesced device dispatch (ops/batching.py).
            need = [i for i, (_, _, sh) in enumerate(gathered)
                    if any(sh[j] is None for j in range(k))]
            if need:
                # Kernel child span: without it a degraded read's
                # reconstruct math hides in root self-time and the
                # slowlog blames client-stream instead of the codec.
                with TRACER.span("kernel.rs_decode",
                                 parent=_read_parent,
                                 blocks=len(need)):
                    decoded = codec.decode_data_blocks_batch(
                        [gathered[i][2] for i in need])
                for i, dec in zip(need, decoded):
                    gathered[i] = (gathered[i][0], gathered[i][1], dec)

            for b, blk_len, shards in gathered:
                block_data = b"".join(
                    shards[j].tobytes() for j in range(k))[:blk_len]
                # Trim to the requested range within this block.
                bstart = b * fi.erasure.block_size
                lo = max(offset, bstart) - bstart
                hi = min(want_end, bstart + blk_len) - bstart
                if hi > lo:
                    yield block_data[lo:hi]

        group_starts = range(start_block, end_block + 1, group)
        if len(group_starts) <= 1:
            # Single group: no read-ahead to do — stay thread-free.
            for g0 in group_starts:
                yield from decode_group(fetch_group(g0))
            return

        # Read-ahead pipeline: group g+1's shard windows are fetched on
        # the worker while group g verifies, reconstructs, and yields to
        # the client (utils/pipeline.py; bounded depth keeps memory at
        # O(depth × group)). The shared `failed` set stays coherent: a
        # shard condemned by verification in group g is skipped by every
        # LATER fetch, and a window already in flight for it still
        # passes through the same verify pass before use. Abandoning the
        # stream (GeneratorExit at a yield) closes the pipeline, which
        # stops and joins the worker.
        from ..utils.pipeline import Prefetch

        def produce():
            for g0 in group_starts:
                yield fetch_group(g0)

        with Prefetch(produce(), depth=self.pipeline_depth, name="get",
                      span=_read_parent) as pf:
            for item in pf:
                yield from decode_group(item)

    # ------------------------------------------------------------------
    # delete / list

    def delete_object(self, bucket: str, object_name: str,
                      version_id: str = "",
                      versioned: bool = False) -> ObjectInfo:
        """Delete semantics (ref DeleteObject, cmd/erasure-object.go):
        - versioned bucket + no explicit versionId -> write a delete
          marker as the new latest version (nothing is erased);
        - explicit versionId (or unversioned bucket) -> permanently
          remove that version (latest null version when unversioned).
        Returns the deleted-object descriptor (marker id when one was
        written)."""
        self._check_bucket(bucket)
        if versioned and version_id == "":
            marker = FileInfo(
                volume=bucket, name=object_name,
                version_id=new_version_id(), deleted=True,
                mod_time=now())
            with self.ns_lock.write_locked(bucket, object_name):
                _, errs = parallel_map(
                    [lambda d=d: d.write_metadata(bucket, object_name,
                                                  marker)
                     for d in self.disks])
                self.guard_commit_bucket_gone(errs, bucket,
                                              object_name,
                                              marker.version_id)
                reduce_quorum_errs(errs, write_quorum(self.k, self.m),
                                   "delete_object(marker)")
            self._mark_update(bucket, object_name)
            from ..cache.hotcache import HOTCACHE
            HOTCACHE.invalidate(bucket, object_name)
            return ObjectInfo(bucket=bucket, name=object_name,
                              version_id=marker.version_id,
                              delete_marker=True,
                              mod_time=marker.mod_time)
        fi = FileInfo(volume=bucket, name=object_name,
                      version_id=version_id)
        was_marker = False
        with self.ns_lock.write_locked(bucket, object_name):
            if version_id:
                for d in self.disks:
                    try:
                        was_marker = d.read_version(
                            bucket, object_name, version_id).deleted
                        break
                    except serr.StorageError:
                        continue
            _, errs = parallel_map(
                [lambda d=d: d.delete_version(bucket, object_name, fi)
                 for d in self.disks])
        not_found = sum(1 for e in errs if isinstance(
            e, (serr.FileNotFound, serr.VersionNotFound)))
        if not_found == len(self.disks):
            raise ObjectNotFound(f"{bucket}/{object_name}")
        # A missing key counts as success for a DELETE (idempotent), so
        # fold it to None BEFORE the bucket-gone check — a degraded set
        # (one wiped disk) deleting a nonexistent key must not pay the
        # helper's settle path. VolumeNotFound likewise: a disk without
        # the volume trivially holds no copy.
        eff = [None if isinstance(e, (serr.FileNotFound,
                                      serr.VersionNotFound)) else e
              for e in errs]
        self._raise_if_bucket_gone(eff, bucket, for_write=True)
        reduce_quorum_errs(
            [None if isinstance(e, serr.VolumeNotFound) else e
             for e in eff],
            write_quorum(self.k, self.m), "delete_object")
        self._mark_update(bucket, object_name)
        from ..cache.hotcache import HOTCACHE
        HOTCACHE.invalidate(bucket, object_name)
        return ObjectInfo(bucket=bucket, name=object_name,
                          version_id=version_id,
                          delete_marker=was_marker)

    def object_exists(self, bucket: str, object_name: str) -> bool:
        """True when ANY version (object or delete marker) of the key
        exists on any disk — the placement probe that, unlike
        get_object_info, is not blinded by a delete marker being the
        latest version."""
        self._check_not_reserved(bucket)
        results, _ = parallel_map(
            [lambda d=d: d.read_versions(bucket, object_name)
             for d in self.disks])
        return any(r for r in results
                   if r is not None and not isinstance(r, BaseException))

    def put_object_tags(self, bucket: str, object_name: str, tags: str,
                        version_id: str = "") -> None:
        """Replace the object's tag set in-place in xl.meta (ref
        PutObjectTags, cmd/erasure-object.go — a metadata-only update;
        "" clears)."""
        self.update_object_metadata(bucket, object_name,
                                    {"x-amz-tagging": tags or None},
                                    version_id)

    def update_object_metadata(self, bucket: str, object_name: str,
                               updates: dict, version_id: str = "") -> None:
        """Metadata-only in-place xl.meta update under write quorum (a
        None value deletes the key). Each disk rewrites ITS OWN FileInfo
        so per-disk erasure indices stay intact (ref the updateObjectMeta
        pattern shared by PutObjectTags and replication-status writes,
        cmd/erasure-object.go)."""
        self._check_bucket(bucket)
        with self.ns_lock.write_locked(bucket, object_name):
            fi, agreed = self._quorum_file_info(bucket, object_name,
                                                version_id)
            if fi.deleted:
                if version_id:
                    raise MethodNotAllowed(f"{bucket}/{object_name}")
                raise ObjectNotFound(f"{bucket}/{object_name}")

            def update_one(i: int):
                own = agreed[i]
                if own is None:
                    return  # out-of-quorum disk; healing repairs it
                for k, v in updates.items():
                    if v is None:
                        own.metadata.pop(k, None)
                    else:
                        own.metadata[k] = v
                self.disks[i].write_metadata(bucket, object_name, own)

            _, errs = parallel_map(
                [lambda i=i: update_one(i)
                 for i in range(len(self.disks))])
            self._raise_if_bucket_gone(errs, bucket, for_write=True)
            reduce_quorum_errs(errs, write_quorum(self.k, self.m),
                               "update_object_metadata")
        self._mark_update(bucket, object_name)
        # Metadata (tags, replication status) lives in the cached
        # ObjectInfo too: drop the entry.
        from ..cache.hotcache import HOTCACHE
        HOTCACHE.invalidate(bucket, object_name)

    def walk_object_names(self, bucket: str) -> list[str]:
        """Union-merge directory walk across disks: every object name
        present on ANY disk (partial writes within quorum still list)."""
        names: set[str] = set()

        def walk(disk: StorageAPI, path: str) -> None:
            try:
                entries = disk.list_dir(bucket, path)
            except serr.StorageError:
                return
            is_object = "xl.meta" in entries
            if is_object:
                names.add(path)
            for e in entries:
                if not e.endswith("/"):
                    continue
                # Skip an object's data dirs (uuid dirs holding part files)
                # but keep descending into real sub-prefixes: an object
                # 'a' must not hide objects under 'a/'.
                if is_object and _looks_like_data_dir(e.rstrip("/")):
                    continue
                walk(disk, f"{path}{e}" if path else e)

        for disk in self.disks:
            try:
                base_entries = disk.list_dir(bucket, "")
            except serr.StorageError:
                continue
            for e in base_entries:
                if e.endswith("/"):
                    walk(disk, e)
        return sorted(n.rstrip("/") for n in names)

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000,
                     marker: str = "") -> list[ObjectInfo]:
        """Latest live version per key, served by the metacache engine:
        cached parallel walk_dir + k-way quorum merge (ref listPath,
        cmd/metacache-server-pool.go:38)."""
        self._check_bucket(bucket)
        return [ObjectInfo.from_file_info(fi)
                for fi in self.metacache.list_path(
                    bucket, prefix=prefix, marker=marker,
                    max_keys=max_keys)]

    def list_object_versions(self, bucket: str, prefix: str = "",
                             max_keys: int = 1000,
                             marker: str = "") -> list[ObjectInfo]:
        """All versions (objects + delete markers) newest-first per key,
        quorum-resolved from the same metacache walk (ref
        ListObjectVersions through listPath)."""
        self._check_bucket(bucket)
        return [ObjectInfo.from_file_info(fi)
                for fi in self.metacache.list_versions(
                    bucket, prefix=prefix, marker=marker,
                    max_keys=max_keys)]
