"""Healing: converge damaged/missing shards back to full redundancy
(ref cmd/erasure-healing.go:224 healObject, cmd/background-heal-ops.go,
cmd/erasure-object.go:1082 MRF).

heal_object classifies each disk for the latest quorum version —
  ok        xl.meta agrees + shard passes bitrot verify
  outdated  xl.meta missing/stale (disk swapped, partial write)
  corrupt   shard fails deep bitrot scan
— then regenerates every missing shard from k good ones and rewrites the
bad disks via the same tmp→rename_data commit as a PUT. Reconstruction is
the best TPU batch source: all blocks of an object share one erasure
mask, so each part's blocks coalesce into a single batched device
dispatch via codec.decode_all_blocks_batch → ops/batching.py (SURVEY §7
stage 5; one mask group per part, tail block forming its own group).

The port's own copy of ``minio_tpu/erasure/heal.py``, with no change in
behaviour but the engine's device seam (erasure/engine.py): heal's codec
is built on the engine's backend and device, and every bitrot call
(survivor frame checks, re-framing, the quarantine probe) hashes on the
engine's ``bitrot_device``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field

import numpy as np

from ..faultinject import FAULTS
from ..parallel.quorum import parallel_map
from ..storage import errors as serr
from ..storage.metadata import FileInfo
from ..storage.xl import INTENT_FILE, MINIO_META_BUCKET, TMP_PATH
from ..utils import ceil_frac
from . import bitrot
from .codec import codec_for_algorithm

# Cap on stacked survivor bytes per coalesced heal dispatch: large
# enough to saturate the device, small enough to bound heal memory.
HEAL_BATCH_BYTES = 64 * 1024 * 1024

# Crash points on the heal write-back commit: mid shard regeneration
# (staged frames on the bad disks, object still degraded) and just
# before the per-disk rename_data fan-out (fully staged).
CRASH_HEAL_MID = FAULTS.register_crash_point("engine.heal.mid_append")
CRASH_HEAL_PRE_COMMIT = FAULTS.register_crash_point(
    "engine.heal.pre_commit")


@dataclass
class HealResult:
    bucket: str
    object_name: str
    total_disks: int = 0
    before_ok: int = 0
    after_ok: int = 0
    healed_disks: list[int] = field(default_factory=list)
    corrupt_disks: list[int] = field(default_factory=list)
    missing_disks: list[int] = field(default_factory=list)
    dangling: bool = False
    skipped_lock: bool = False  # lock-contended: requeued via MRF

    @property
    def healthy(self) -> bool:
        """Full redundancy restored: every disk holds a valid shard."""
        return not self.dangling and self.after_ok == self.total_disks


class Healer:
    """Heal operations over an ErasureObjects engine."""

    def __init__(self, engine):
        self.engine = engine
        # Set by ErasureObjects.shutdown(): long sweeps (fresh-disk,
        # post-reinstatement) run on daemon threads that outlive their
        # trigger — they must stop at the next object boundary instead
        # of healing a dead deployment's disks forever.
        self._shutdown = threading.Event()

    def shutdown(self) -> None:
        self._shutdown.set()

    # -- classification ------------------------------------------------

    def _classify(self, bucket: str, object_name: str,
                  ) -> tuple[FileInfo, list[str]]:
        """Returns (quorum FileInfo, per-disk state list:
        'ok'|'outdated'|'corrupt')."""
        eng = self.engine
        # reduce_notfound=False: a below-quorum straggler copy must
        # surface as QuorumError so heal classifies it dangling and
        # purges it, not as ObjectNotFound (which would skip it forever).
        fi, agreed = eng._quorum_file_info(bucket, object_name,
                                           reduce_notfound=False)

        def check(i: int) -> str:
            f = agreed[i]
            if f is None:
                return "outdated"
            if fi.size == 0 or fi.deleted:
                return "ok"
            try:
                eng.disks[i].verify_file(bucket, object_name, f)
                return "ok"
            except serr.FileCorrupt:
                return "corrupt"
            except serr.StorageError:
                return "outdated"
            except Exception:
                return "outdated"

        results, _ = parallel_map(
            [lambda i=i: check(i) for i in range(len(eng.disks))])
        states = list(results)
        return fi, states

    # -- object heal ---------------------------------------------------

    def heal_object(self, bucket: str, object_name: str,
                    dry_run: bool = False,
                    lock_timeout: float = 30.0) -> HealResult:
        """Per-object heal under the namespace lock (ref healObject
        taking the object's ns lock, cmd/erasure-healing.go): classify +
        repair must not race a concurrent overwrite swapping the data
        dir between the metadata read and the shard reads/writes.

        Lock discipline: classification (metadata + deep bitrot verify)
        is read-only, so it runs under the READ lock — sweeping a mostly
        healthy namespace never stalls client traffic. Only when repair
        is actually needed does the heal escalate to the write lock and
        re-classify under it (the state may have changed in between).

        Dispatch priority: every heal entry point funnels here, so the
        whole operation runs in the BACKGROUND lane — its batched
        reconstructs yield the device/coalescing window to foreground
        encode work (qos/scheduler.py), with aging against starvation."""
        from ..qos.scheduler import background_lane
        with background_lane():
            with self.engine.ns_lock.read_locked(bucket, object_name,
                                                 lock_timeout):
                res = self._heal_object_locked(bucket, object_name,
                                               dry_run=True)
            if (dry_run or res.dangling
                    or not (res.corrupt_disks or res.missing_disks)):
                return res
            with self.engine.ns_lock.write_locked(bucket, object_name,
                                                  lock_timeout):
                return self._heal_object_locked(bucket, object_name,
                                                dry_run=False)

    def heal_object_or_queue(self, bucket: str, object_name: str,
                             dry_run: bool = False) -> HealResult:
        """Sweep-friendly heal: a lock-contended object (e.g. a
        long-lived GET stream holding its read lock) is requeued via MRF
        and reported skipped instead of aborting or stalling the sweep.
        The single helper all sweep loops share, so skip reporting is
        consistent everywhere."""
        try:
            return self.heal_object(bucket, object_name, dry_run)
        except TimeoutError:
            if not dry_run:
                # Audits stay read-only: only REPAIR sweeps requeue the
                # contended object for a real background heal.
                self.engine.mrf.add(bucket, object_name)
            res = HealResult(bucket, object_name,
                             total_disks=len(self.engine.disks))
            res.skipped_lock = True
            return res

    def _heal_object_locked(self, bucket: str, object_name: str,
                            dry_run: bool = False) -> HealResult:
        from ..parallel.quorum import QuorumError
        eng = self.engine
        n_disks = len(eng.disks)
        from .engine import BucketNotFound, ObjectNotFound
        try:
            fi, states = self._classify(bucket, object_name)
        except QuorumError as exc:
            res = HealResult(bucket, object_name, total_disks=n_disks)
            # Dangling requires NOT-FOUND evidence (ref isObjectDangling:
            # only errFileNotFound counts). A transient full-disk outage
            # (real IO errors) must not classify an intact object
            # unrecoverable — that path purges data once acted upon.
            real = [e for e in getattr(exc, "errs", [])
                    if e is not None and not isinstance(
                        e, (serr.FileNotFound, serr.VersionNotFound))]
            res.dangling = not real
            return res
        except (ObjectNotFound, BucketNotFound):
            # Object — or its whole bucket — deleted between listing
            # and healing: nothing to do; the sweep continues.
            return HealResult(bucket, object_name, total_disks=n_disks)
        res = HealResult(bucket, object_name, total_disks=n_disks)
        res.before_ok = states.count("ok")
        res.corrupt_disks = [i for i, s in enumerate(states)
                             if s == "corrupt"]
        res.missing_disks = [i for i, s in enumerate(states)
                             if s == "outdated"]
        bad = res.corrupt_disks + res.missing_disks
        if not bad:
            res.after_ok = res.before_ok
            return res
        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        if res.before_ok < k:
            res.dangling = True  # unrecoverable (ref dangling purge)
            res.after_ok = res.before_ok
            return res
        if dry_run:
            res.after_ok = res.before_ok
            return res

        # A fresh replacement disk may lack the bucket volume entirely —
        # heal it first so shard/metadata writes land (ref healObject's
        # implicit HealBucket dependency). But ONLY while a majority of
        # disks still carry the bucket: healing must never resurrect a
        # bucket a racing delete_bucket(force=True) just removed (the
        # same invariant xl.py's _makedirs_for enforces on write paths).
        if not eng.bucket_exists(bucket):
            res.after_ok = res.before_ok
            return res
        for i in bad:
            try:
                eng.disks[i].stat_volume(bucket)
            except serr.VolumeNotFound:
                try:
                    eng.disks[i].make_volume(bucket)
                except serr.StorageError:
                    pass
            except serr.StorageError:
                pass

        if fi.size == 0 or fi.deleted:
            res.healed_disks = self._rewrite_meta_only(fi, bad)
            res.after_ok = res.before_ok + len(res.healed_disks)
            return res

        # Shard indices (0-based) on good vs bad disks, via each good
        # disk's own metadata index; bad disks get theirs from the quorum
        # distribution.
        dist = fi.erasure.distribution
        good_disks = [i for i, s in enumerate(states) if s == "ok"]
        shard_of_disk = {i: dist[i] - 1 for i in range(len(eng.disks))}

        # Rebuild every part's full shard matrix blockwise from k good
        # shards: one decode per block, shared mask across the whole
        # object (the best TPU batch source). The rebuild STREAMS
        # through a bounded pipeline (utils/pipeline.py): the producer
        # reads survivors, batch-reconstructs one block group, and
        # bitrot-frames it, while the consumer writes the PREVIOUS
        # group's regenerated frames to the bad disks — reconstruct
        # dispatches overlap write-back I/O. The pipeline inherits the
        # heal's background lane, so a deferred kernel dispatch stalls
        # production and the queue drains (defer = drain, don't grow).
        shard_size = fi.erasure.shard_size()
        missing_shards = sorted(shard_of_disk[i] for i in bad)
        # Codec follows the object's xl.meta algorithm stamp: REGEN
        # objects heal through the minimum-bandwidth regen path below,
        # plain-RS objects through the conventional k-survivor decode.
        codec = codec_for_algorithm(
            fi.erasure.algorithm, k, m, fi.erasure.block_size,
            backend=eng.backend,
            # Heal reconstructs dispatch from this set too: same home
            # device as the serving codec (parallel/mesh.py affinity).
            affinity=getattr(self.engine, "device_affinity", None),
            device=eng.device)
        from ..storage.metadata import ObjectPartInfo
        parts = fi.parts or [ObjectPartInfo(number=1, size=fi.size,
                                            actual_size=fi.size)]

        def part_algo(part) -> str:
            algo = bitrot.DEFAULT_ALGORITHM
            for cs in fi.erasure.checksums:
                if cs.get("part") == part.number:
                    algo = cs.get("algorithm", algo)
            return algo

        # Health-ranked survivors (obs/drivemon.py): read the k shards
        # (or, for REGEN, contact the d helpers) from the healthiest
        # sources first — a suspect drive only serves a heal read when
        # no healthier survivor can (the same any-k-of-n policy the GET
        # path uses).
        from ..obs.drivemon import DRIVEMON, OK as _DM_OK

        def _rank(i: int) -> tuple:
            ep = eng.endpoints[i]
            state = DRIVEMON.state_of(ep)
            return (1 if DRIVEMON.is_quarantined(ep) else 0,
                    0 if state == _DM_OK else 1,
                    DRIVEMON.ewma_for(ep).get("read", 0.0))

        read_order = sorted(good_disks, key=_rank)
        from .regen.repair import REPAIR_BYTES

        def produce_groups():
            """Yield (part_number, {shard_idx: framed bytes}) per block
            group, parts in order, groups in order — consecutive
            groups' frames concatenate into exactly the shard stream
            the old whole-part encode produced."""
            for part in parts:
                # Collect k survivor streams, tolerating read failures
                # from disks that were "ok" at classify time but
                # dropped since (a peer restarting mid-sweep): any k
                # good shards decode; only fewer than k is fatal.
                streams = {}
                for i in read_order:
                    if len(streams) == k:
                        break
                    try:
                        data = eng.disks[i].read_all(
                            bucket,
                            f"{object_name}/{fi.data_dir}"
                            f"/part.{part.number}")
                    except serr.StorageError:
                        continue
                    # Repair-traffic ledger (the RS baseline the regen
                    # path's 2x claim is measured against): a full
                    # survivor chunk is read from media AND crosses the
                    # wire in a distributed set.
                    REPAIR_BYTES.add("rs", "disk", len(data))
                    REPAIR_BYTES.add("rs", "net", len(data))
                    streams[shard_of_disk[i]] = data
                if len(streams) < k:
                    raise serr.FaultyDisk(
                        f"heal {bucket}/{object_name}: only "
                        f"{len(streams)}/{k} survivor shards readable")
                algo = part_algo(part)
                n_blocks = ceil_frac(part.size, fi.erasure.block_size)
                if n_blocks == 0:
                    # Zero-byte part: the (empty) shard file must still
                    # exist on the healed disk.
                    yield part.number, {j: b"" for j in missing_shards}
                    continue
                # All blocks share one erasure mask -> coalesced device
                # dispatches (ops/batching.py), bounded to
                # HEAL_BATCH_BYTES of stacked survivors so peak memory
                # stays O(batch), not O(part).
                group = max(1, HEAL_BATCH_BYTES
                            // max(fi.erasure.block_size, 1))
                for b0 in range(0, n_blocks, group):
                    block_shards: list[list[np.ndarray | None]] = []
                    for b in range(b0, min(b0 + group, n_blocks)):
                        blk_len = min(
                            fi.erasure.block_size,
                            part.size - b * fi.erasure.block_size)
                        chunk = ceil_frac(blk_len, k)
                        shards: list[np.ndarray | None] = \
                            [None] * (k + m)
                        for j, stream in streams.items():
                            data = bitrot.extract_block(
                                stream, b, chunk, shard_size, algo,
                                device=eng.bitrot_device)
                            shards[j] = np.frombuffer(data,
                                                      dtype=np.uint8)
                        block_shards.append(shards)
                    acc = {j: bytearray() for j in missing_shards}
                    for full in codec.decode_all_blocks_batch(
                            block_shards):
                        for j in missing_shards:
                            acc[j] += full[j].tobytes()
                    # Group lengths are multiples of shard_size except
                    # the part's final group, so per-group framing
                    # concatenates byte-identically to whole-part
                    # framing (pinned by tests/test_pipeline.py).
                    yield part.number, {
                        j: bitrot.encode_stream(
                            bytes(acc[j]), shard_size, algo,
                            device=eng.bitrot_device)
                        for j in missing_shards}

        # Write regenerated shards to the bad disks group by group
        # (tmp append stream -> rename_data, same commit path as PUT;
        # ref Erasure.Heal writes via bitrot writers then
        # writeUniqueFileInfo + rename). Per-disk failures drop that
        # disk from the write set without aborting the others.
        tmp_paths = {i: f"{TMP_PATH}/{uuid.uuid4()}" for i in bad}
        write_errs: dict[int, BaseException] = {}
        # Recovery breadcrumbs: a crash mid write-back leaves staged
        # frames on the bad disks; the boot sweep reads the intent to
        # requeue the (still-degraded) object for heal before GC.
        from .engine import _stage_intent_blob
        intent_blob = _stage_intent_blob(bucket, object_name,
                                         fi.version_id, fi.data_dir)
        for i in bad:
            try:
                eng.disks[i].append_file(
                    MINIO_META_BUCKET, f"{tmp_paths[i]}/{INTENT_FILE}",
                    intent_blob)
            except Exception:
                pass  # best-effort; a dead disk fails its appends next

        def drop_disk(i: int, exc: BaseException) -> None:
            write_errs[i] = exc
            try:
                eng.disks[i].delete(MINIO_META_BUCKET, tmp_paths[i],
                                    recursive=True)
            except Exception:
                pass

        # A single-group object (the common small-object sweep case)
        # has nothing to overlap: consume the generator inline rather
        # than paying a worker-thread handoff per healed object.
        group_blocks = max(1, HEAL_BATCH_BYTES
                           // max(fi.erasure.block_size, 1))
        n_groups = sum(
            max(1, ceil_frac(ceil_frac(p.size, fi.erasure.block_size),
                             group_blocks))
            for p in parts)
        if getattr(codec, "is_regen", False):
            # Minimum-bandwidth REGEN heal: helpers project locally and
            # ship d small rows per block instead of k full chunks
            # (erasure/regen/repair.py); the generator feeds the SAME
            # write-back pipeline, crash points and commit below.
            from .regen.repair import regen_heal_groups
            producer = regen_heal_groups(
                eng, bucket, object_name, fi, codec, parts,
                missing_shards, shard_of_disk, read_order, part_algo,
                HEAL_BATCH_BYTES)
        else:
            producer = produce_groups()
        from ..utils.pipeline import Prefetch
        pf = (Prefetch(producer, depth=eng.pipeline_depth, name="heal")
              if n_groups > 1 else
              contextlib.nullcontext(producer))
        with pf as groups:
            try:
                for part_number, frames in groups:
                    live = [i for i in bad if i not in write_errs]
                    if not live:
                        break  # nobody left to heal; stop decoding
                    # Crash window: fires per block group — staged
                    # frames on the bad disks, object still serving
                    # from its k survivors.
                    FAULTS.crash_point(CRASH_HEAL_MID)
                    _, errs = parallel_map(
                        [lambda i=i: eng.disks[i].append_file(
                            MINIO_META_BUCKET,
                            f"{tmp_paths[i]}/{fi.data_dir}"
                            f"/part.{part_number}",
                            frames[shard_of_disk[i]])
                         for i in live])
                    for i, e in zip(live, errs):
                        if e is not None:
                            drop_disk(i, e)
            except BaseException:
                for i in bad:
                    if i not in write_errs:
                        drop_disk(i, serr.FaultyDisk("heal aborted"))
                raise

        def commit_one(i: int):
            disk = eng.disks[i]
            j = shard_of_disk[i]
            try:
                new_fi = FileInfo(
                    volume=bucket, name=object_name,
                    version_id=fi.version_id, data_dir=fi.data_dir,
                    size=fi.size, mod_time=fi.mod_time,
                    metadata=dict(fi.metadata), parts=list(fi.parts),
                    erasure=type(fi.erasure)(
                        algorithm=fi.erasure.algorithm,
                        data_blocks=k, parity_blocks=m,
                        block_size=fi.erasure.block_size,
                        index=j + 1, distribution=list(dist),
                        checksums=list(fi.erasure.checksums)),
                )
                disk.rename_data(MINIO_META_BUCKET, tmp_paths[i],
                                 new_fi, bucket, object_name)
            except BaseException:
                try:
                    disk.delete(MINIO_META_BUCKET, tmp_paths[i],
                                recursive=True)
                except Exception:
                    pass
                raise

        # Crash window: every regenerated shard staged, rename_data
        # fan-out not yet started.
        FAULTS.crash_point(CRASH_HEAL_PRE_COMMIT)
        alive_bad = [i for i in bad if i not in write_errs]
        _, errs = parallel_map([lambda i=i: commit_one(i)
                                for i in alive_bad])
        res.healed_disks = [i for i, e in zip(alive_bad, errs)
                            if e is None]
        res.after_ok = res.before_ok + len(res.healed_disks)
        return res

    def _rewrite_meta_only(self, fi: FileInfo, bad: list[int]) -> list[int]:
        """Per-disk metadata rewrite; returns indices actually healed
        (failures on individual disks don't abort the rest)."""
        dist = fi.erasure.distribution

        def one(i: int):
            new_fi = FileInfo(
                volume=fi.volume, name=fi.name, version_id=fi.version_id,
                deleted=fi.deleted, data_dir=fi.data_dir, size=fi.size,
                mod_time=fi.mod_time, metadata=dict(fi.metadata),
                parts=list(fi.parts),
                erasure=type(fi.erasure)(
                    algorithm=fi.erasure.algorithm,
                    data_blocks=fi.erasure.data_blocks,
                    parity_blocks=fi.erasure.parity_blocks,
                    block_size=fi.erasure.block_size,
                    index=dist[i] if i < len(dist) else 0,
                    distribution=list(dist),
                    checksums=list(fi.erasure.checksums)),
            )
            self.engine.disks[i].write_metadata(fi.volume, fi.name, new_fi)

        _, errs = parallel_map([lambda i=i: one(i) for i in bad])
        return [i for i, e in zip(bad, errs) if e is None]

    # -- bucket heal ---------------------------------------------------

    def heal_bucket(self, bucket: str) -> list[int]:
        """Create the bucket volume on disks where it's missing
        (ref HealBucket). Guarded by the majority vote: healing
        stragglers must never resurrect a bucket a racing delete_bucket
        just removed from every (or most) disks."""
        eng = self.engine
        if not eng.bucket_exists(bucket):
            return []
        healed = []
        for i, disk in enumerate(eng.disks):
            try:
                disk.stat_volume(bucket)
            except serr.VolumeNotFound:
                try:
                    disk.make_volume(bucket)
                    healed.append(i)
                except serr.StorageError:
                    pass
            except serr.StorageError:
                pass
        return healed

    def heal_disk(self, disk_index: int) -> list[HealResult]:
        """Full sweep healing everything onto one (fresh) disk
        (ref healErasureSet / monitorLocalDisksAndHeal). The listing
        walk between per-object heals also runs in the background lane
        (per-object heals re-enter it via heal_object)."""
        from ..qos.scheduler import background_lane
        with background_lane():
            return self._heal_disk_bg(disk_index)

    def _heal_disk_bg(self, disk_index: int) -> list[HealResult]:
        from ..qos.scheduler import GATE
        eng = self.engine
        results = []
        last_cost = None
        for binfo in eng.list_buckets():
            if self._shutdown.is_set():
                break
            bucket = binfo["name"]
            self.heal_bucket(bucket)
            for obj in eng.list_objects(bucket, max_keys=1_000_000):
                if self._shutdown.is_set():
                    return results
                # Pace the sweep against foreground traffic (ref
                # waitForLowHTTPReq + dynamicSleeper): per-object heal
                # is I/O+hash heavy; yield ~10x the last object's own
                # cost between objects, aging-bounded.
                GATE.throttle_background(last_cost)
                # Per-object isolation: one failing object (lock
                # timeout, peer flapping mid-sweep) must not abort the
                # rest of the sweep — it starved convergence when an
                # early object kept failing while later ones never got
                # reached; the next sweep retries it anyway.
                t0 = time.monotonic()
                try:
                    r = self.heal_object_or_queue(bucket, obj.name)
                except Exception as exc:  # noqa: BLE001 — sweep survives
                    import logging
                    logging.getLogger("minio_tpu_torch.heal").warning(
                        "heal sweep: %s/%s failed: %r", bucket,
                        obj.name, exc)
                    continue
                finally:
                    last_cost = time.monotonic() - t0
                if disk_index in r.healed_disks or not r.healed_disks:
                    results.append(r)
        return results


class NewDiskMonitor:
    """Detects freshly replaced (wiped) disks and auto-triggers the
    full heal sweep onto them (ref monitorLocalDisksAndHeal,
    cmd/background-newdisks-heal-ops.go:113: the reference watches for
    disks carrying a healing tracker written at fresh format).

    Freshness signal here: a reachable disk that is missing bucket
    volumes the rest of the set agrees on — exactly the state a swapped
    drive is in. Object-level drift on a disk that has all volumes is
    the scanner's heal-sampling job, not this monitor's."""

    def __init__(self, healer: Healer, interval: float = 10.0):
        self.healer = healer
        self.interval = interval
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # monotonic time of each disk's last completed sweep. A disk
        # still missing volumes re-sweeps after a slow-cadence backoff
        # (a single sweep can partially fail under write-lock
        # contention; once-ever marking would stall convergence
        # forever), and is cleared when the disk turns healthy so a
        # future re-replacement triggers immediately.
        self._swept: dict[int, float] = {}
        self.sweeps = 0   # observability: completed auto-sweeps

    def _resweep_after(self) -> float:
        return max(self.interval * 4, 5.0)

    def _heal_format(self, i: int, disk) -> bool:
        """Restore a hot-swapped disk's format.json from a healthy set
        peer (ref HealFormat, cmd/erasure-sets.go — the reference
        re-stamps blank replacement drives without a restart; our boot
        path only does this at init_or_load_formats time). The engine's
        disk order IS the format row order, so slot i's uuid is row[i]
        of whichever set row contains a healthy peer's uuid."""
        from ..storage.format import (FormatErasure, load_format,
                                      save_format)
        if load_format(disk) is not None:
            return False
        import logging
        log = logging.getLogger("minio_tpu_torch.heal")
        eng = self.healer.engine
        for j, peer in enumerate(eng.disks):
            if j == i:
                continue
            ref = load_format(peer)
            if ref is None:
                log.debug("restamp probe: peer %d (%s) format "
                          "unreadable", j, peer)
                continue
            pos = ref.find(ref.this)
            if pos is None or pos[1] != j:
                log.debug("restamp probe: peer %d slot mismatch "
                          "pos=%s", j, pos)
                continue  # peer not in this set row at its slot: skip
            row = ref.sets[pos[0]]
            save_format(disk, FormatErasure(
                ref.deployment_id, row[i], ref.sets,
                ref.distribution_algo))
            log.info("restamped fresh disk %d (%s) as %s", i,
                     getattr(disk, "root", disk), row[i][:8])
            return True
        log.debug("restamp: no usable peer for disk %d", i)
        return False

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        # mtpu-lint: disable=R1 -- boot-time daemon; heal work tags its own bg lane at the call sites
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="newdisk-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                import logging
                logging.getLogger("minio_tpu_torch.heal").exception(
                    "new-disk monitor tick failed")

    def tick(self) -> list[int]:
        """One detection pass; returns indices of disks swept."""
        eng = self.healer.engine
        buckets = [b["name"] for b in eng.list_buckets()]
        if not buckets:
            return []
        swept = []
        for i, disk in enumerate(eng.disks):
            # LOCAL disks only (ref monitorLocalDisksAndHeal): a wiped
            # remote drive is its own node's monitor's job — every
            # node sweeping the same replacement at once just fights
            # over write locks.
            if not hasattr(disk, "root"):
                continue
            try:
                self._heal_format(i, disk)
            except Exception:
                # Dead disk / no healthy peer reachable right now: the
                # volumes check below still runs, and every later tick
                # retries the re-stamp. Log it — a silently un-stamped
                # drive would fail the NEXT restart's format quorum.
                import logging
                logging.getLogger("minio_tpu_torch.heal").warning(
                    "format re-stamp failed for disk %d (%s)",
                    i, getattr(disk, "root", disk), exc_info=True)
            try:
                vols = set(disk.list_volumes())
            except Exception:
                # Unreachable: not fresh — but forget its healed mark
                # so its eventual replacement is re-swept.
                self._swept.pop(i, None)
                continue
            missing = [b for b in buckets if b not in vols]
            if not missing:
                # Healthy again: clear the mark so a future
                # re-replacement counts as fresh.
                self._swept.pop(i, None)
                continue
            last = self._swept.get(i)
            if last is not None and (time.monotonic() - last
                                     < self._resweep_after()):
                continue
            # heal_disk re-creates missing bucket volumes itself
            # (heal_bucket per quorum-listed bucket) before sweeping.
            self.healer.heal_disk(i)
            self._swept[i] = time.monotonic()
            self.sweeps += 1
            swept.append(i)
        return swept


class QuarantineProber:
    """Probation probes for quarantined drives — the reinstatement half
    of the quarantine lifecycle (obs/drivemon.py).

    Every tick, each quarantined drive in the set is shadow-probed: a
    bitrot-framed blob is staged to the drive's tmp area, read back,
    and verified frame-exact (write path + read path + bitrot layer all
    exercised — the three ways a sick drive lies). One clean round is a
    probation pass; ``DriveMonitor.PROBATION_PASSES`` CONSECUTIVE
    passes reinstate the drive; any failure restarts the streak.
    Reinstatement kicks a background heal sweep onto the drive so the
    writes it missed while quarantined (MRF-requeued degraded writes)
    converge back to full redundancy.

    Probe I/O rides the normal _DiskOp boundary, so the fault-injection
    subsystem perturbs probes exactly like data-plane ops — a drive
    whose injected faults are still active keeps failing probation.

    Start contract mirrors NewDiskMonitor: the server boot starts the
    thread; tests and library users drive tick() directly."""

    PROBE_BYTES = 64 * 1024

    def __init__(self, engine, interval: float = 5.0):
        self.engine = engine
        self.interval = interval
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.probes = 0      # observability: probe rounds run
        self.reinstated = 0  # observability: drives brought back

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        # mtpu-lint: disable=R1 -- boot-time probe daemon; probes carry no request context
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="quarantine-prober")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                import logging
                logging.getLogger("minio_tpu_torch.heal").exception(
                    "quarantine prober tick failed")

    def tick(self) -> list[int]:
        """One probe round over this set's quarantined drives; returns
        indices of drives reinstated this round."""
        from ..obs.drivemon import DRIVEMON
        eng = self.engine
        reinstated = []
        for i, disk in enumerate(eng.disks):
            ep = eng.endpoints[i]
            if not DRIVEMON.is_quarantined(ep):
                continue
            self.probes += 1
            if self._probe(disk):
                if DRIVEMON.probation_pass(ep):
                    self.reinstated += 1
                    reinstated.append(i)
                    self._heal_after_reinstate(i)
            else:
                DRIVEMON.probation_fail(ep)
        return reinstated

    def _probe(self, disk) -> bool:
        """One shadow probe: staged bitrot-framed write + read-back +
        frame verification. Deterministic payload so a byte-level
        mangling (injected corruption, real bitrot) is always caught."""
        shard_size = 4096
        payload = bytes(range(256)) * (self.PROBE_BYTES // 256)
        dev = self.engine.bitrot_device
        framed = bitrot.encode_stream(payload, shard_size,
                                      bitrot.DEFAULT_ALGORITHM, device=dev)
        rel = f"{TMP_PATH}/probation-probe-{uuid.uuid4().hex}"
        try:
            disk.write_all(MINIO_META_BUCKET, rel, framed)
            back = disk.read_all(MINIO_META_BUCKET, rel)
            ok = (bytes(back) == bytes(framed)
                  and bitrot.verify_stream(back, shard_size,
                                           bitrot.DEFAULT_ALGORITHM,
                                           device=dev))
        except Exception:
            ok = False
        finally:
            try:
                disk.delete(MINIO_META_BUCKET, rel)
            except Exception:
                pass
        return ok

    def _heal_after_reinstate(self, disk_index: int) -> None:
        """Converge the writes the drive missed while quarantined: a
        full background sweep onto it, like a fresh-disk heal (the
        MRF entries its degraded writes queued may already be
        drained)."""
        import logging
        logging.getLogger("minio_tpu_torch.heal").info(
            "drive %d reinstated after probation; starting heal sweep",
            disk_index)

        def run():
            try:
                self.engine.healer.heal_disk(disk_index)
            except Exception:
                logging.getLogger("minio_tpu_torch.heal").exception(
                    "post-reinstatement heal sweep failed")

        # mtpu-lint: disable=R1 -- reinstatement sweep outlives the probe tick; heal tags its own bg lane at the call sites
        threading.Thread(target=run, daemon=True,
                         name=f"reinstate-heal-{disk_index}").start()


class MRFQueue:
    """Most-recently-failed heal queue: partial PUT failures enqueue the
    object for background healing (ref mrfOpCh, cmd/erasure-object.go:1082
    + healRoutine, cmd/background-heal-ops.go:89).

    Two robustness layers on top of the reference's buffered channel:
    (a) ``add()`` DEDUPS — a flapping drive requeueing the same object
    on every degraded write used to inflate depth and force drops of
    OTHER objects' repairs; now a (bucket, object) already queued is a
    set lookup, not a new entry. (b) every accepted entry is journaled
    to the per-set durable MRF journal (erasure/mrfjournal.py,
    ``.minio.sys/mrf.log``) and replayed at boot, so a crash no longer
    silently discards the queued repairs."""

    # One drop log line per window — a full queue under a disk outage
    # drops thousands of entries, and each dropped heal is data
    # durability silently deferred to the next sweep; the log must say
    # so without becoming the new bottleneck.
    DROP_LOG_WINDOW_S = 60.0

    def __init__(self, healer: Healer, maxsize: int = 10_000):
        self.healer = healer
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.drops = 0
        self._last_drop_log = 0.0
        # In-flight dedup set guarded by its own tiny lock (the Queue's
        # internal mutex is not reachable for the membership check).
        self._qmu = threading.Lock()
        self._queued: set[tuple[str, str]] = set()
        from .mrfjournal import MRFJournal
        self.journal = MRFJournal(healer.engine.disks)

    def depth(self) -> int:
        return self.q.qsize()

    def add(self, bucket: str, object_name: str) -> None:
        from ..obs.metrics2 import METRICS2
        key = (bucket, object_name)
        dropped = False
        # Dedup-insert, enqueue, AND journal under one critical
        # section, mirrored by _heal's retire path: interleaving them
        # lets a concurrent retire of the SAME key either dedup a
        # fresh repair out of existence or strip a freshly queued
        # repair of its journal entry (crash durability silently
        # lost). MRF adds are failure-path, never hot, and the
        # journal batches its I/O — serializing them is cheap.
        with self._qmu:
            if key in self._queued:
                return  # already queued: dedup, don't inflate depth
            self._queued.add(key)
            try:
                self.q.put_nowait((bucket, object_name))
            except queue.Full:
                # Best effort like the reference's buffered channel —
                # but COUNTED: a silent drop is a heal that never
                # happens until the next full sweep notices.
                self._queued.discard(key)
                self.drops += 1
                dropped = True
            else:
                # Durability: journal the accepted entry so a crash
                # replays it (no-op when already journaled, when the
                # set has no local disks, or past the size cap —
                # drops counted there).
                self.journal.record(bucket, object_name)
        if dropped:
            METRICS2.inc("minio_tpu_v2_mrf_drops_total")
            now = time.monotonic()
            if now - self._last_drop_log >= self.DROP_LOG_WINDOW_S:
                self._last_drop_log = now
                from ..logger import Logger
                Logger.get().info(
                    f"MRF queue full ({self.q.maxsize}): dropped heal "
                    f"for {bucket}/{object_name} "
                    f"({self.drops} drops total)", "heal")
            return
        METRICS2.set_gauge("minio_tpu_v2_mrf_queue_depth", None,
                           self.q.qsize())
        # Background worker starts lazily on first failure so every
        # deployment (server, library use) gets self-healing without
        # explicit wiring.
        if self._thread is None:
            self.start()

    def replay_journal(self) -> int:
        """Boot-time replay (storage/recovery.py): re-queue every
        journaled repair through the normal add() path, so the depth
        gauge reflects the replayed backlog and the worker starts.
        Entries already in the journal are not re-appended (replay
        seeds the journal's dedup set)."""
        entries = self.journal.replay()
        for bucket, object_name in entries:
            self.add(bucket, object_name)
        return len(entries)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        # mtpu-lint: disable=R1 -- boot-time MRF daemon; no request context exists to carry
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            try:
                self.q.put_nowait(None)  # wake; Full is fine — the worker
            except queue.Full:           # checks _stop after every item
                pass
            self._thread.join(timeout=5)
            self._thread = None

    def drain(self) -> None:
        """Synchronously heal everything queued (tests/shutdown)."""
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                self._heal(item)

    # Contended items retry this many times with a SHORT lock wait so a
    # handful of hot keys can't head-of-line-block the whole queue.
    MAX_TRIES = 8
    LOCK_WAIT_S = 3.0

    def _heal(self, item) -> None:
        from ..qos.scheduler import GATE, background_lane
        bucket, object_name, tries = (item if len(item) == 3
                                      else (*item, 0))
        requeued = False
        converged = False
        try:
            with background_lane():
                GATE.throttle_background()  # MRF drains behind traffic
            res = self.healer.heal_object(bucket, object_name,
                                          lock_timeout=self.LOCK_WAIT_S)
            # Converged: every bad disk healed (or nothing was bad, or
            # the object is dangling/deleted — no future heal will
            # change it). Only then does the JOURNAL entry retire; a
            # failed heal keeps its durability debt on disk for the
            # next boot/retry.
            bad = set(res.corrupt_disks) | set(res.missing_disks)
            converged = (res.dangling
                         or bad <= set(res.healed_disks))
        except TimeoutError:
            # Still contended: requeue to the BACK with a retry cap —
            # the sweep loops that enqueued this expect an eventual
            # retry, not a silent drop.
            if tries + 1 < self.MAX_TRIES:
                try:
                    self.q.put_nowait((bucket, object_name, tries + 1))
                    requeued = True
                except queue.Full:
                    pass
        except Exception:
            pass  # background best-effort
        finally:
            if not requeued:
                # Retire under the same lock add() inserts under (see
                # add): the key leaves the dedup set either way — a
                # FAILED heal must be re-addable by the next degraded
                # write or sweep — and a CONVERGED heal retires its
                # journal entry atomically with it.
                with self._qmu:
                    self._queued.discard((bucket, object_name))
                    if converged:
                        self.journal.complete(bucket, object_name)

    def _run(self) -> None:
        from ..obs.metrics2 import METRICS2
        while not self._stop.is_set():
            item = self.q.get()
            METRICS2.set_gauge("minio_tpu_v2_mrf_queue_depth", None,
                               self.q.qsize())
            if item is None or self._stop.is_set():
                break
            self._heal(item)
