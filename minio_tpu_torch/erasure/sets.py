"""ErasureSets — one pool as M independent erasure sets of K drives,
objects placed by SipHash of the name keyed by deployment id
(ref cmd/erasure-sets.go:54 struct, :623 sipHashMod, :658 getHashedSet).

Sets never talk to each other: every object lives entirely inside the
set its name hashes to; bucket operations fan out to all sets.

The port's own copy of ``minio_tpu/erasure/sets.py``, with no change in
behaviour but the device seam: ``backend`` and ``device`` (keyword-only)
go to every set's engine (erasure/engine.py), and ``device`` reads back
where they run.
"""

from __future__ import annotations

import uuid as uuidlib

from ..parallel.quorum import parallel_map
from ..storage.interface import StorageAPI
from ..utils.siphash import sip_hash_mod
from .codec import BLOCK_SIZE
from .engine import (BucketExists, BucketNotFound, ErasureObjects,
                     ObjectInfo, ObjectNotFound)


def fan_out_bucket_op(targets: list, op_name: str, benign: type,
                      *args, **kwargs) -> None:
    """Run a bucket op on every target; a `benign` error (exists /
    not-found) only surfaces when unanimous, any other error surfaces
    immediately. Shared by sets and pools fan-out."""
    _, errs = parallel_map(
        [lambda t=t: getattr(t, op_name)(*args, **kwargs)
         for t in targets])
    real = [e for e in errs if e is not None
            and not isinstance(e, benign)]
    if real:
        raise real[0]
    if errs and all(isinstance(e, benign) for e in errs):
        raise errs[0]


class ErasureSets:
    def __init__(self, disks: list[StorageAPI], sets_layout: list[int],
                 deployment_id: str,
                 data_shards: int | None = None,
                 parity_shards: int | None = None,
                 block_size: int = BLOCK_SIZE, *, backend: str = "gpu",
                 device=None):
        """sets_layout: e.g. [6, 6] = two sets of six drives; `disks`
        is flat, format-ordered (storage.format.init_or_load_formats).
        Every set's engine runs on ``backend`` and ``device``."""
        assert sum(sets_layout) == len(disks)
        self.deployment_id = deployment_id
        self._dep_key = uuidlib.UUID(deployment_id).bytes
        self.sets: list[ErasureObjects] = []
        off = 0
        for size in sets_layout:
            self.sets.append(ErasureObjects(
                disks[off:off + size], data_shards, parity_shards,
                block_size=block_size, backend=backend, device=device))
            off += size

    # -- placement ------------------------------------------------------

    def set_index(self, object_name: str) -> int:
        return sip_hash_mod(object_name, len(self.sets), self._dep_key)

    def set_for(self, object_name: str) -> ErasureObjects:
        return self.sets[self.set_index(object_name)]

    def shutdown(self) -> None:
        """Stop every set's background daemons (see
        ErasureObjects.shutdown)."""
        for s in self.sets:
            s.shutdown()

    # -- buckets (fan out to every set) ---------------------------------

    def make_bucket(self, bucket: str) -> None:
        fan_out_bucket_op(self.sets, "make_bucket", BucketExists, bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        fan_out_bucket_op(self.sets, "delete_bucket", BucketNotFound,
                          bucket, force=force)

    def list_buckets(self) -> list[dict]:
        return self.sets[0].list_buckets()

    def bucket_exists(self, bucket: str) -> bool:
        return self.sets[0].bucket_exists(bucket)

    # -- objects (dispatch to the hashed set) ---------------------------

    @property
    def k(self) -> int:
        """Set geometry (uniform across sets; ref formatErasureV3)."""
        return self.sets[0].k

    @property
    def m(self) -> int:
        return self.sets[0].m

    @property
    def device(self):
        """Where the sets' kernels run: the engines' pinned device, or
        ``"auto"`` for autotuned engines (their ``bitrot_device``). S3
        Select scans an object of this layer there."""
        return self.sets[0].bitrot_device

    supports_streaming_put = True

    def put_object(self, bucket: str, object_name: str, data: bytes,
                   metadata: dict | None = None,
                   versioned: bool = False,
                   parity_shards: int | None = None,
                   algorithm: str | None = None) -> ObjectInfo:
        return self.set_for(object_name).put_object(
            bucket, object_name, data, metadata=metadata,
            versioned=versioned, parity_shards=parity_shards,
            algorithm=algorithm)

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1, version_id: str = ""):
        return self.set_for(object_name).get_object(
            bucket, object_name, offset=offset, length=length,
            version_id=version_id)

    def get_object_stream(self, bucket: str, object_name: str,
                          offset: int = 0, length: int = -1,
                          version_id: str = ""):
        return self.set_for(object_name).get_object_stream(
            bucket, object_name, offset=offset, length=length,
            version_id=version_id)

    def get_object_info(self, bucket: str, object_name: str,
                        version_id: str = "") -> ObjectInfo:
        return self.set_for(object_name).get_object_info(
            bucket, object_name, version_id)

    def delete_object(self, bucket: str, object_name: str,
                      version_id: str = "",
                      versioned: bool = False) -> ObjectInfo:
        return self.set_for(object_name).delete_object(
            bucket, object_name, version_id, versioned=versioned)

    def object_exists(self, bucket: str, object_name: str) -> bool:
        return self.set_for(object_name).object_exists(bucket, object_name)

    def put_object_tags(self, bucket: str, object_name: str, tags: str,
                        version_id: str = "") -> None:
        return self.set_for(object_name).put_object_tags(
            bucket, object_name, tags, version_id)

    def update_object_metadata(self, bucket: str, object_name: str,
                               updates: dict, version_id: str = "") -> None:
        return self.set_for(object_name).update_object_metadata(
            bucket, object_name, updates, version_id)

    def list_object_versions(self, bucket: str, prefix: str = "",
                             max_keys: int = 1000,
                             marker: str = "") -> list[ObjectInfo]:
        per_set, _ = parallel_map(
            [lambda s=s: s.list_object_versions(bucket, prefix=prefix,
                                                max_keys=max_keys,
                                                marker=marker)
             for s in self.sets])
        merged: list[ObjectInfo] = []
        for lst in per_set:
            if lst:
                merged.extend(lst)
        merged.sort(key=lambda o: (o.name, -o.mod_time, o.version_id))
        return merged[:max_keys]

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000,
                     marker: str = "") -> list[ObjectInfo]:
        """Merge sorted per-set listings."""
        per_set, _ = parallel_map(
            [lambda s=s: s.list_objects(bucket, prefix=prefix,
                                        max_keys=max_keys, marker=marker)
             for s in self.sets])
        merged: list[ObjectInfo] = []
        for lst in per_set:
            if lst:
                merged.extend(lst)
        merged.sort(key=lambda o: o.name)
        return merged[:max_keys]

    # -- multipart (dispatch by object name) ----------------------------

    @property
    def multipart(self):
        return _SetsMultipart(self)

    # -- heal -----------------------------------------------------------

    @property
    def healer(self):
        return _SetsHealer(self)

class _SetsMultipart:
    def __init__(self, sets: ErasureSets):
        self._sets = sets

    def __getattr__(self, name):
        sets = self._sets

        def dispatch(bucket, object_name, *a, **kw):
            return getattr(sets.set_for(object_name).multipart, name)(
                bucket, object_name, *a, **kw)

        if name in ("new_multipart_upload", "put_object_part",
                    "list_parts", "complete_multipart_upload",
                    "abort_multipart_upload", "get_upload_meta"):
            return dispatch
        if name == "list_uploads":
            def list_uploads(bucket, prefix=""):
                out = []
                for s in sets.sets:
                    out.extend(s.multipart.list_uploads(bucket, prefix))
                return sorted(out, key=lambda x: (x["object"],
                                                  x["upload_id"]))
            return list_uploads
        if name == "min_part_size":
            return sets.sets[0].multipart.min_part_size
        raise AttributeError(name)


class _SetsHealer:
    def __init__(self, sets: ErasureSets):
        self._sets = sets

    def heal_object(self, bucket: str, object_name: str,
                    dry_run: bool = False):
        return self._sets.set_for(object_name).healer.heal_object(
            bucket, object_name, dry_run=dry_run)

    def heal_object_or_queue(self, bucket: str, object_name: str,
                             dry_run: bool = False):
        return self._sets.set_for(object_name).healer \
            .heal_object_or_queue(bucket, object_name, dry_run=dry_run)

    def heal_bucket(self, bucket: str) -> list[int]:
        healed = []
        for s in self._sets.sets:
            healed.extend(s.healer.heal_bucket(bucket))
        return healed

    def heal_all(self) -> list:
        out = []
        for s in self._sets.sets:
            for binfo in s.list_buckets():
                s.healer.heal_bucket(binfo["name"])
                for obj in s.list_objects(binfo["name"],
                                          max_keys=1_000_000):
                    out.append(s.healer.heal_object_or_queue(
                        binfo["name"], obj.name))
        return out
