"""ErasureServerPools — the top-level ObjectLayer: N pools of erasure
sets; writes go to the pool with the most free space unless the object
already exists in another pool (ref cmd/erasure-server-pool.go:42 struct,
:215 getServerPoolsAvailableSpace, :593 PutObject, :524 GetObjectNInfo).

The port's own copy of ``minio_tpu/erasure/pools.py``, with no change in
behaviour.
"""

from __future__ import annotations

from ..parallel.quorum import parallel_map
from .engine import (BucketExists, BucketNotFound, ObjectInfo,
                     ObjectNotFound)
from .sets import ErasureSets, fan_out_bucket_op


class ErasureServerPools:
    def __init__(self, pools: list[ErasureSets]):
        if not pools:
            raise ValueError("need at least one pool")
        self.pools = pools

    @property
    def k(self) -> int:
        """First pool's geometry (storage-class parity validation)."""
        return self.pools[0].k

    @property
    def m(self) -> int:
        return self.pools[0].m

    def shutdown(self) -> None:
        """Stop every pool's background daemons (see
        ErasureObjects.shutdown)."""
        for p in self.pools:
            p.shutdown()

    # -- placement ------------------------------------------------------

    def _pool_free_space(self, pool: ErasureSets) -> int:
        total = 0
        for s in pool.sets:
            for d in s.disks:
                try:
                    total += d.disk_info()["free"]
                except Exception:
                    pass
        return total

    def _pool_with_object(self, bucket: str, object_name: str,
                          ) -> int | None:
        """Any-version probe (a delete marker as latest still pins the
        key to its pool); only a definitive not-found means 'not here' —
        quorum/I/O errors abort placement rather than risking a write
        landing in a second pool and later serving stale data."""
        for i, pool in enumerate(self.pools):
            try:
                if pool.object_exists(bucket, object_name):
                    return i
            except BucketNotFound:
                continue
        return None

    def _put_pool_index(self, bucket: str, object_name: str) -> int:
        if len(self.pools) == 1:
            return 0
        existing = self._pool_with_object(bucket, object_name)
        if existing is not None:
            return existing
        frees = [self._pool_free_space(p) for p in self.pools]
        return max(range(len(frees)), key=lambda i: frees[i])

    # -- buckets --------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        fan_out_bucket_op(self.pools, "make_bucket", BucketExists, bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        fan_out_bucket_op(self.pools, "delete_bucket", BucketNotFound,
                          bucket, force=force)

    def list_buckets(self) -> list[dict]:
        return self.pools[0].list_buckets()

    def bucket_exists(self, bucket: str) -> bool:
        return self.pools[0].bucket_exists(bucket)

    # -- objects --------------------------------------------------------

    supports_streaming_put = True

    def put_object(self, bucket: str, object_name: str, data,
                   metadata: dict | None = None,
                   versioned: bool = False,
                   parity_shards: int | None = None,
                   algorithm: str | None = None) -> ObjectInfo:
        idx = self._put_pool_index(bucket, object_name)
        return self.pools[idx].put_object(bucket, object_name, data,
                                          metadata=metadata,
                                          versioned=versioned,
                                          parity_shards=parity_shards,
                                          algorithm=algorithm)

    def _probe(self, bucket: str, object_name: str, op):
        """Try each pool in order; first hit wins (ref pool probe loop,
        cmd/erasure-server-pool.go:569-593)."""
        last: Exception = ObjectNotFound(f"{bucket}/{object_name}")
        for pool in self.pools:
            try:
                return op(pool)
            except ObjectNotFound as e:
                last = e
            except BucketNotFound as e:
                last = e
        raise last

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1, version_id: str = ""):
        return self._probe(bucket, object_name,
                           lambda p: p.get_object(
                               bucket, object_name, offset=offset,
                               length=length, version_id=version_id))

    def get_object_stream(self, bucket: str, object_name: str,
                          offset: int = 0, length: int = -1,
                          version_id: str = ""):
        return self._probe(bucket, object_name,
                           lambda p: p.get_object_stream(
                               bucket, object_name, offset=offset,
                               length=length, version_id=version_id))

    def get_object_info(self, bucket: str, object_name: str,
                        version_id: str = "") -> ObjectInfo:
        return self._probe(bucket, object_name,
                           lambda p: p.get_object_info(
                               bucket, object_name, version_id))

    def delete_object(self, bucket: str, object_name: str,
                      version_id: str = "",
                      versioned: bool = False) -> ObjectInfo:
        """Delete in the pool that HOLDS the key (a versioned delete
        must write its marker next to the existing versions, not into
        whichever pool answers first; ref DeleteObject pool routing,
        cmd/erasure-server-pool.go). A versioned delete of a key that
        exists nowhere still writes a marker — into the put-placement
        pool, per S3 semantics."""
        idx = self._pool_with_object(bucket, object_name)
        if idx is None:
            if versioned and not version_id:
                idx = self._put_pool_index(bucket, object_name)
            else:
                if not self.pools[0].bucket_exists(bucket):
                    raise BucketNotFound(bucket)
                raise ObjectNotFound(f"{bucket}/{object_name}")
        return self.pools[idx].delete_object(bucket, object_name,
                                             version_id,
                                             versioned=versioned)

    def object_exists(self, bucket: str, object_name: str) -> bool:
        return self._pool_with_object(bucket, object_name) is not None

    def put_object_tags(self, bucket: str, object_name: str, tags: str,
                        version_id: str = "") -> None:
        return self._probe(bucket, object_name,
                           lambda p: p.put_object_tags(
                               bucket, object_name, tags, version_id))

    def update_object_metadata(self, bucket: str, object_name: str,
                               updates: dict, version_id: str = "") -> None:
        return self._probe(bucket, object_name,
                           lambda p: p.update_object_metadata(
                               bucket, object_name, updates, version_id))

    def list_object_versions(self, bucket: str, prefix: str = "",
                             max_keys: int = 1000,
                             marker: str = "") -> list[ObjectInfo]:
        per_pool, _ = parallel_map(
            [lambda p=p: p.list_object_versions(bucket, prefix=prefix,
                                                max_keys=max_keys,
                                                marker=marker)
             for p in self.pools])
        merged: list[ObjectInfo] = []
        seen: set[tuple] = set()
        for lst in per_pool:
            for o in lst or []:
                key = (o.name, o.version_id)
                if key not in seen:
                    seen.add(key)
                    merged.append(o)
        merged.sort(key=lambda o: (o.name, -o.mod_time, o.version_id))
        return merged[:max_keys]

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000,
                     marker: str = "") -> list[ObjectInfo]:
        per_pool, _ = parallel_map(
            [lambda p=p: p.list_objects(bucket, prefix=prefix,
                                        max_keys=max_keys, marker=marker)
             for p in self.pools])
        merged: list[ObjectInfo] = []
        seen: set[str] = set()
        for lst in per_pool:
            for o in lst or []:
                if o.name not in seen:
                    seen.add(o.name)
                    merged.append(o)
        merged.sort(key=lambda o: o.name)
        return merged[:max_keys]

    # -- multipart ------------------------------------------------------

    @property
    def multipart(self):
        return _PoolsMultipart(self)

    @property
    def healer(self):
        return _PoolsHealer(self)


class _PoolsMultipart:
    def __init__(self, pools: ErasureServerPools):
        self._pools = pools

    def _pool_for_upload(self, bucket, object_name, upload_id):
        from .multipart import UploadNotFound
        for pool in self._pools.pools:
            try:
                # Cheap existence probe of the upload record only.
                pool.set_for(object_name).multipart._load_upload(
                    bucket, object_name, upload_id)
                return pool
            except UploadNotFound:
                continue
        raise UploadNotFound(upload_id)

    def new_multipart_upload(self, bucket, object_name, metadata=None):
        idx = self._pools._put_pool_index(bucket, object_name)
        return self._pools.pools[idx].multipart.new_multipart_upload(
            bucket, object_name, metadata)

    def put_object_part(self, bucket, object_name, upload_id,
                        part_number, data, actual_size=None):
        pool = self._pool_for_upload(bucket, object_name, upload_id)
        return pool.multipart.put_object_part(
            bucket, object_name, upload_id, part_number, data,
            actual_size=actual_size)

    def get_upload_meta(self, bucket, object_name, upload_id):
        pool = self._pool_for_upload(bucket, object_name, upload_id)
        return pool.multipart.get_upload_meta(bucket, object_name,
                                              upload_id)

    def list_parts(self, bucket, object_name, upload_id):
        pool = self._pool_for_upload(bucket, object_name, upload_id)
        return pool.multipart.list_parts(bucket, object_name, upload_id)

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts):
        pool = self._pool_for_upload(bucket, object_name, upload_id)
        return pool.multipart.complete_multipart_upload(
            bucket, object_name, upload_id, parts)

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        pool = self._pool_for_upload(bucket, object_name, upload_id)
        return pool.multipart.abort_multipart_upload(
            bucket, object_name, upload_id)

    def list_uploads(self, bucket, prefix=""):
        out = []
        for pool in self._pools.pools:
            out.extend(pool.multipart.list_uploads(bucket, prefix))
        return sorted(out, key=lambda x: (x["object"], x["upload_id"]))


class _PoolsHealer:
    def __init__(self, pools: ErasureServerPools):
        self._pools = pools

    def heal_object(self, bucket, object_name, dry_run=False):
        return self._pools._probe(
            bucket, object_name,
            lambda p: p.healer.heal_object(bucket, object_name,
                                           dry_run=dry_run))

    def heal_object_or_queue(self, bucket, object_name, dry_run=False):
        return self._pools._probe(
            bucket, object_name,
            lambda p: p.healer.heal_object_or_queue(
                bucket, object_name, dry_run=dry_run))

    def heal_bucket(self, bucket):
        out = []
        for pool in self._pools.pools:
            out.extend(pool.healer.heal_bucket(bucket))
        return out

    def heal_all(self):
        out = []
        for pool in self._pools.pools:
            out.extend(pool.healer.heal_all())
        return out
