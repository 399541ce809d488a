"""Metacache: cached, quorum-resolved bucket listings (ref the metacache
engine, cmd/metacache.go:54, cmd/metacache-server-pool.go:38 listPath,
cmd/metacache-set.go streamMetadataParts, cmd/metacache-stream.go block
persistence).

One listing scan = parallel `walk_dir` over the set's disks → k-way
merge with per-version quorum resolve → entry stream, kept in memory and
persisted as compressed block objects under
`.minio.sys/buckets/<bucket>/.metacache/<id>/block-<n>` (5000 entries
per block like the reference, s2-analog LZ block compression).

Invalidation is tracker-first: every mutation on this node bumps the
bucket's DataUpdateTracker counter, and a cache whose counter snapshot
is stale is rescanned — giving read-after-write listings on the serving
node. A TTL backstop bounds staleness for writes arriving via other
nodes (ref metacache's seconds-level eventual consistency window).

The port's own copy of ``minio_tpu/listing/metacache.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import threading
import time
import uuid

from ..parallel.quorum import parallel_map, read_quorum
from ..storage.metadata import FileInfo
from ..utils.compress import compress_stream, decompress_stream
from .merge import merge_resolve

BLOCK_ENTRIES = 5000          # ref metacacheBlockSize, cmd/metacache.go:42
DEFAULT_TTL = 10.0            # backstop for cross-node writes
CACHE_PREFIX = "buckets"      # under .minio.sys


class _Cache:
    __slots__ = ("cache_id", "bucket", "root", "entries", "created",
                 "counter", "cycle")

    def __init__(self, cache_id, bucket, root, entries, created, counter,
                 cycle):
        self.cache_id = cache_id
        self.bucket = bucket
        self.root = root            # prefix the scan covered
        self.entries = entries      # [{"name","versions"}...] sorted
        self.created = created
        self.counter = counter      # tracker counter at scan time
        self.cycle = cycle          # tracker bloom cycle at scan time


class MetacacheManager:
    """Per-engine listing cache over one erasure set's disks."""

    def __init__(self, engine, ttl: float = DEFAULT_TTL):
        self.engine = engine
        self.ttl = ttl
        self._mu = threading.Lock()
        self._caches: dict[tuple[str, str], _Cache] = {}
        self.scans = 0  # observability: number of real disk scans
        self.last_persist: threading.Thread | None = None
        # Cluster sharing (ref updateMetacacheListing routing,
        # cmd/metacache-set.go:247, cmd/metacache-bucket.go): in
        # distributed mode the cluster wiring installs a
        # rpc.peer.MetacacheShare here plus this manager's (pool, set)
        # address; every (bucket, root) then has ONE owning node whose
        # scan all nodes reuse, instead of N nodes doing N walks.
        self.peer_share = None
        self.share_id: tuple[int, int] = (0, 0)
        self.peer_serves = 0  # served-from-peer counter (tests/metrics)
        # (bucket, root) -> OUR tracker counter at the last owner
        # fetch; a moved counter means this node wrote since then and
        # the next fetch must force the owner to rescan.
        self._peer_fetch_counters: dict[tuple[str, str], int] = {}

    # -- scan -------------------------------------------------------------

    def _scan(self, bucket: str, root: str) -> list[dict]:
        eng = self.engine
        results, _errs = parallel_map(
            [lambda d=d: d.walk_dir(bucket, root) for d in eng.disks])
        self.scans += 1
        return merge_resolve(list(results), read_quorum(eng.k))

    def _persist(self, cache: _Cache, old_id: str | None) -> None:
        """Write entry blocks back as compressed objects in .minio.sys
        and retire the replaced cache's blocks (best effort — the cache
        is advisory; ref metacache block objects persisted through the
        object layer + manager GC, cmd/metacache-manager.go). Runs off
        the listing hot path in a daemon thread."""
        if old_id:
            old = (f"{CACHE_PREFIX}/{cache.bucket}/.metacache/{old_id}")
            for d in self.engine.disks:
                try:
                    d.delete(".minio.sys", old, recursive=True)
                except Exception:
                    continue
        base = (f"{CACHE_PREFIX}/{cache.bucket}/.metacache/"
                f"{cache.cache_id}")
        info = {"id": cache.cache_id, "bucket": cache.bucket,
                "root": cache.root, "created": cache.created,
                "entries": len(cache.entries),
                "blocks": (len(cache.entries) + BLOCK_ENTRIES - 1)
                // BLOCK_ENTRIES}
        try:
            for n in range(info["blocks"]):
                blk = cache.entries[n * BLOCK_ENTRIES:
                                    (n + 1) * BLOCK_ENTRIES]
                raw = "\n".join(json.dumps(e, sort_keys=True)
                                for e in blk).encode()
                blob = compress_stream(raw)
                for d in self.engine.disks:
                    try:
                        d.write_all(".minio.sys", f"{base}/block-{n}",
                                    blob)
                        break  # one copy is enough for an advisory cache
                    except Exception:
                        continue
            for d in self.engine.disks:
                try:
                    d.write_all(".minio.sys", f"{base}/info.json",
                                json.dumps(info).encode())
                    break
                except Exception:
                    continue
        except Exception:
            pass

    @staticmethod
    def load_persisted(disk, bucket: str, cache_id: str) -> list[dict]:
        """Read a persisted cache back from one disk (resume/debug path;
        ref metacache-stream block reader)."""
        base = f"{CACHE_PREFIX}/{bucket}/.metacache/{cache_id}"
        info = json.loads(disk.read_all(".minio.sys", f"{base}/info.json"))
        entries: list[dict] = []
        for n in range(info["blocks"]):
            raw = decompress_stream(
                disk.read_all(".minio.sys", f"{base}/block-{n}"))
            entries.extend(json.loads(line)
                           for line in raw.decode().splitlines() if line)
        return entries

    # -- cache lookup -----------------------------------------------------

    def _fresh(self, c: _Cache, tracker, counter: int,
               now: float) -> bool:
        if self.ttl and now - c.created > self.ttl:
            return False            # bound staleness from remote writers
        if c.counter == counter:
            return True
        # The bucket changed — but a rooted cache survives when the
        # bloom says nothing changed under ITS prefix root (false
        # positives only cost a rescan).
        if c.root and tracker is not None:
            # completed bloom cycles since the scan; current is always
            # consulted too
            back = max(0, tracker.cycle - c.cycle)
            return not tracker.changed_under(c.bucket, c.root, back)
        return False

    def _entries_for(self, bucket: str, prefix: str, after: str = ""):
        """Entries covering `prefix`, name > `after` when peer-served
        (iterable, sorted by name): local cache/scan when this node
        owns the (bucket, root), a paged peer stream when another node
        does. `after` (the caller's pagination marker) seeds the
        owner-side cursor so page k of a paginated listing pulls one
        page over the wire, not k pages."""
        root = prefix.split("/", 1)[0] if "/" in prefix else ""
        share = self.peer_share
        if share is not None:
            owner = share.owner_key(bucket, root)
            if owner is not None:
                # Read-after-write THROUGH THIS NODE survives sharing:
                # the owner's tracker never sees writes done via other
                # nodes, so when OUR tracker moved since our last fetch
                # of this root, the first page asks the owner to drop
                # its cache and rescan (write-then-list costs one scan,
                # exactly like the unshared design; read-mostly listing
                # stays shared).
                tracker = getattr(self.engine, "update_tracker", None)
                counter = (tracker.bucket_counter(bucket) if tracker
                           else -1)
                key = (bucket, root)
                force = self._peer_fetch_counters.get(key) != counter
                # The counter snapshot is recorded only after the
                # owner actually SERVES the first forced page
                # (_peer_then_local) — recording it here would let a
                # never-iterated or transport-failed listing swallow
                # the owner-cache invalidation and serve stale
                # read-after-write results (ADVICE r5). A concurrent
                # stale overwrite can only force one extra rescan,
                # never skip one.
                return self._peer_then_local(share, owner, bucket,
                                             root, after, force,
                                             key, counter)
        return self._entries_local(bucket, root)

    def _mark_peer_fetched(self, key, counter) -> None:
        """A forced owner fetch completed: writes up to `counter` are
        now reflected in the owner's cache."""
        if key is not None:
            self._peer_fetch_counters[key] = counter

    def _peer_then_local(self, share, owner: str, bucket: str,
                         root: str, after: str, force: bool = False,
                         key=None, counter=None):
        """Stream the owner's entries; on ANY transport failure —
        first page or mid-stream — continue from a local scan at the
        last yielded name, so an owner crash degrades a listing to a
        local walk instead of failing it (availability beats the
        shared-scan optimization). The fetch-counter snapshot commits
        only once the owner has actually served the first page (an
        empty-but-successful listing counts) — a failed or abandoned
        forced fetch keeps the force sticky for the next listing."""
        last = after
        it = share.fetch_entries(owner, self.share_id, bucket, root,
                                 after=after, force=force)
        served = False
        while True:
            try:
                e = next(it)
            except StopIteration:
                if not served:
                    # Owner answered (empty page): the force was
                    # delivered; commit the snapshot.
                    self._mark_peer_fetched(key, counter)
                return
            except Exception:
                for e2 in self._entries_local(bucket, root):
                    if e2["name"] > last:
                        yield e2
                return
            if not served:
                served = True
                self.peer_serves += 1
                self._mark_peer_fetched(key, counter)
            last = e["name"]
            yield e

    def _entries_local(self, bucket: str, root: str) -> list[dict]:
        """Serve entries from this node's cache, scanning if stale.
        Caches are registered per prefix-root (first path segment, like
        the reference's per-prefix metacache id selection). This is
        also what the peer RPC serves to non-owner nodes — it must
        never delegate back out."""
        key = (bucket, root)
        tracker = getattr(self.engine, "update_tracker", None)
        counter = tracker.bucket_counter(bucket) if tracker else -1
        now = time.time()
        with self._mu:
            c = self._caches.get(key)
            if c is not None and self._fresh(c, tracker, counter, now):
                return c.entries
            old_id = c.cache_id if c is not None else None
        entries = self._scan(bucket, root)
        c = _Cache(uuid.uuid4().hex, bucket, root, entries, now, counter,
                   tracker.cycle if tracker else 0)
        with self._mu:
            self._caches[key] = c
        # mtpu-lint: disable=R1 -- write-behind persist is deliberately decoupled: the listing answered already
        t = threading.Thread(target=self._persist, args=(c, old_id),
                             daemon=True)
        self.last_persist = t       # joinable by tests/shutdown
        t.start()
        return entries

    def drop_bucket(self, bucket: str) -> None:
        with self._mu:
            dropped = [self._caches.pop(k)
                       for k in [k for k in self._caches
                                 if k[0] == bucket]]
        for d in self.engine.disks:  # retire persisted blocks too
            try:
                d.delete(".minio.sys",
                         f"{CACHE_PREFIX}/{bucket}/.metacache",
                         recursive=True)
            except Exception:
                continue
        del dropped

    # -- public listing ---------------------------------------------------

    def list_path(self, bucket: str, prefix: str = "", marker: str = "",
                  max_keys: int = 1000) -> list[FileInfo]:
        """Latest live version per key (ListObjects view)."""
        out: list[FileInfo] = []
        for e in self._entries_for(bucket, prefix, after=marker):
            name = e["name"]
            if prefix and not name.startswith(prefix):
                continue
            if marker and name <= marker:
                continue
            if not e["versions"]:
                continue
            latest = e["versions"][0]
            if latest.get("type") == "delete-marker":
                continue
            out.append(FileInfo.from_version_dict(bucket, name, latest))
            if len(out) >= max_keys:
                break
        return out

    def list_versions(self, bucket: str, prefix: str = "",
                      marker: str = "", max_keys: int = 1000,
                      ) -> list[FileInfo]:
        """All versions newest-first per key (ListObjectVersions view).

        `marker` is a key-level marker, so truncation happens only at
        key boundaries (a key's versions are never split across pages;
        max_keys may be exceeded by the last key's version count)."""
        out: list[FileInfo] = []
        for e in self._entries_for(bucket, prefix, after=marker):
            name = e["name"]
            if prefix and not name.startswith(prefix):
                continue
            if marker and name <= marker:
                continue
            out.extend(FileInfo.from_version_dict(bucket, name, v)
                       for v in e["versions"])
            if len(out) >= max_keys:
                break
        return out
