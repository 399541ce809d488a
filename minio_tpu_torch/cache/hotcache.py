"""Hot-object serving tier: a two-level (memory + disk) decoded-object
cache consulted by the erasure engine's GET path before shard fan-out.

A million-user workload is dominated by many GETs of few objects, and
without this tier every GET — even of the hottest key — pays a full
k-shard erasure read plus RS decode. The online-EC-on-SSD study
(arXiv:1709.05365) shows queueing on repeated reads, not codec speed,
dominates at that scale. This module is the read-side counterpart of
the EncodeCoalescer: where that coalesces concurrent PUT encodes
into one device dispatch, this coalesces concurrent GETs of one key
into one erasure read.

Shape:

  - **Single-flight fill**: concurrent GETs of the same cold key
    register one ``_Fill``; the first reader performs the erasure read
    and tees every decoded chunk into the fill buffer, waiters stream
    from the filling entry as chunks land (``_WaitStream``) — N cold
    GETs of one key cost exactly one shard fan-out + decode. A fill
    that raises (or whose client abandons the stream) wakes and fails
    its waiters, who transparently fall back to their own erasure read
    at the byte position they had reached (mtpu-lint R2 counts fill
    registrations as a resource: no orphaned-waiters path).
  - **QoS-aware admission and eviction**: a TinyLFU-style count-min
    frequency sketch decides retention (``min_hits`` floor, and a
    candidate never displaces a hotter victim), the memory tier is a
    segmented LRU (probation + protected) so one huge scan cannot
    flush the hot set, and background-lane reads (heal, crawler,
    replication sweeps) neither fill nor count frequency — they can
    hit, but a bg sweep can never shape the cache.
  - **Invalidation with versioned epochs**: every overwrite / delete /
    multipart-complete invalidates locally and fans out a
    ``cache_invalidate`` peer RPC carrying a monotonic per-key epoch.
    In-flight fills stamped with an older epoch are discarded at
    finish (overwrite-during-fill can never insert stale bytes). A
    LOST invalidation cannot serve stale bytes either: disk-tier hits
    always revalidate the entry's ETag against a metadata-quorum read,
    and memory-tier hits revalidate once their ``revalidate`` window
    expires — worst-case staleness after a lost RPC is that window,
    not forever.
  - **Drivemon-informed disk-tier placement**: disk-tier directories
    map (by path prefix) to the drive-health monitor's endpoints;
    suspect / faulty / quarantined drives neither receive new cache
    files nor serve existing ones.

Config-KV subsystem ``cache`` (live-reloadable): ``enable``,
``mem_bytes``, ``disk_bytes``, ``dirs``, ``min_hits``,
``max_object_bytes``, ``revalidate``. Everything reports through
metrics2 (hit/miss/fill/coalesced-wait/evict/stale/invalidation
series + byte/entry gauges), lands ``cache.hit`` / ``cache.fill``
span events on the request trace (slowlog blame and timeline
exemplars see it), and the timeline carries a cache row rendered by
``tools/mtpu_top.py``.

Migration note: this tier replaces the former ``CacheObjectLayer``
gateway wrapper (``MINIO_CACHE_DRIVES`` env). The env-only path is
gone; configure the serving tier through config-KV instead, e.g.::

    mc admin config set cache enable=on dirs=/mnt/d1/cache,/mnt/d2/cache

The port's own copy of ``minio_tpu/cache/hotcache.py``, with no change in
behaviour.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import threading
import time
import uuid
from array import array
from collections import OrderedDict

# One read chunk for disk-tier streaming: ranges are served by seeking
# and reading windows, never by materializing the whole entry.
DISK_READ_CHUNK = 256 * 1024
# Fraction of the memory tier reserved for the protected SLRU segment.
PROTECTED_FRACTION = 0.8
# All disk-tier files live under this subdirectory of each configured
# dir, so (re)configuration can wipe stale files without touching
# anything else on the drive.
DISK_SUBDIR = "mtpu-cache"

MEM, DISK = "mem", "disk"


class FillAborted(Exception):
    """The single-flight fill a waiter was streaming from failed (its
    source raised, or its client abandoned the stream). Carries the
    cause; waiters use it to trigger their fallback read."""


class ClientAbandoned(Exception):
    """The filling client closed its stream before the fill finished."""


class _Sketch:
    """Count-min frequency sketch with TinyLFU-style aging: counters
    halve once the sample window saturates, so frequency estimates
    track the RECENT access mix instead of all history (a scan from an
    hour ago must not outvote today's hot set)."""

    ROWS = 4

    def __init__(self, width: int = 8192):
        self.width = width
        self._rows = [array("I", [0] * width) for _ in range(self.ROWS)]
        self._adds = 0
        # Aging threshold: ~8 samples per counter on average.
        self._sample_max = 8 * width

    def _indexes(self, key) -> list[int]:
        h = hash(key)
        out = []
        for r in range(self.ROWS):
            h = hash((r, h))
            out.append(h % self.width)
        return out

    def add(self, key) -> None:
        for r, i in enumerate(self._indexes(key)):
            self._rows[r][i] += 1
        self._adds += 1
        if self._adds >= self._sample_max:
            self._adds //= 2
            for row in self._rows:
                for i in range(self.width):
                    row[i] >>= 1

    def estimate(self, key) -> int:
        return min(row[i]
                   for row, i in zip(self._rows, self._indexes(key)))


class _Entry:
    """One cached decoded object (either tier)."""

    __slots__ = ("full_key", "nk", "data", "path", "dir", "info",
                 "etag", "size", "epoch", "filled_at", "last_validated",
                 "pins", "dead")

    def __init__(self, full_key, nk, info, etag, size, epoch):
        self.full_key = full_key          # (ns, bucket, key)
        self.nk = nk                      # (bucket, key)
        self.data: bytes | None = None    # memory tier
        self.path: str | None = None      # disk tier file
        self.dir: str | None = None
        self.info = info
        self.etag = etag
        self.size = size
        self.epoch = epoch
        self.filled_at = time.monotonic()
        self.last_validated = self.filled_at
        self.pins = 0                     # active disk-tier readers
        self.dead = False                 # evicted while pinned


class _Fill:
    """One in-flight single-flight fill. The registering reader owns
    it: exactly one of finish() / abort() must run (the reader()
    wrapper guarantees it on every exit path, and mtpu-lint R2 flags
    registrations without a structural release)."""

    def __init__(self, cache: "HotObjectCache", full_key, nk,
                 etag: str, size: int, info, epoch0: int):
        self._cache = cache
        self.full_key = full_key
        self.nk = nk
        self.etag = etag
        self.size = size
        self.info = info
        self.epoch0 = epoch0
        self.invalidated = False          # set under cache._mu
        self.cv = threading.Condition()
        self.chunks: list[bytes] = []
        self.nbytes = 0
        self.done = False
        self.error: BaseException | None = None
        self.waiters = 0

    # Chunks are appended by the single filling thread; waiters only
    # ever read them under cv, so append takes cv alone (never the
    # cache lock — the two locks are never nested, in either order).
    def append(self, chunk: bytes) -> None:
        with self.cv:
            self.chunks.append(bytes(chunk))
            self.nbytes += len(chunk)
            self.cv.notify_all()

    def finish(self) -> None:
        self._cache._finish_fill(self)

    def abort(self, exc: BaseException) -> None:
        self._cache._abort_fill(self, exc)

    def reader(self, source) -> "_FillReader":
        """Wrap the filling reader's chunk iterator: ownership of this
        fill transfers into the returned stream, which finishes or
        aborts it on every exit path."""
        return _FillReader(self, source)


class _FillReader:
    """The filling client's stream: yields source chunks while teeing
    them into the fill buffer. Exhaustion finishes the fill (admission
    decision), any error — including the client abandoning the
    response mid-body — aborts it and wakes the waiters."""

    def __init__(self, fill: _Fill, source):
        self._fill = fill
        self._source = iter(source)
        self._settled = False

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._settled:
            raise StopIteration
        try:
            chunk = next(self._source)
        except StopIteration:
            self._settled = True
            self._fill.finish()
            raise
        except BaseException as e:
            self._settled = True
            self._fill.abort(e)
            raise
        self._fill.append(chunk)
        return chunk

    def close(self) -> None:
        if self._settled:
            return
        self._settled = True
        try:
            self._fill.abort(ClientAbandoned(
                f"fill of {self._fill.nk} abandoned mid-stream"))
        finally:
            close = getattr(self._source, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _WaitStream:
    """A coalesced waiter's stream over [offset, offset+length) of a
    fill in progress. If the fill fails, the waiter falls back to its
    own erasure read at the byte position it had reached (``resume``),
    so a dying filler never strands its waiters."""

    def __init__(self, fill: _Fill, offset: int, length: int, resume):
        self._fill = fill
        self._offset = offset
        self._want = length
        self._resume = resume
        self._yielded = 0
        self._chunk_i = 0          # next fill chunk index
        self._chunk_pos = 0        # absolute byte offset of chunk_i
        self._fallback = None
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._closed or self._yielded >= self._want:
            raise StopIteration
        if self._fallback is not None:
            chunk = next(self._fallback)
            self._yielded += len(chunk)
            if self._yielded >= self._want:
                # The fallback read covers exactly the remaining range:
                # observe its exhaustion now so a fill it registered
                # settles as finished, not abandoned.
                try:
                    next(self._fallback)
                except StopIteration:
                    pass
            return chunk
        fill = self._fill
        while True:
            with fill.cv:
                while (self._chunk_i >= len(fill.chunks)
                       and not fill.done):
                    # Bounded slices so a lost notify can never hang a
                    # request thread forever.
                    fill.cv.wait(1.0)
                chunks = fill.chunks
                n = len(chunks)
                error = fill.error
                done = fill.done
            while self._chunk_i < n:
                chunk = chunks[self._chunk_i]
                start = self._chunk_pos
                self._chunk_i += 1
                self._chunk_pos += len(chunk)
                lo = max(self._offset, start)
                hi = min(self._offset + self._want, start + len(chunk))
                if hi > lo:
                    piece = chunk[lo - start:hi - start]
                    self._yielded += len(piece)
                    return piece
            if self._yielded >= self._want:
                raise StopIteration
            if done:
                if error is None:
                    # Fill complete and range satisfied short — the
                    # object really ended here.
                    raise StopIteration
                return self._fail_over(error)

    def _fail_over(self, error: BaseException) -> bytes:
        if self._resume is None:
            raise FillAborted(str(error)) from error
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_cache_fills_total",
                     {"result": "waiter_fallback"})
        self._fallback = iter(self._resume(self._yielded))
        return self.__next__()

    def close(self) -> None:
        self._closed = True
        fb, self._fallback = self._fallback, None
        if fb is not None and hasattr(fb, "close"):
            try:
                fb.close()
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _DiskStream:
    """Range reader over one disk-tier file: seeks and reads bounded
    windows (never materializes the entry), holding a pin on the entry
    so eviction defers the unlink until the last reader drains."""

    def __init__(self, cache: "HotObjectCache", entry: _Entry,
                 offset: int, length: int):
        self._cache = cache
        self._entry = entry
        self._remaining = length
        self._f = open(entry.path, "rb")
        if offset:
            self._f.seek(offset)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._closed or self._remaining <= 0:
            self.close()
            raise StopIteration
        chunk = self._f.read(min(DISK_READ_CHUNK, self._remaining))
        if not chunk:
            self.close()
            raise StopIteration
        self._remaining -= len(chunk)
        return chunk

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._f.close()
        finally:
            self._cache._unpin(self._entry)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _copy_info(info):
    """Handlers mutate ObjectInfo.metadata; never hand out the cached
    instance itself."""
    out = copy.copy(info)
    out.metadata = dict(info.metadata)
    out.parts = list(info.parts)
    return out


def _span_event(name: str, **attrs) -> None:
    from ..obs.span import TRACER
    sp = TRACER.current()
    if sp is not None:
        sp.add_event(name, **attrs)


class HotObjectCache:
    """Process-wide serving tier (``HOTCACHE``). Keys carry a per-engine
    namespace (``ErasureObjects.cache_ns``) so unrelated engines in one
    process can never serve each other's bytes; invalidation addresses
    ``(bucket, key)`` and clears every namespace (over-invalidation is
    always safe)."""

    def __init__(self):
        self.enabled = False
        self.mem_bytes = 128 * 1024 * 1024
        self.disk_bytes = 1024 * 1024 * 1024
        self.min_hits = 1
        self.max_object_bytes = 32 * 1024 * 1024
        self.revalidate_s: float | None = 1.0   # None = never
        # Called (bucket, key, epoch) after a local invalidation while
        # enabled; the cluster wiring points it at
        # NotificationSys.cache_invalidate (async peer fan-out).
        self.peer_notify = None
        self._mu = threading.Lock()
        self._dirs: list[str] = []
        self._dir_eps: dict[str, str | None] = {}
        self._prob: OrderedDict[tuple, _Entry] = OrderedDict()
        self._prot: OrderedDict[tuple, _Entry] = OrderedDict()
        self._prot_used = 0   # protected-segment bytes, kept incrementally
        self._disk: OrderedDict[tuple, _Entry] = OrderedDict()
        self._by_name: dict[tuple, set[tuple]] = {}
        self._fills: dict[tuple, _Fill] = {}
        self._fill_bytes = 0
        self._mem_used = 0
        self._disk_used = 0
        self._epochs: dict[tuple, int] = {}
        self._sketch = _Sketch()
        self.counters = {
            "hit_mem": 0, "hit_disk": 0, "miss": 0, "fill": 0,
            "coalesced": 0, "evict": 0, "stale": 0, "invalidate": 0}

    # -- config ---------------------------------------------------------

    def configure(self, *, enable: bool, mem_bytes: int,
                  disk_bytes: int, dirs: list[str], min_hits: int,
                  max_object_bytes: int,
                  revalidate_s: float | None) -> None:
        """Live reload (config-KV ``cache`` subsystem). Disabling
        clears both tiers; shrinking evicts down to the new budgets;
        changing the dir set wipes and re-creates the disk tier (cache
        files are ephemeral by contract)."""
        dirs = [os.path.abspath(d) for d in dirs if d]
        with self._mu:
            dirs_changed = dirs != self._dirs
            was_enabled = self.enabled
            self.mem_bytes = int(mem_bytes)
            self.disk_bytes = int(disk_bytes)
            self.min_hits = int(min_hits)
            self.max_object_bytes = int(max_object_bytes)
            self.revalidate_s = revalidate_s
            self.enabled = bool(enable)
        if (was_enabled and not enable) or dirs_changed:
            self.clear()
        if dirs_changed:
            with self._mu:
                self._dirs = dirs
                self._dir_eps = {}
            for d in dirs:
                sub = os.path.join(d, DISK_SUBDIR)
                shutil.rmtree(sub, ignore_errors=True)
                try:
                    os.makedirs(sub, exist_ok=True)
                except OSError:
                    pass
        if enable:
            self._shrink_to_budget()
        self._publish_gauges()

    def clear(self) -> None:
        """Drop every entry and epoch (config disable, tests)."""
        with self._mu:
            unlink = [e for e in self._disk.values() if e.pins == 0]
            for e in self._disk.values():
                e.dead = True
            self._prob.clear()
            self._prot.clear()
            self._disk.clear()
            self._by_name.clear()
            self._epochs.clear()
            self._mem_used = 0
            self._prot_used = 0
            self._disk_used = 0
        for e in unlink:
            self._unlink(e)
        self._publish_gauges()

    def reset(self) -> None:
        """Test hook: clear() plus counters and the frequency sketch."""
        self.clear()
        with self._mu:
            self._sketch = _Sketch()
            for k in self.counters:
                self.counters[k] = 0

    # -- serving --------------------------------------------------------

    def serve(self, ns: str, bucket: str, key: str, offset: int,
              length: int, info_fn):
        """Serve [offset, offset+length) of bucket/key from the cache,
        or return None (miss / bypass). ``info_fn()`` must perform an
        UNCACHED metadata-quorum read returning the current ObjectInfo
        (raising the engine's not-found errors) — it is the ETag
        revalidation oracle for disk-tier hits and for memory-tier
        hits past the revalidation window."""
        if not self.enabled:
            return None
        full_key = (ns, bucket, key)
        fg = self._foreground()
        data = None
        with self._mu:
            if fg:
                self._sketch.add(full_key)
            entry, tier = self._lookup_locked(full_key, touch=fg)
            if entry is not None and tier == DISK:
                if not self._dir_healthy(entry.dir):
                    entry = None    # drive degraded: don't read it
                else:
                    entry.pins += 1
            elif entry is not None:
                # Capture the bytes UNDER the lock: a concurrent
                # capacity demotion rewrites entry.data to None after
                # staging the file — the reference we hold here stays
                # valid regardless.
                data = entry.data
            if entry is None:
                self.counters["miss"] += 1
        if entry is None:
            from ..obs.metrics2 import METRICS2
            METRICS2.inc("minio_tpu_v2_cache_misses_total")
            return None
        try:
            if not self._revalidated(entry, tier, info_fn):
                self.counters["stale"] += 1
                from ..obs.metrics2 import METRICS2
                METRICS2.inc("minio_tpu_v2_cache_stale_total",
                             {"tier": tier})
                METRICS2.inc("minio_tpu_v2_cache_misses_total")
                if tier == DISK:
                    # Release our pin BEFORE invalidating: invalidate
                    # marks the entry dead and defers the unlink to
                    # the last unpin — a pin held across it would leak
                    # the file (and its bytes) forever.
                    self._unpin(entry)
                    tier = None
                self.invalidate(bucket, key, propagate=False,
                                source="stale")
                return None
        except BaseException:
            if tier == DISK:
                self._unpin(entry)
            raise
        size = entry.size
        if offset < 0 or offset > size:
            if tier == DISK:
                self._unpin(entry)
            raise ValueError("invalid range")
        if length < 0:
            length = size - offset
        if offset + length > size:
            if tier == DISK:
                self._unpin(entry)
            raise ValueError("invalid range")
        info = _copy_info(entry.info)
        with self._mu:
            self.counters["hit_mem" if tier == MEM else "hit_disk"] += 1
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_cache_hits_total", {"tier": tier})
        _span_event("cache.hit", tier=tier, bytes=length)
        if length == 0 or size == 0:
            if tier == DISK:
                self._unpin(entry)
            return info, iter(())
        if tier == MEM:
            return info, iter((data[offset:offset + length],))
        try:
            return info, _DiskStream(self, entry, offset, length)
        except OSError:
            # File vanished under us (operator wiped the dir): treat
            # as a miss and drop the entry.
            self._unpin(entry)
            self.invalidate(bucket, key, propagate=False,
                            source="stale")
            return None

    def lookup_info(self, ns: str, bucket: str, key: str, info_fn):
        """Serve a HEAD / stat from the MEMORY tier (same revalidation
        policy as data hits; disk-tier stats gain nothing — the
        revalidating metadata read IS the uncached stat)."""
        if not self.enabled:
            return None
        full_key = (ns, bucket, key)
        fg = self._foreground()
        with self._mu:
            entry, tier = self._lookup_locked(full_key, touch=fg)
        if entry is None or tier != MEM:
            return None
        if not self._revalidated(entry, tier, info_fn):
            self.invalidate(bucket, key, propagate=False,
                            source="stale")
            return None
        return _copy_info(entry.info)

    def _lookup_locked(self, full_key, touch: bool = True):
        """Find an entry; when ``touch`` (foreground traffic only),
        LRU-bump it and promote probation -> protected (segmented
        LRU). Background sweeps pass touch=False: they may READ the
        cache but must never refresh recency or flood the protected
        segment — the same scan-pollution shield as the lane-gated
        frequency sketch."""
        e = self._prot.get(full_key)
        if e is not None:
            if touch:
                self._prot.move_to_end(full_key)
            return e, MEM
        if touch:
            e = self._prob.pop(full_key, None)
            if e is not None:
                self._prot[full_key] = e
                self._prot_used += e.size
                self._rebalance_protected()
                return e, MEM
        else:
            e = self._prob.get(full_key)
            if e is not None:
                return e, MEM
        e = self._disk.get(full_key)
        if e is not None:
            if touch:
                self._disk.move_to_end(full_key)
            return e, DISK
        return None, None

    def _rebalance_protected(self) -> None:
        # _prot_used is maintained incrementally: summing the segment
        # here would put O(resident entries) work under the cache lock
        # on every promotion — the hot path this tier exists to trim.
        cap = int(self.mem_bytes * PROTECTED_FRACTION)
        while self._prot_used > cap and len(self._prot) > 1:
            k, e = self._prot.popitem(last=False)
            self._prob[k] = e
            self._prot_used -= e.size

    def _revalidated(self, entry: _Entry, tier: str, info_fn) -> bool:
        """True when the entry may be served. Disk hits ALWAYS check
        the current ETag (a lost invalidation must not serve stale
        bytes from a tier that survives long); memory hits check once
        their revalidation window lapses."""
        now = time.monotonic()
        if tier == MEM:
            if self.revalidate_s is None:
                return True
            if now - entry.last_validated < self.revalidate_s:
                return True
        try:
            info = info_fn()
        except Exception:
            # Not-found or backend failure: either way this copy is
            # not servable without confirmation.
            return False
        if getattr(info, "etag", None) != entry.etag:
            return False
        entry.last_validated = now
        return True

    # -- single-flight fill ---------------------------------------------

    def join_fill(self, ns: str, bucket: str, key: str, etag: str,
                  offset: int, length: int, resume):
        """Join an in-flight fill of the same key+etag: returns a
        waiter stream over the requested range, or None when no
        matching fill is in flight."""
        if not self.enabled:
            return None
        full_key = (ns, bucket, key)
        with self._mu:
            f = self._fills.get(full_key)
            if f is None or f.etag != etag:
                return None
            f.waiters += 1
            self.counters["coalesced"] += 1
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_cache_coalesced_waits_total")
        _span_event("cache.fill", coalesced=True, bytes=length)
        return _WaitStream(f, offset, length, resume)

    def begin_fill(self, ns: str, bucket: str, key: str, info):
        """Register the single-flight fill for a FULL-object read, or
        return None (ineligible / someone else already filling / not
        foreground / object too large / fill budget exhausted). The
        returned fill is a resource: route it through ``reader()`` or
        ``abort()`` on every exit path (mtpu-lint R2)."""
        if not self.enabled or not self._foreground():
            return None
        size = int(info.size)
        if size <= 0 or size > self.max_object_bytes:
            return None
        full_key = (ns, bucket, key)
        nk = (bucket, key)
        with self._mu:
            if full_key in self._fills:
                return None
            # In-flight fill buffers are bounded by the memory budget:
            # past it, reads simply pass through uncoalesced.
            if self._fill_bytes + size > max(self.mem_bytes,
                                             self.max_object_bytes):
                return None
            fill = _Fill(self, full_key, nk, info.etag, size,
                         _copy_info(info), self._epochs.get(nk, 0))
            self._fills[full_key] = fill
            self._fill_bytes += size
        _span_event("cache.fill", bytes=size)
        return fill

    def _finish_fill(self, fill: _Fill) -> None:
        # Chunks are appended only by the (single) filling thread —
        # the same one calling finish — so they are stable here.
        data = b"".join(fill.chunks)
        from ..obs.metrics2 import METRICS2
        result = "cached"
        demote = None
        with self._mu:
            self._fills.pop(fill.full_key, None)
            self._fill_bytes -= fill.size
            nk = fill.nk
            if not self.enabled or fill.invalidated or \
                    self._epochs.get(nk, 0) != fill.epoch0:
                # enabled check: a config disable mid-fill already
                # cleared both tiers — admitting this straggler would
                # park unreachable bytes in a cache serve() no longer
                # consults.
                result = "invalidated"
            elif len(data) != fill.size:
                result = "short"   # truncated source; never retain
            elif self._sketch.estimate(fill.full_key) < self.min_hits:
                result = "uncached"
            else:
                entry = _Entry(fill.full_key, nk, fill.info,
                               fill.etag, fill.size,
                               self._epochs.get(nk, 0))
                entry.data = data
                demote = self._admit_mem_locked(entry)
            self.counters["fill"] += 1
            self._prune_epoch_locked(nk)
        METRICS2.inc("minio_tpu_v2_cache_fills_total",
                     {"result": result})
        with fill.cv:
            fill.done = True
            fill.cv.notify_all()
        # Demotions write files — strictly outside the cache lock.
        if demote:
            self._demote_to_disk(demote)
        self._publish_gauges()

    def _abort_fill(self, fill: _Fill, exc: BaseException) -> None:
        from ..obs.metrics2 import METRICS2
        with self._mu:
            self._fills.pop(fill.full_key, None)
            self._fill_bytes -= fill.size
            self.counters["fill"] += 1
            self._prune_epoch_locked(fill.nk)
        METRICS2.inc(
            "minio_tpu_v2_cache_fills_total",
            {"result": "abandoned" if isinstance(exc, ClientAbandoned)
             else "error"})
        with fill.cv:
            fill.error = exc
            fill.done = True
            fill.cv.notify_all()

    # -- admission / eviction -------------------------------------------

    def _admit_mem_locked(self, entry: _Entry) -> list[_Entry]:
        """Insert into the probation segment, evicting LRU victims to
        make room — but never displacing a victim the frequency sketch
        says is hotter than the candidate (TinyLFU admission: scans
        lose to the resident hot set). Returns victims to demote to
        the disk tier (file I/O happens outside the lock)."""
        demote: list[_Entry] = []
        if entry.size > self.mem_bytes:
            demote.append(entry)
            return demote
        cand_freq = self._sketch.estimate(entry.full_key)
        while self._mem_used + entry.size > self.mem_bytes:
            victim_map = self._prob if self._prob else self._prot
            if not victim_map:
                break
            vk = next(iter(victim_map))
            if self._sketch.estimate(vk) > cand_freq:
                # Resident set is hotter: the candidate loses and goes
                # to the disk tier instead.
                demote.append(entry)
                return demote
            victim = victim_map.pop(vk)
            if victim_map is self._prot:
                self._prot_used -= victim.size
            self._mem_used -= victim.size
            self.counters["evict"] += 1
            self._count_evict(MEM, "capacity")
            self._index_discard(victim)
            demote.append(victim)
        if self._mem_used + entry.size > self.mem_bytes:
            demote.append(entry)
            return demote
        self._prob[entry.full_key] = entry
        self._mem_used += entry.size
        self._index_add(entry)
        return demote

    def _prune_epoch_locked(self, nk: tuple) -> None:
        """Drop a key's epoch stamp once nothing references it (no
        entries, no in-flight fill) — epochs must stay bounded under
        write-heavy workloads that never re-read."""
        if not self._by_name.get(nk) and not any(
                f.nk == nk for f in self._fills.values()):
            self._epochs.pop(nk, None)

    def _count_evict(self, tier: str, reason: str) -> None:
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_cache_evictions_total",
                     {"tier": tier, "reason": reason})

    def _index_add(self, entry: _Entry) -> None:
        self._by_name.setdefault(entry.nk, set()).add(entry.full_key)

    def _index_discard(self, entry: _Entry) -> None:
        keys = self._by_name.get(entry.nk)
        if keys is not None:
            keys.discard(entry.full_key)
            if not keys:
                self._by_name.pop(entry.nk, None)
                self._prune_epoch_locked(entry.nk)

    def _demote_to_disk(self, victims: list[_Entry]) -> None:
        """Write demoted memory entries into the disk tier (outside the
        cache lock), honoring drive health for placement."""
        unlink: list[_Entry] = []
        for entry in victims:
            if entry.data is None:
                continue
            d = self._pick_dir(entry.full_key)
            if d is None:
                continue
            h = hashlib.sha256(repr(entry.full_key).encode()).hexdigest()
            sub = os.path.join(d, DISK_SUBDIR, h[:2])
            path = os.path.join(sub, h)
            try:
                os.makedirs(sub, exist_ok=True)
                tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
                with open(tmp, "wb") as f:
                    f.write(entry.data)
                os.replace(tmp, path)
                with open(f"{path}.meta", "w") as f:
                    json.dump({"bucket": entry.nk[0],
                               "key": entry.nk[1],
                               "etag": entry.etag,
                               "size": entry.size}, f)
            except OSError:
                continue   # cache is best-effort
            entry.data = None
            entry.path = path
            entry.dir = d
            with self._mu:
                if entry.full_key in self._disk or entry.dead:
                    unlink.append(entry)
                    continue
                self._disk[entry.full_key] = entry
                self._disk_used += entry.size
                self._index_add(entry)
                while self._disk_used > self.disk_bytes and \
                        len(self._disk) > 1:
                    vk, v = self._disk.popitem(last=False)
                    self._disk_used -= v.size
                    self.counters["evict"] += 1
                    self._count_evict(DISK, "capacity")
                    self._index_discard(v)
                    v.dead = True
                    if v.pins == 0:
                        unlink.append(v)
        for e in unlink:
            self._unlink(e)
        self._publish_gauges()

    def _shrink_to_budget(self) -> None:
        unlink: list[_Entry] = []
        with self._mu:
            while self._mem_used > self.mem_bytes and (
                    self._prob or self._prot):
                m = self._prob if self._prob else self._prot
                _, v = m.popitem(last=False)
                if m is self._prot:
                    self._prot_used -= v.size
                self._mem_used -= v.size
                self._count_evict(MEM, "capacity")
                self._index_discard(v)
            while self._disk_used > self.disk_bytes and self._disk:
                _, v = self._disk.popitem(last=False)
                self._disk_used -= v.size
                self._count_evict(DISK, "capacity")
                self._index_discard(v)
                v.dead = True
                if v.pins == 0:
                    unlink.append(v)
        for e in unlink:
            self._unlink(e)

    def _unpin(self, entry: _Entry) -> None:
        with self._mu:
            entry.pins -= 1
            gone = entry.dead and entry.pins == 0
        if gone:
            self._unlink(entry)

    def _unlink(self, entry: _Entry) -> None:
        for p in (entry.path, f"{entry.path}.meta"):
            if not p or p.endswith("None"):
                continue
            try:
                os.remove(p)
            except OSError:
                pass

    # -- invalidation ---------------------------------------------------

    def invalidate(self, bucket: str, key: str, *, propagate: bool = True,
                   source: str = "local", epoch: int | None = None) -> None:
        """Drop every cached copy of bucket/key (all namespaces, both
        tiers) and poison in-flight fills. ``epoch`` carries a peer's
        version stamp (max-merged); local invalidations bump the local
        stamp. Cheap no-op while nothing is cached."""
        nk = (bucket, key)
        if not self.enabled and not self._by_name and not self._fills:
            return
        unlink: list[_Entry] = []
        notify_epoch = None
        with self._mu:
            touched = False
            for full_key in list(self._by_name.get(nk, ())):
                touched = True
                e = self._prob.pop(full_key, None)
                if e is None:
                    e = self._prot.pop(full_key, None)
                    if e is not None:
                        self._prot_used -= e.size
                if e is not None:
                    self._mem_used -= e.size
                    self._count_evict(MEM, "invalidate")
                e = self._disk.pop(full_key, None)
                if e is not None:
                    self._disk_used -= e.size
                    self._count_evict(DISK, "invalidate")
                    e.dead = True
                    if e.pins == 0:
                        unlink.append(e)
            self._by_name.pop(nk, None)
            fills = [f for f in self._fills.values() if f.nk == nk]
            for f in fills:
                f.invalidated = True
                touched = True
            cur = self._epochs.get(nk, 0)
            new = max(cur + 1, epoch or 0)
            if touched:
                self._epochs[nk] = new
                self._prune_epoch_locked(nk)
                self.counters["invalidate"] += 1
            if propagate and self.enabled and \
                    self.peer_notify is not None:
                notify_epoch = new
        if touched:
            from ..obs.metrics2 import METRICS2
            METRICS2.inc("minio_tpu_v2_cache_invalidations_total",
                         {"source": source})
        for e in unlink:
            self._unlink(e)
        if notify_epoch is not None:
            try:
                self.peer_notify(bucket, key, notify_epoch)
            except Exception:
                pass   # peers degrade to their revalidation backstop
        if touched:
            self._publish_gauges()

    def apply_peer_invalidation(self, bucket: str, key: str,
                                epoch: int) -> None:
        """Server side of the ``cache_invalidate`` peer RPC: apply
        without re-propagating (no invalidation storms)."""
        self.invalidate(bucket, key, propagate=False, source="peer",
                        epoch=int(epoch))

    def invalidate_bucket(self, bucket: str) -> None:
        """Bucket deletion: drop every entry under the bucket."""
        with self._mu:
            names = [nk for nk in self._by_name if nk[0] == bucket]
        for nk in names:
            self.invalidate(nk[0], nk[1], propagate=False,
                            source="bucket")

    # -- placement ------------------------------------------------------

    def _dir_endpoint(self, d: str) -> str | None:
        """Map a disk-tier dir to the drivemon endpoint whose path is
        its longest prefix (operators put cache dirs under the data
        mounts, e.g. ``<drive>/cache``); None = no known drive."""
        if d in self._dir_eps:
            return self._dir_eps[d]
        from ..obs.drivemon import DRIVEMON
        best = None
        for ep in DRIVEMON.endpoints():
            root = os.path.abspath(ep)
            if (d == root or d.startswith(root + os.sep)) and \
                    (best is None or len(root) > len(best)):
                best = root
        self._dir_eps[d] = best
        return best

    def _dir_healthy(self, d: str | None) -> bool:
        """Drivemon-informed placement: never place cache files on —
        or serve them from — suspect / faulty / quarantined drives."""
        if d is None:
            return True
        ep = self._dir_endpoint(d)
        if ep is None:
            return True
        from ..obs.drivemon import DRIVEMON, OK
        return (not DRIVEMON.is_quarantined(ep)
                and DRIVEMON.state_of(ep) == OK)

    def _pick_dir(self, full_key) -> str | None:
        healthy = [d for d in self._dirs if self._dir_healthy(d)]
        if not healthy:
            return None
        h = int.from_bytes(hashlib.sha256(
            repr(full_key).encode()).digest()[:4], "big")
        return healthy[h % len(healthy)]

    # -- misc -----------------------------------------------------------

    @staticmethod
    def _foreground() -> bool:
        from ..qos.scheduler import BACKGROUND, current_lane
        return current_lane() != BACKGROUND

    def _publish_gauges(self) -> None:
        from ..obs.metrics2 import METRICS2
        with self._mu:
            mem_used, disk_used = self._mem_used, self._disk_used
            mem_n = len(self._prob) + len(self._prot)
            disk_n = len(self._disk)
        METRICS2.set_gauge("minio_tpu_v2_cache_bytes",
                           {"tier": MEM}, mem_used)
        METRICS2.set_gauge("minio_tpu_v2_cache_bytes",
                           {"tier": DISK}, disk_used)
        METRICS2.set_gauge("minio_tpu_v2_cache_entries",
                           {"tier": MEM}, mem_n)
        METRICS2.set_gauge("minio_tpu_v2_cache_entries",
                           {"tier": DISK}, disk_n)

    def snapshot(self) -> dict:
        """Admin ``/cache-stats`` document."""
        with self._mu:
            c = dict(self.counters)
            hits = c["hit_mem"] + c["hit_disk"]
            lookups = hits + c["miss"]
            return {
                "enabled": self.enabled,
                "memBytesUsed": self._mem_used,
                "memBytesMax": self.mem_bytes,
                "diskBytesUsed": self._disk_used,
                "diskBytesMax": self.disk_bytes,
                "memEntries": len(self._prob) + len(self._prot),
                "diskEntries": len(self._disk),
                "fillsInFlight": len(self._fills),
                "dirs": list(self._dirs),
                "hitRatio": round(hits / lookups, 4) if lookups else 0.0,
                "counters": c,
            }


# The process-wide serving tier every erasure engine consults.
HOTCACHE = HotObjectCache()
