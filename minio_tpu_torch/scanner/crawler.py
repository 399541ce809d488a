"""The data crawler: a perpetual low-priority sweep over all buckets.

Per cycle it (ref cmd/data-crawler.go runDataCrawler/crawlDataFolder):
  1. walks every object version, building the data-usage tree
     (object/version counts, logical size, size histogram — ref
     cmd/data-usage-cache.go), persisted through the quorum config
     store so restarts resume with the last cycle's numbers;
  2. applies bucket LIFECYCLE rules, expiring versions in place
     (ref lifecycle application inside crawlDataFolder);
  3. samples objects for HEAL verification (1 in `heal_sample`,
     ref dataCrawlHealSample cmd/data-crawler.go:49-51) and queues
     repairs through the engine's healer.

The crawler is cooperative: `crawl_once()` is synchronous (tests,
admin-triggered sweeps); `start()` runs cycles on a timer thread.

The port's own copy of ``minio_tpu/scanner/crawler.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
import time

from ..bucket.lifecycle import (DELETE, DELETE_MARKER, DELETE_VERSION,
                                TRANSITION,
                                Lifecycle, parse_tags)
from ..erasure.engine import MethodNotAllowed, ObjectNotFound

USAGE_PATH = "data-usage/usage.json"

# Size histogram buckets (ref cmd/data-usage-cache.go sizeHistogram).
_HISTOGRAM = (
    ("LESS_THAN_1024_B", 0, 1024),
    ("BETWEEN_1024_B_AND_1_MB", 1024, 1024 * 1024),
    ("BETWEEN_1_MB_AND_10_MB", 1024 * 1024, 10 * 1024 * 1024),
    ("BETWEEN_10_MB_AND_64_MB", 10 * 1024 * 1024, 64 * 1024 * 1024),
    ("BETWEEN_64_MB_AND_128_MB", 64 * 1024 * 1024, 128 * 1024 * 1024),
    ("GREATER_THAN_128_MB", 128 * 1024 * 1024, float("inf")),
)


def _bucket_for_size(size: int) -> str:
    for name, lo, hi in _HISTOGRAM:
        if lo <= size < hi:
            return name
    return _HISTOGRAM[-1][0]


class DataCrawler:
    def __init__(self, layer, bucket_meta, store=None, notifier=None,
                 interval: float = 60.0, heal_sample: int = 512,
                 tiers=None):
        """layer: ObjectLayer; bucket_meta: BucketMetadataSys; store:
        ConfigStore for persistence (defaults to bucket_meta's);
        heal_sample: sample 1-in-N objects for deep verification;
        tiers: TierManager enabling ILM transition."""
        self.layer = layer
        self.bucket_meta = bucket_meta
        self.store = store if store is not None else bucket_meta.store
        self.notifier = notifier
        self.tiers = tiers
        self.interval = interval
        self.heal_sample = max(1, heal_sample)
        self._counter = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._mu = threading.Lock()
        self.last_usage: dict = self._load_usage()
        self.cycles = 0
        self.healed: list[tuple[str, str]] = []
        # Change-tracking skip state (ref dataUpdateTracker bloom skip
        # of unchanged subtrees; full sweep every N cycles).
        self._last_counters: dict[str, int] = {}
        self.full_cycle_every = 16
        self.skipped_buckets = 0

    def _engines(self):
        layer = self.layer
        if hasattr(layer, "pools"):
            return [s for p in layer.pools for s in p.sets]
        if hasattr(layer, "sets"):
            return list(layer.sets)
        return [layer]

    def _bucket_counter(self, bucket: str) -> int | None:
        """Sum of change counters across engines; None when NO engine
        has a tracker (FS backend) — callers must then never skip."""
        total = None
        for eng in self._engines():
            t = getattr(eng, "update_tracker", None)
            if t is not None:
                total = (total or 0) + t.bucket_counter(bucket)
        return total

    # -- persistence ----------------------------------------------------

    def _load_usage(self) -> dict:
        try:
            return self.store.load(USAGE_PATH) or {}
        except Exception:
            return {}

    def _save_usage(self, usage: dict) -> None:
        try:
            self.store.save(USAGE_PATH, usage)
        except Exception:
            pass  # usage is advisory; never fail the sweep over it

    # -- one cycle ------------------------------------------------------

    def crawl_once(self, now: float | None = None) -> dict:
        # The whole cycle (usage walk, lifecycle rewrites, sampled heal
        # verification) is background work: its kernel dispatches yield
        # to foreground traffic via the QoS lanes (qos/scheduler.py).
        from ..qos.scheduler import background_lane
        with background_lane():
            return self._crawl_once_bg(time.time() if now is None
                                       else now)

    def _crawl_once_bg(self, now: float) -> dict:
        usage: dict = {"lastUpdate": now, "buckets": {}}
        full_sweep = (self.cycles % self.full_cycle_every == 0)
        for b in self.layer.list_buckets():
            bucket = b["name"]
            meta = self.bucket_meta.get(bucket)
            lc = Lifecycle.parse(meta.lifecycle_xml)
            versioned = meta.versioning_enabled()
            # Unchanged since last cycle + no time-driven lifecycle
            # rules -> keep previous usage, skip the walk (ref bloom
            # skip; lifecycle actions are time-based so those buckets
            # always rescan, as does every Nth full sweep).
            counter = self._bucket_counter(bucket)
            prev = self.last_usage.get("buckets", {}).get(bucket)
            if (not full_sweep and not lc and prev is not None
                    and counter is not None
                    and self._last_counters.get(bucket) == counter):
                usage["buckets"][bucket] = prev
                self.skipped_buckets += 1
                continue
            self._last_counters[bucket] = counter
            bu = {"objects": 0, "versions": 0, "size": 0,
                  "histogram": {}}
            versions = None
            try:
                versions = self.layer.list_object_versions(
                    bucket, max_keys=1_000_000)
            except MethodNotAllowed:
                pass  # FS backend has no version index
            except Exception:
                continue
            if versions is None:
                try:
                    versions = self.layer.list_objects(
                        bucket, max_keys=1_000_000)
                except Exception:
                    continue
            # Group per key, newest first (list order guarantees this).
            per_key: dict[str, list] = {}
            for v in versions:
                per_key.setdefault(v.name, []).append(v)
            for key, vers in per_key.items():
                self._apply_lifecycle(bucket, key, vers, lc, versioned,
                                      now)
            # Re-list only if lifecycle removed something? Cheap approach:
            # account on the surviving view.
            survivors = [v for vs in per_key.values() for v in vs
                         if not getattr(v, "_expired", False)]
            latest_seen: set[str] = set()
            for v in survivors:
                if v.delete_marker:
                    continue
                bu["versions"] += 1
                bu["size"] += v.size
                if v.name not in latest_seen:
                    latest_seen.add(v.name)
                    bu["objects"] += 1
                    h = _bucket_for_size(v.size)
                    bu["histogram"][h] = bu["histogram"].get(h, 0) + 1
                self._maybe_heal(bucket, v)
            usage["buckets"][bucket] = bu
        with self._mu:
            self.last_usage = usage
            self.cycles += 1
        self._save_usage(usage)
        # Cycle the per-engine change blooms + persist advisory tracker
        # state (ref CycleBloom fan-out; tracker saved per disk).
        for i, eng in enumerate(self._engines()):
            t = getattr(eng, "update_tracker", None)
            if t is not None:
                t.advance_cycle()
                t.save(self.store, f"tracker/state-{i}.json")
        return usage

    def _apply_lifecycle(self, bucket: str, key: str, vers: list,
                         lc: Lifecycle, versioned: bool,
                         now: float) -> None:
        if not lc:
            return
        # vers: newest first. A noncurrent version's age runs from when
        # it was REPLACED = its successor's mod_time.
        for i, v in enumerate(vers):
            is_latest = i == 0
            noncurrent_since = vers[i - 1].mod_time if i > 0 else v.mod_time
            tags = parse_tags(v.metadata.get("x-amz-tagging", ""))
            action, tier = lc.compute_with_tier(
                key, noncurrent_since if not is_latest else v.mod_time,
                is_latest=is_latest, delete_marker=v.delete_marker,
                tags=tags, sole_version=len(vers) == 1, now=now)
            try:
                from ..bucket import tiering as tier_mod
                if (self.tiers is not None and is_latest
                        and tier_mod.restub_if_restore_expired(
                            self.layer, bucket, key, v.metadata, now)):
                    pass  # expired restore collapsed back to a stub
                if action == TRANSITION:
                    if self.tiers is not None and is_latest:
                        tier_mod.transition_object(
                            self.layer, self.tiers, bucket, key, tier,
                            versioned=versioned)
                elif action == DELETE:
                    # Expire the current version: versioned buckets get
                    # a delete marker, unversioned delete outright — the
                    # outright delete destroys data, so WORM applies
                    # (ref enforceRetentionForDeletion gate on crawler
                    # expiry, cmd/data-crawler.go:924).
                    if not versioned and self._worm_protected(v, now):
                        continue
                    out = self.layer.delete_object(bucket, key,
                                                   versioned=versioned)
                    v._expired = not versioned
                    self._notify_removed(bucket, key, out)
                    if (not versioned and self.tiers is not None
                            and tier_mod.is_transitioned(v.metadata)):
                        self.tiers.delete_remote(v.metadata)
                elif action in (DELETE_VERSION, DELETE_MARKER):
                    # Version deletes always destroy data: skip any
                    # legal-hold/retention-protected version (markers
                    # carry no retention metadata and pass).
                    if self._worm_protected(v, now):
                        continue
                    out = self.layer.delete_object(bucket, key,
                                                   v.version_id or "")
                    v._expired = True
                    self._notify_removed(bucket, key, out)
                    if (self.tiers is not None
                            and tier_mod.is_transitioned(v.metadata)):
                        self.tiers.delete_remote(v.metadata)
            except ObjectNotFound:
                pass
            except Exception:
                continue

    @staticmethod
    def _worm_protected(v, now: float) -> bool:
        """True when deleting this version is forbidden by legal hold
        or active retention (ref enforceRetentionForDeletion,
        cmd/data-crawler.go:924). The crawler never bypasses
        GOVERNANCE. `now` is the same clock the lifecycle decision
        used, so expiry and WORM agree on what time it is."""
        from ..bucket import objectlock as ol
        try:
            ol.check_version_delete(v.metadata, bypass_governance=False,
                                    now=now)
        except ol.ObjectLockError:
            return True
        except Exception:
            return True  # unparseable lock metadata: fail safe, keep it
        return False

    def _notify_removed(self, bucket: str, key: str, deleted) -> None:
        """ILM expiry fires the same removal events an S3 DELETE would
        (ref sendEvent from applyLifecycle, cmd/data-crawler.go)."""
        if self.notifier is None:
            return
        from ..event import event as ev
        self.notifier.send(ev.Event(
            event_name=(ev.OBJECT_REMOVED_DELETE_MARKER
                        if deleted.delete_marker
                        else ev.OBJECT_REMOVED_DELETE),
            bucket=bucket, key=key,
            version_id=deleted.version_id))

    def _maybe_heal(self, bucket: str, v) -> None:
        """1-in-N sampled verification (ref data-crawler heal sampling,
        cmd/data-crawler.go:49-51 + healObject enqueue)."""
        self._counter += 1
        if self._counter % self.heal_sample:
            return
        # Sampled deep verify is the crawl's expensive step: pace it
        # against foreground traffic (ref waitForLowHTTPReq).
        from ..qos.scheduler import GATE
        GATE.throttle_background()
        healer = getattr(self.layer, "healer", None)
        if healer is None:
            return
        try:
            # Sweep-friendly helper: a lock-contended sample requeues
            # via MRF instead of being silently dropped until the next
            # random 1-in-N hit.
            heal = getattr(healer, "heal_object_or_queue",
                           healer.heal_object)
            heal(bucket, v.name)
            self.healed.append((bucket, v.name))
        except Exception:
            pass

    # -- background loop ------------------------------------------------

    def start(self) -> None:
        if self._thread:
            return
        # mtpu-lint: disable=R1 -- boot-time crawler daemon; tags its own bg lane per sweep step
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="data-crawler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.crawl_once()
            except Exception:
                pass  # the sweep must survive any single-cycle error

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def data_usage(self) -> dict:
        with self._mu:
            return dict(self.last_usage)

    def bucket_sizes(self) -> dict[str, int]:
        """{bucket: logical at-rest bytes} from the last cycle — the
        stored-bytes half of admin /top's live-traffic + footprint
        join (obs/usage.py owns the live half)."""
        with self._mu:
            buckets = (self.last_usage or {}).get("buckets", {})
            return {name: int(v.get("size", 0) or 0)
                    for name, v in buckets.items()
                    if isinstance(v, dict)}
