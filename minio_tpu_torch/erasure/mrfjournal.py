"""Durable MRF journal — the crash-survival half of the
most-recently-failed heal queue (erasure/heal.py MRFQueue).

The MRF queue is the store's durability debt ledger: every degraded
write (quarantined drive skipped, shard commit failed) queues the
object for background heal. Before this module the ledger was pure
memory — a crash or restart silently discarded every queued repair,
and at SSD-array scale (arXiv:1709.05365) un-replayed repairs are
exactly how one more failure turns into data loss while nobody is
paging. Now every queued repair is also APPENDED to a per-set journal
(``.minio.sys/mrf.log`` on each LOCAL disk of the set) and replayed at
boot (storage/recovery.py drives it via ``MRFQueue.replay_journal``).

Design points:

- **Append-only JSONL**, one ``{"b": bucket, "o": object}`` line per
  entry; torn tails (crash mid-append, no fsync) are tolerated at
  replay — a half-written last line parses as garbage and is skipped.
- **Batched writes**: concurrent ``record()`` calls coalesce — entries
  land on a pending list under the bookkeeping lock, and whichever
  thread wins the writer lock flushes EVERYTHING pending in one append
  per disk, so a failure storm costs one I/O round, not one per entry.
- **Dedup**: an entry already journaled (and not yet healed) is never
  re-appended — a flapping drive requeueing the same object repeatedly
  costs memory-set lookups, not journal growth.
- **Size-capped with drops counted**: past ``MAX_BYTES`` the journal
  first tries to COMPACT (rewrite with only the live entries — stale
  healed lines dominate a long-lived file); if the live set itself
  exceeds the cap, new entries are dropped and
  ``minio_tpu_v2_mrf_journal_drops_total`` counts the lost durability.
- **Truncate-on-empty**: when the last live entry heals, the journal
  compacts to empty — the steady state of a healthy set is an empty
  (or absent) mrf.log.
- **Local disks only**: remote RPC disks belong to another node whose
  own journal covers them; every node journals exactly its local
  ground truth.

Replay unions the per-disk files (any one surviving disk is enough)
and re-queues entries through the normal ``MRFQueue.add`` path, so the
``minio_tpu_v2_mrf_queue_depth`` gauge reflects the replayed backlog
and the watchdog's ``recovery_backlog`` rule can see it shrink — or
not (obs/watchdog.py).

The port's own copy of ``minio_tpu/erasure/mrfjournal.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import threading

from ..storage import errors as serr
from ..storage.xl import MINIO_META_BUCKET

# Journal file, relative to the .minio.sys volume on each local disk.
MRF_LOG_PATH = "mrf.log"


def _line(bucket: str, object_name: str) -> bytes:
    return json.dumps({"b": bucket, "o": object_name},
                      separators=(",", ":")).encode() + b"\n"


def parse_journal(raw: bytes) -> list[tuple[str, str]]:
    """Tolerant JSONL parse: bad lines (torn tail, injected
    corruption) are skipped — a journal is best-effort recovery state,
    never a reason to fail a boot."""
    out: list[tuple[str, str]] = []
    seen: set[tuple[str, str]] = set()
    for ln in raw.splitlines():
        if not ln.strip():
            continue
        try:
            doc = json.loads(ln)
            key = (str(doc["b"]), str(doc["o"]))
        except (ValueError, KeyError, TypeError):
            continue
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


class MRFJournal:
    """Append-only, deduped, size-capped repair journal over a set's
    local disks."""

    MAX_BYTES = 1 << 20  # per-disk cap; compaction before drops

    def __init__(self, disks):
        # Local disks only; a set with no local disks (pure proxy
        # layouts, unit-test fakes) journals nothing and every call
        # is a cheap no-op.
        self.disks = [d for d in disks if hasattr(d, "root")]
        self._mu = threading.Lock()       # bookkeeping
        self._io_mu = threading.Lock()    # serializes file writers
        self._entries: set[tuple[str, str]] = set()
        self._pending: list[tuple[str, str]] = []
        self._bytes = 0  # appended bytes since the last compaction
        # Incremental byte counters: the cap decision must stay O(1)
        # per record — re-serializing the whole backlog per append
        # would make degraded writes O(backlog) exactly during the
        # failure storms that grow it.
        self._live_bytes = 0     # sum of live entries' line lengths
        self._pending_bytes = 0  # lines queued but not yet flushed
        self.drops = 0
        self.appends = 0

    # -- accounting -----------------------------------------------------

    def backlog(self) -> int:
        """Live (journaled-or-pending, not-yet-healed) entry count —
        the durable-queue depth the watchdog's recovery_backlog rule
        watches via the timeline."""
        with self._mu:
            return len(self._entries)

    def _publish(self) -> None:
        from ..obs.metrics2 import METRICS2
        METRICS2.set_gauge("minio_tpu_v2_mrf_journal_backlog", None,
                           self.backlog())

    def stats(self) -> dict:
        with self._mu:
            return {"backlog": len(self._entries),
                    "bytes": self._bytes, "drops": self.drops,
                    "appends": self.appends,
                    "disks": len(self.disks)}

    # -- writes ---------------------------------------------------------

    def record(self, bucket: str, object_name: str) -> bool:
        """Journal one queued repair (MRFQueue.add). Returns False when
        deduped, dropped over the cap, or there is nothing local to
        journal on."""
        if not self.disks:
            return False
        key = (bucket, object_name)
        blob = _line(*key)
        with self._mu:
            if key in self._entries:
                return False  # already durable (or pending) — dedup
            projected = self._bytes + self._pending_bytes + len(blob)
            if projected > self.MAX_BYTES \
                    and self._live_bytes + len(blob) > self.MAX_BYTES:
                # Even a compacted journal couldn't hold it: the cap
                # is a memory/disk bound, not advice. The repair still
                # sits in the in-memory queue; only its crash
                # durability is lost — and counted.
                self.drops += 1
                from ..obs.metrics2 import METRICS2
                METRICS2.inc("minio_tpu_v2_mrf_journal_drops_total")
                return False
            need_compact = projected > self.MAX_BYTES
            self._entries.add(key)
            self._live_bytes += len(blob)
            self._pending.append(key)
            self._pending_bytes += len(blob)
        if need_compact:
            self._compact()
        else:
            self._flush()
        self._publish()
        return True

    def complete(self, bucket: str, object_name: str) -> None:
        """A journaled repair converged: retire the entry. The line
        stays in the file (append-only) until the journal empties or
        compacts — replaying a stale healed entry is a cheap no-op
        heal, losing a live one is silent durability debt."""
        key = (bucket, object_name)
        with self._mu:
            if key not in self._entries:
                return
            self._entries.discard(key)
            self._live_bytes = max(0,
                                   self._live_bytes - len(_line(*key)))
            empty = not self._entries and (self._bytes or self._pending)
        if empty:
            self._compact()  # truncate: healthy sets carry no journal
        self._publish()

    def _flush(self) -> None:
        """Append everything pending in one write per disk. The writer
        lock serializes file access; bookkeeping stays on _mu so
        recorders never wait on disk I/O they didn't cause."""
        with self._io_mu:
            with self._mu:
                batch, self._pending = self._pending, []
                self._pending_bytes = 0
            if not batch:
                return
            blob = b"".join(_line(*k) for k in batch)
            for disk in self.disks:
                try:
                    disk.append_file(MINIO_META_BUCKET, MRF_LOG_PATH,
                                     blob)
                except Exception:
                    continue  # best-effort per disk; replay unions
            with self._mu:
                self._bytes += len(blob)
                self.appends += 1

    def _compact(self) -> None:
        """Rewrite the journal with only the LIVE entries (atomic
        write_all). Entries recorded after the snapshot stay pending
        and append after — compaction can lose a healed line, never a
        live one."""
        with self._io_mu:
            with self._mu:
                snapshot = sorted(self._entries)
                # Pending entries are covered by the snapshot (record
                # adds to _entries first), so they need no re-append.
                self._pending = [k for k in self._pending
                                 if k not in self._entries]
                self._pending_bytes = sum(len(_line(*k))
                                          for k in self._pending)
            blob = b"".join(_line(*k) for k in snapshot)
            for disk in self.disks:
                try:
                    if blob:
                        disk.write_all(MINIO_META_BUCKET, MRF_LOG_PATH,
                                       blob)
                    else:
                        try:
                            disk.delete(MINIO_META_BUCKET, MRF_LOG_PATH)
                        except serr.FileNotFound:
                            pass
                except Exception:
                    continue
            with self._mu:
                self._bytes = len(blob)

    # -- replay ---------------------------------------------------------

    def replay(self) -> list[tuple[str, str]]:
        """Union the per-disk journal files (boot). Populates the
        dedup set so the subsequent MRFQueue.add round does not
        re-append what is already durable."""
        found: dict[tuple[str, str], None] = {}
        max_bytes = 0
        for disk in self.disks:
            try:
                raw = disk.read_all(MINIO_META_BUCKET, MRF_LOG_PATH)
            except Exception:
                continue  # absent / unreadable disk: replay unions
            max_bytes = max(max_bytes, len(raw))
            for key in parse_journal(raw):
                found.setdefault(key)
        entries = list(found)
        with self._mu:
            fresh = [k for k in entries if k not in self._entries]
            self._entries.update(fresh)
            self._live_bytes += sum(len(_line(*k)) for k in fresh)
            self._bytes = max(self._bytes, max_bytes)
        if entries:
            self._publish()
        return entries
