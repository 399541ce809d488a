"""Data update tracker: per-bucket change counters + a cycling bloom
filter of changed object paths (ref dataUpdateTracker,
cmd/data-update-tracker.go:64; bloom import :39).

Consumers:
- the metacache listing engine invalidates cached listings when a
  bucket's counter moved (read-after-write on the serving node);
- the data crawler skips buckets whose counter is unchanged since its
  last cycle, except on periodic full sweeps (ref bloom-filter skip of
  unchanged subtrees + `dataUpdateTrackerResetEvery` full cycles).

The port's own copy of ``minio_tpu/scanner/tracker.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import threading


class BloomFilter:
    """Fixed-size double-hashing bloom filter over path strings."""

    def __init__(self, bits: int = 1 << 16, hashes: int = 4,
                 data: bytearray | None = None):
        self.nbits = bits
        self.hashes = hashes
        self.bits = data if data is not None else bytearray(bits // 8)

    def _idx(self, key: str):
        h = hashlib.sha256(key.encode()).digest()
        a = int.from_bytes(h[:8], "little")
        b = int.from_bytes(h[8:16], "little") | 1
        for i in range(self.hashes):
            yield (a + i * b) % self.nbits

    def add(self, key: str) -> None:
        for i in self._idx(key):
            self.bits[i >> 3] |= 1 << (i & 7)

    def __contains__(self, key: str) -> bool:
        return all(self.bits[i >> 3] & (1 << (i & 7))
                   for i in self._idx(key))

    def merge(self, other: "BloomFilter") -> None:
        for i, b in enumerate(other.bits):
            self.bits[i] |= b

    def to_wire(self) -> dict:
        return {"bits": self.bits.hex(), "nbits": self.nbits,
                "hashes": self.hashes}

    @classmethod
    def from_wire(cls, d: dict) -> "BloomFilter":
        return cls(d["nbits"], d["hashes"], bytearray.fromhex(d["bits"]))


class DataUpdateTracker:
    """In-process registry of object mutations since process start."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: dict[str, int] = {}
        self._cycle = 0
        self._current = BloomFilter()
        self._history: list[BloomFilter] = []  # newest first, capped

    def mark(self, bucket: str, path: str = "") -> None:
        """Record a mutation of bucket[/path]. Every path prefix is
        marked too so consumers can ask "did anything change under this
        prefix?" (ref dataUpdateTracker marking parent dirs)."""
        with self._mu:
            self._counters[bucket] = self._counters.get(bucket, 0) + 1
            self._current.add(bucket)
            if path:
                parts = path.split("/")
                for i in range(1, len(parts) + 1):
                    self._current.add(f"{bucket}/" + "/".join(parts[:i]))

    def bucket_counter(self, bucket: str) -> int:
        with self._mu:
            return self._counters.get(bucket, 0)

    @property
    def cycle(self) -> int:
        return self._cycle

    def advance_cycle(self) -> BloomFilter:
        """End the crawler cycle: returns the filter of paths changed
        during it and starts a fresh one (ref CycleBloom,
        cmd/peer-rest-common.go:53)."""
        with self._mu:
            done = self._current
            self._history.insert(0, done)
            del self._history[8:]
            self._current = BloomFilter()
            self._cycle += 1
            return done

    def changed_since(self, cycles_back: int, key: str) -> bool:
        """Conservative: True if `key` may have changed within the last
        `cycles_back` crawler cycles (or ever marked this cycle). Asking
        further back than retained history answers True — absence of
        evidence is not evidence of absence."""
        with self._mu:
            if key in self._current:
                return True
            if cycles_back > len(self._history):
                return True
            return any(key in f
                       for f in self._history[:max(0, cycles_back)])

    def changed_under(self, bucket: str, prefix_root: str,
                      cycles_back: int = 2) -> bool:
        """Conservative prefix query: True if anything may have changed
        under bucket/prefix_root recently (bloom false positives just
        cost a rescan). Empty root asks about the whole bucket."""
        key = f"{bucket}/{prefix_root}" if prefix_root else bucket
        return self.changed_since(cycles_back, key)

    def to_wire(self) -> dict:
        with self._mu:
            return {"cycle": self._cycle,
                    "counters": dict(self._counters),
                    "current": self._current.to_wire()}

    def save(self, store, path: str = "tracker/state.json") -> None:
        """Persist advisory state (the crawler calls this at cycle end;
        ref dataUpdateTracker saved per disk)."""
        try:
            store.save(path, self.to_wire())
        except Exception:
            pass  # advisory state

    @classmethod
    def load(cls, store, path: str = "tracker/state.json",
             ) -> "DataUpdateTracker":
        t = cls()
        try:
            d = store.load(path)
        except Exception:
            d = None
        if d:
            t._cycle = d.get("cycle", 0)
            t._counters = dict(d.get("counters", {}))
            if "current" in d:
                t._current = BloomFilter.from_wire(d["current"])
        return t
