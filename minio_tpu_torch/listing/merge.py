"""K-way merge + per-entry quorum resolve of per-disk walk streams
(ref cmd/metacache-entries.go: metaCacheEntries.resolve, and the sorted
merge in listPathRaw, cmd/metacache-set.go).

The port's own copy of ``minio_tpu/listing/merge.py``, with no change in
behaviour.
"""

from __future__ import annotations

import heapq


def merge_resolve(disk_entries: list[list[dict] | None],
                  quorum: int) -> list[dict]:
    """Merge sorted per-disk entry streams into one sorted stream.

    Each input is one disk's `walk_dir` output (or None for an offline
    disk). A version of an object survives when at least `quorum` disks
    agree on it (same version-id + mod-time — the FileInfo quorum key of
    the metadata path); an object survives when at least one of its
    versions does. Versions are returned newest-first per object.
    """
    streams = [s for s in disk_entries
               if s is not None and not isinstance(s, BaseException)]
    if not streams:
        return []

    heap: list[tuple[str, int, int]] = []  # (name, stream_idx, pos)
    for si, s in enumerate(streams):
        if s:
            heapq.heappush(heap, (s[0]["name"], si, 0))

    out: list[dict] = []
    while heap:
        name = heap[0][0]
        per_disk: list[list[dict]] = []
        while heap and heap[0][0] == name:
            _, si, pos = heapq.heappop(heap)
            per_disk.append(streams[si][pos]["versions"])
            if pos + 1 < len(streams[si]):
                heapq.heappush(
                    heap, (streams[si][pos + 1]["name"], si, pos + 1))
        resolved = _resolve_versions(per_disk, quorum)
        if resolved:
            out.append({"name": name, "versions": resolved})
    return out


def _vkey(v: dict) -> tuple:
    """Mirror of FileInfo.quorum_key (storage/metadata.py): version id,
    kind, data dir, size, mod time, erasure geometry and part layout
    must ALL agree for two disks' views to pool into one quorum vote —
    divergent racing null-version writes must not merge."""
    er = v.get("erasure", {}) or {}
    return (v.get("versionId", ""),
            v.get("type") == "delete-marker",
            v.get("dataDir", ""),
            v.get("size", 0),
            round(v.get("modTime", 0.0), 6),
            er.get("data", 0), er.get("parity", 0),
            er.get("blockSize", 0), tuple(er.get("distribution", []) or []),
            tuple((p.get("number", 0), p.get("size", 0))
                  for p in v.get("parts", []) or []))


def _resolve_versions(per_disk: list[list[dict]], quorum: int,
                      ) -> list[dict]:
    counts: dict[tuple, int] = {}
    best: dict[tuple, dict] = {}
    for versions in per_disk:
        for v in versions:
            key = _vkey(v)
            counts[key] = counts.get(key, 0) + 1
            best[key] = v
    alive = [v for key, v in best.items() if counts[key] >= quorum]
    alive.sort(key=lambda v: (-v.get("modTime", 0.0),
                              v.get("versionId", "")))
    return alive
