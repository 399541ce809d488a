"""StorageAPI — the per-disk contract (ref cmd/storage-interface.go:25-82).

Every method has a local implementation (xl.XLStorage) and, in distributed
mode, a remote one (rpc.RemoteStorage) with identical semantics. This seam
is also the fault-injection point for tests (the reference's naughtyDisk
pattern, ref cmd/naughty-disk_test.go).

All data-plane payloads are bytes; erasure/bitrot logic lives above this
layer. Errors are storage.errors types.

The port's own copy of ``minio_tpu/storage/interface.py``, with no change
in behaviour.
"""

from __future__ import annotations

import abc
import re

from .metadata import FileInfo

# Version data dirs are uuid4 names (metadata.new_data_dir); the walk
# must not descend into them as if they were key prefixes.
DATA_DIR_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-"
    r"[0-9a-f]{4}-[0-9a-f]{12}$")


class StorageAPI(abc.ABC):
    """30-method per-disk contract, grown as layers land."""

    # --- identity / health ---

    @abc.abstractmethod
    def disk_info(self) -> dict:
        """Totals/frees/id (ref DiskInfo)."""

    def is_online(self) -> bool:
        return True

    def endpoint(self) -> str:
        return "local"

    def close(self) -> None:
        pass

    # --- volumes (buckets) ---

    @abc.abstractmethod
    def make_volume(self, volume: str) -> None: ...

    @abc.abstractmethod
    def list_volumes(self) -> list[str]: ...

    @abc.abstractmethod
    def stat_volume(self, volume: str) -> dict: ...

    @abc.abstractmethod
    def delete_volume(self, volume: str, force: bool = False) -> None: ...

    # --- flat files (config, tmp shards) ---

    @abc.abstractmethod
    def write_all(self, volume: str, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def read_all(self, volume: str, path: str) -> bytes: ...

    @abc.abstractmethod
    def read_file(self, volume: str, path: str, offset: int,
                  length: int) -> bytes:
        """Ranged read (ref ReadFileStream)."""

    def repair_project(self, volume: str, path: str,
                       ranges: list[tuple[int, int]]) -> bytes:
        """Minimum-bandwidth repair read (REGEN storage class): the
        concatenated bytes of [offset, offset+length) slices — one
        stored stripe row per block of a heal group
        (erasure/regen/repair.py computes the offsets).  The default
        composes ranged reads, so every local disk and test stub
        supports it; rpc.RemoteStorage overrides it with a SINGLE RPC
        so only the small projection crosses the wire — the whole
        point of the regenerating code."""
        return b"".join(self.read_file(volume, path, off, length)
                        for off, length in ranges)

    @abc.abstractmethod
    def create_file(self, volume: str, path: str, data) -> None:
        """Write a (shard) file, creating parents (ref CreateFile,
        cmd/xl-storage.go:1575 — a STREAMING write there). `data` is
        bytes or an iterable of byte chunks; iterable input must be
        written incrementally, never buffered whole."""

    @abc.abstractmethod
    def append_file(self, volume: str, path: str, data: bytes) -> None:
        """Append a chunk to a (staging) file, creating it and parents
        on first append (ref AppendFile, cmd/xl-storage.go). The
        engine's block pipeline writes one erasure batch per call."""

    @abc.abstractmethod
    def delete(self, volume: str, path: str, recursive: bool = False,
               ) -> None: ...

    @abc.abstractmethod
    def rename_file(self, src_volume: str, src_path: str, dst_volume: str,
                    dst_path: str) -> None: ...

    @abc.abstractmethod
    def list_dir(self, volume: str, path: str) -> list[str]:
        """Entries of a directory; dirs have a trailing '/'."""

    def walk_dir_iter(self, volume: str, prefix: str = "",
                      after: str = ""):
        """Ordered, RESUMABLE per-disk walk of a bucket — yields
        {"name": ..., "versions": [version-dict, ...]} entries in
        full-key BYTE order, one at a time, never materializing the
        listing (ref StorageAPI.WalkDir, cmd/metacache-walk.go — the
        per-disk feeder of the metacache listing engine; there the
        stream rides one chunked HTTP response, here it feeds the paged
        storage RPC in rpc/storage.py). Entries carry the full xl.meta
        versions array so the merger can resolve quorum without extra
        round trips.

        Ordering: a MIN-HEAP of pending directories, popped in path
        order. An object's key equals its directory's path, a
        directory's subtree only emits keys >= its path, and heap pops
        are monotonic — so emission is exact byte order even where
        depth-first sibling order disagrees with it ("a" < "a-b" <
        "a/b" although sibling dirs sort "a-b/" < "a/"). Memory is
        O(frontier), not O(listing). (The reference's walk emits
        subtree-contiguous order instead; OUR listing contract — the
        k-way merge, markers, golden listings — is byte order, so the
        walk must produce it.)

        `after` (exclusive) resumes a previous walk: directories whose
        whole subtree sorts <= after are pruned without descending, so
        a resumed page costs O(depth + page), not O(listing).
        """
        import heapq

        from . import errors as _serr

        heap: list[str] = [""]
        while heap:
            path = heapq.heappop(heap)
            try:
                entries = self.list_dir(volume, path)
            except _serr.StorageError:
                continue
            is_obj = "xl.meta" in entries
            if is_obj and path and (not prefix
                                    or path.startswith(prefix)) \
                    and path > after:
                try:
                    vers = [fi.to_version_dict()
                            for fi in self.read_versions(volume, path)]
                    yield {"name": path, "versions": vers}
                except _serr.StorageError:
                    pass
            for e in entries:
                if not e.endswith("/"):
                    continue
                name = e[:-1]
                if is_obj and DATA_DIR_RE.match(name):
                    continue  # version data dir, not a key prefix
                sub = f"{path}/{name}" if path else name
                # Prefix pruning: descend only when sub can still hold
                # matches (sub itself matches, or prefix lies below sub).
                if prefix and not (sub.startswith(prefix)
                                   or prefix.startswith(sub + "/")):
                    continue
                # Resume pruning: every key in the subtree is either
                # `sub` itself or starts with `sub + "/"`; skip unless
                # some of those can sort after `after`.
                if after and not (after < sub + "/"
                                  or after.startswith(sub + "/")):
                    continue
                heapq.heappush(heap, sub)

    def walk_dir(self, volume: str, prefix: str = "") -> list[dict]:
        """Materialized walk_dir_iter (compat surface for callers that
        want the whole listing; the sort is a no-op safety net — the
        iterator already emits byte order)."""
        return sorted(self.walk_dir_iter(volume, prefix),
                      key=lambda d: d["name"])

    # --- object versions (xl.meta) ---

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Atomic object commit: move tmp data dir + merge version into
        dst xl.meta (ref RenameData, cmd/xl-storage.go:1972)."""

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        """Merge one version into xl.meta (ref WriteMetadata)."""

    @abc.abstractmethod
    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo:
        """Read one version's FileInfo ("" = latest)
        (ref ReadVersion)."""

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        """Remove a version; drops data dir when last reference goes
        (ref DeleteVersion)."""

    @abc.abstractmethod
    def read_versions(self, volume: str, path: str) -> list[FileInfo]:
        """All versions of one object, newest first (ref ReadVersion on
        the full xlMetaV2 versions array, cmd/xl-storage-format-v2.go)."""

    @abc.abstractmethod
    def read_parts(self, volume: str, path: str, data_dir: str,
                   ) -> list[str]:
        """List part files of a version's data dir (ref CheckParts)."""

    @abc.abstractmethod
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep bitrot scan of this disk's shard for fi; raises
        FileCorrupt on mismatch (ref VerifyFile, cmd/xl-storage.go:2380)."""
