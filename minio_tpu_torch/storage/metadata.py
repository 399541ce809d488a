"""Object metadata: FileInfo and the on-disk xl.meta format.

The reference stores per-object metadata as msgpack `xl.meta` v2 files
(ref cmd/xl-storage-format-v2.go:34,200: a versions array where each
version holds erasure geometry, per-part sizes, bitrot checksums, and an
optional inline data blob). This rebuild keeps the same information model
but serializes as canonical JSON — debuggable, schema-stable, and not a
copy of the reference's codegen; a binary codec can slot in later behind
the same to_dict/from_dict seam.

FileInfo is the in-memory form handed across StorageAPI
(ref cmd/storage-datatypes.go FileInfo).

The port's own copy of ``minio_tpu/storage/metadata.py``, with no change
in behaviour.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field

XL_META_FORMAT = "xl-tpu/1"
XL_META_FILE = "xl.meta"

ERASURE_ALGORITHM = "rs-vandermonde"  # ref erasureAlgorithm "ReedSolomon"
# Regenerating code (REGEN storage class): repair-by-transfer
# product-matrix MBR (ops/rs_regen.py / erasure/regen/).
REGEN_ALGORITHM = "pm-mbr-rbt"


@dataclass
class ErasureInfo:
    """Erasure geometry + per-part bitrot checksums for one disk's shard
    (ref ErasureInfo, cmd/storage-datatypes.go / xl-storage-format-v2)."""
    algorithm: str = ERASURE_ALGORITHM
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = 0
    index: int = 0                 # 1-based shard index held by this disk
    distribution: list[int] = field(default_factory=list)
    checksums: list[dict] = field(default_factory=list)
    # each: {"part": int, "algorithm": str, "hash": hex str ("" = streaming)}

    def to_dict(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "data": self.data_blocks,
            "parity": self.parity_blocks,
            "blockSize": self.block_size,
            "index": self.index,
            "distribution": list(self.distribution),
            "checksums": list(self.checksums),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ErasureInfo":
        return cls(algorithm=d.get("algorithm", ERASURE_ALGORITHM),
                   data_blocks=d.get("data", 0),
                   parity_blocks=d.get("parity", 0),
                   block_size=d.get("blockSize", 0),
                   index=d.get("index", 0),
                   distribution=list(d.get("distribution", [])),
                   checksums=list(d.get("checksums", [])))

    def shard_size(self) -> int:
        if self.algorithm == REGEN_ALGORITHM:
            # Regen nodes store alpha=d stripe rows of ceil(block/B)
            # bytes each — a different size family from RS's
            # ceil(block/k) (ops/rs_regen.py geometry).
            from ..ops.rs_regen import geometry
            g = geometry(self.data_blocks, self.parity_blocks)
            return g.d * (-(-self.block_size // g.B))
        return -(-self.block_size // self.data_blocks)


@dataclass
class ObjectPartInfo:
    number: int
    size: int           # on-wire (possibly compressed/encrypted) size
    actual_size: int    # original user-data size
    etag: str = ""

    def to_dict(self) -> dict:
        return {"number": self.number, "size": self.size,
                "actualSize": self.actual_size, "etag": self.etag}

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectPartInfo":
        return cls(number=d["number"], size=d["size"],
                   actual_size=d.get("actualSize", d["size"]),
                   etag=d.get("etag", ""))


@dataclass
class FileInfo:
    """Per-disk view of one object version (ref FileInfo,
    cmd/storage-datatypes.go)."""
    volume: str = ""
    name: str = ""
    version_id: str = ""           # "" = null version
    deleted: bool = False          # delete marker
    data_dir: str = ""
    size: int = 0
    mod_time: float = 0.0
    metadata: dict = field(default_factory=dict)
    parts: list[ObjectPartInfo] = field(default_factory=list)
    erasure: ErasureInfo = field(default_factory=ErasureInfo)
    fresh: bool = False            # first write of this object

    def to_version_dict(self) -> dict:
        return {
            "type": "delete-marker" if self.deleted else "object",
            "versionId": self.version_id,
            "dataDir": self.data_dir,
            "size": self.size,
            "modTime": self.mod_time,
            "meta": dict(self.metadata),
            "parts": [p.to_dict() for p in self.parts],
            "erasure": self.erasure.to_dict(),
        }

    @classmethod
    def from_version_dict(cls, volume: str, name: str, d: dict) -> "FileInfo":
        return cls(
            volume=volume, name=name,
            version_id=d.get("versionId", ""),
            deleted=d.get("type") == "delete-marker",
            data_dir=d.get("dataDir", ""),
            size=d.get("size", 0),
            mod_time=d.get("modTime", 0.0),
            metadata=dict(d.get("meta", {})),
            parts=[ObjectPartInfo.from_dict(p) for p in d.get("parts", [])],
            erasure=ErasureInfo.from_dict(d.get("erasure", {})),
        )

    def quorum_key(self) -> tuple:
        """Fields that must agree across disks for metadata quorum
        (ref findFileInfoInQuorum, cmd/erasure-metadata.go — groups by
        mod-time + version + erasure geometry + parts)."""
        return (
            self.version_id, self.deleted, self.data_dir, self.size,
            round(self.mod_time, 6),
            self.erasure.data_blocks, self.erasure.parity_blocks,
            self.erasure.block_size, tuple(self.erasure.distribution),
            tuple((p.number, p.size) for p in self.parts),
        )


def new_version_id() -> str:
    return str(uuid.uuid4())


def new_data_dir() -> str:
    return str(uuid.uuid4())


def now() -> float:
    return time.time()


class XLMeta:
    """The xl.meta versions container (newest first)."""

    def __init__(self, versions: list[dict] | None = None):
        self.versions: list[dict] = versions or []

    @classmethod
    def load(cls, raw: bytes) -> "XLMeta":
        doc = json.loads(raw.decode("utf-8"))
        if doc.get("format") != XL_META_FORMAT:
            raise ValueError(f"bad xl.meta format: {doc.get('format')}")
        return cls(doc.get("versions", []))

    def dump(self) -> bytes:
        return json.dumps({"format": XL_META_FORMAT,
                           "versions": self.versions},
                          sort_keys=True).encode("utf-8")

    def add_version(self, fi: FileInfo) -> None:
        """Insert/replace a version; newest first. A write with the same
        version_id replaces (ref xlMetaV2.AddVersion)."""
        vd = fi.to_version_dict()
        self.versions = [v for v in self.versions
                         if v.get("versionId", "") != fi.version_id]
        self.versions.insert(0, vd)
        self.versions.sort(key=lambda v: v.get("modTime", 0.0), reverse=True)

    def find_version(self, version_id: str) -> dict | None:
        if version_id == "":
            return self.versions[0] if self.versions else None
        for v in self.versions:
            if v.get("versionId", "") == version_id:
                return v
        return None

    def delete_version(self, version_id: str) -> dict | None:
        """Remove a version; returns the removed dict or None."""
        v = self.find_version(version_id)
        if v is not None:
            self.versions.remove(v)
        return v
