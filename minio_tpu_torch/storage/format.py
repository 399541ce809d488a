"""format.json — per-disk identity and cluster topology
(ref cmd/format-erasure.go:109 formatErasureV3: deployment id, per-disk
uuid `this`, `sets` matrix of drive uuids, distribution algorithm).

On first boot the coordinator writes a fresh format to every disk; on
restart formats are quorum-loaded, disks are matched to their set/slot by
uuid (surviving physical reordering), and blank replacement disks are
detected for healing (ref waitForFormatErasure, cmd/prepare-storage.go).

The port's own copy of ``minio_tpu/storage/format.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import uuid as uuidlib
from dataclasses import dataclass, field

from . import errors as serr
from .interface import StorageAPI
from .xl import MINIO_META_BUCKET

FORMAT_FILE = "format.json"
FORMAT_VERSION = "1"
FORMAT_BACKEND = "xl-tpu"
DISTRIBUTION_ALGO = "SIPMOD+PARITY"  # ref formatErasureVersionV3DistributionAlgoV3


@dataclass
class FormatErasure:
    """One disk's view of the topology."""
    deployment_id: str
    this: str                     # this disk's uuid
    sets: list[list[str]] = field(default_factory=list)
    distribution_algo: str = DISTRIBUTION_ALGO

    def to_bytes(self) -> bytes:
        return json.dumps({
            "version": FORMAT_VERSION,
            "format": FORMAT_BACKEND,
            "id": self.deployment_id,
            "xl": {
                "version": "3",
                "this": self.this,
                "sets": self.sets,
                "distributionAlgo": self.distribution_algo,
            },
        }, sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "FormatErasure":
        doc = json.loads(raw)
        if doc.get("format") != FORMAT_BACKEND:
            raise serr.FileCorrupt(f"bad format: {doc.get('format')}")
        xl = doc["xl"]
        return cls(deployment_id=doc["id"], this=xl["this"],
                   sets=xl["sets"],
                   distribution_algo=xl.get("distributionAlgo",
                                            DISTRIBUTION_ALGO))

    def find(self, disk_uuid: str) -> tuple[int, int] | None:
        for si, s in enumerate(self.sets):
            for di, u in enumerate(s):
                if u == disk_uuid:
                    return si, di
        return None


def pick_set_layout(n_disks: int, set_size: int | None = None,
                    ) -> tuple[int, int]:
    """(num_sets, set_size) for n disks. The reference requires equal set
    sizes 4..16 chosen by GCD (ref getSetIndexes,
    cmd/endpoint-ellipses.go:132); small dev topologies (2..3 drives)
    form a single set."""
    if set_size is not None:
        if n_disks % set_size:
            raise ValueError(f"{n_disks} disks not divisible into "
                             f"sets of {set_size}")
        return n_disks // set_size, set_size
    if n_disks < 4:
        if n_disks < 2:
            raise ValueError("need at least 2 disks")
        return 1, n_disks
    for size in range(16, 3, -1):
        if n_disks % size == 0:
            return n_disks // size, size
    raise ValueError(
        f"cannot divide {n_disks} disks into equal sets of 4..16")


def load_format(disk: StorageAPI) -> FormatErasure | None:
    try:
        return FormatErasure.from_bytes(
            disk.read_all(MINIO_META_BUCKET, FORMAT_FILE))
    except serr.FileNotFound:
        return None
    except serr.StorageError:
        return None


def save_format(disk: StorageAPI, fmt: FormatErasure) -> None:
    disk.write_all(MINIO_META_BUCKET, FORMAT_FILE, fmt.to_bytes())


def init_or_load_formats(disks: list[StorageAPI],
                         set_size: int | None = None,
                         ) -> tuple[FormatErasure, list[StorageAPI],
                                    list[int]]:
    """Bootstrap the topology across a pool's disks.

    Returns (reference format, disks reordered to format slots,
    fresh_disk_indices needing heal). First boot: generate uuids and
    write formats everywhere. Restart: quorum-load, reorder disks by
    their format uuid, re-stamp blank replacements (fresh disks).
    """
    n = len(disks)
    n_sets, set_size_ = pick_set_layout(n, set_size)
    formats = [load_format(d) for d in disks]
    have = [f for f in formats if f is not None]

    if not have:
        # First boot: mint the topology.
        dep = str(uuidlib.uuid4())
        sets = [[str(uuidlib.uuid4()) for _ in range(set_size_)]
                for _ in range(n_sets)]
        flat = [u for s in sets for u in s]
        for disk, u in zip(disks, flat):
            save_format(disk, FormatErasure(dep, u, sets))
        return FormatErasure(dep, "", sets), list(disks), []

    # Quorum reference format: majority by (deployment, sets) shape.
    groups: dict[str, list[FormatErasure]] = {}
    for f in have:
        key = json.dumps([f.deployment_id, f.sets], sort_keys=True)
        groups.setdefault(key, []).append(f)
    ref = max(groups.values(), key=len)[0]
    flat = [u for s in ref.sets for u in s]
    if len(flat) != n:
        raise ValueError(
            f"format topology has {len(flat)} drives, {n} provided")

    # Place each disk at its format slot; only BLANK disks may fill
    # leftover slots — a disk carrying a foreign format (different
    # deployment or unknown uuid) is an operator error, never silently
    # re-stamped (the reference refuses to boot on deployment-id
    # mismatch, ref formatErasureV3Check).
    ordered: list[StorageAPI | None] = [None] * n
    unplaced: list[StorageAPI] = []
    for disk, f in zip(disks, formats):
        if f is None:
            unplaced.append(disk)
            continue
        if f.deployment_id != ref.deployment_id or f.this not in flat:
            raise ValueError(
                f"disk {disk.endpoint()} belongs to a different "
                f"deployment ({f.deployment_id}); refusing to re-stamp")
        slot = flat.index(f.this)
        if ordered[slot] is None:
            ordered[slot] = disk
        else:
            raise ValueError(
                f"duplicate drive uuid {f.this} "
                f"({disk.endpoint()} vs {ordered[slot].endpoint()})")
    fresh: list[int] = []
    for slot in range(n):
        if ordered[slot] is None:
            disk = unplaced.pop(0)
            ordered[slot] = disk
            # Re-stamp the replacement disk with the slot identity.
            save_format(disk, FormatErasure(ref.deployment_id, flat[slot],
                                            ref.sets))
            fresh.append(slot)
    return ref, ordered, fresh
