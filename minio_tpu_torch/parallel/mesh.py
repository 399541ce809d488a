"""Device placement for the erasure data plane, over a list of devices.

Port of minio_tpu/parallel/mesh.py. The object store's parallel axes map
to a 2-D grid of devices:

- 'blocks' (~DP): independent stripe blocks from concurrent PUTs/heals
  batch along the leading axis B.
- 'lanes'  (~TP): shard bytes (the S axis). Every GF(2^8) op is
  elementwise along S, so S splits with zero communication.

The reference lays a batch out with ``jax.sharding`` and lets one jitted
call run on every device. Here a placement is plain index arithmetic: for
each device, the (batch slice, lane slice) it computes; the dispatch
(ops/batching.py ``PlacedBatch``) launches the kernel once per tile on
that tile's device and gathers the results. There are no collectives, as
in the reference. Where the reference replicates an axis (every device
computing the same slice), the port computes each distinct tile once, on
the first device that holds it; the device-index tuple a placement
reports is the reference's.

Device indices are positions in the dispatch device census
(``ops/batching.device_list``).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass


class Mesh:
    """A near-square 2-D grid ('blocks' x 'lanes') over devices."""

    def __init__(self, devices):
        n = len(devices)
        if n < 1:
            raise ValueError("a mesh needs at least one device")
        # Factor n into (a, b) with a as large as possible <= sqrt(n).
        a = 1
        for cand in range(math.isqrt(n), 0, -1):
            if n % cand == 0:
                a = cand
                break
        self.devices = tuple(devices)
        self.shape = {"blocks": a, "lanes": n // a}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


def make_mesh(devices, n_devices: int | None = None) -> Mesh:
    """Build a near-square 2-D mesh over the first n of ``devices``."""
    n = n_devices or len(devices)
    return Mesh(list(devices)[:n])


@dataclass(frozen=True)
class Spec:
    """Which axes of a (B, ·, S) batch split over the mesh: the
    reference's PartitionSpec("blocks" | None, None, "lanes" | None)."""

    blocks: bool
    lanes: bool


def batch_sharding(mesh: Mesh, B: int, S: int) -> Spec:
    """B over 'blocks', S over 'lanes', the shard index whole -- where
    they divide: an axis that does not divide its mesh dimension stays
    whole (serving batches have arbitrary B and tail-block S). The one
    rule for the serving path and the dry run."""
    return Spec(B % mesh.shape["blocks"] == 0, S % mesh.shape["lanes"] == 0)


@dataclass(frozen=True)
class Placement:
    """Where a (B, ·, S) batch runs: per computing device, (device index,
    batch slice, lane slice). Tiles do not overlap and cover the batch."""

    tiles: tuple[tuple[int, slice, slice], ...]


def _tiles(mesh: Mesh, B: int, S: int, spec: Spec,
           ) -> tuple[tuple[int, slice, slice], ...]:
    a, b = mesh.shape["blocks"], mesh.shape["lanes"]
    seen: set[tuple[int, int, int, int]] = set()
    out = []
    for i in range(a):
        bs = slice(i * (B // a), (i + 1) * (B // a)) if spec.blocks \
            else slice(0, B)
        for j in range(b):
            ss = slice(j * (S // b), (j + 1) * (S // b)) if spec.lanes \
                else slice(0, S)
            key = (bs.start, bs.stop, ss.start, ss.stop)
            if key in seen:       # a replicated axis: computed once
                continue
            seen.add(key)
            out.append((i * b + j, bs, ss))
    return tuple(out)


def rows_sharding(mesh: Mesh, B: int) -> Placement:
    """Row-parallel placement for per-row-independent kernels (the
    HighwayHash batch): B spreads over EVERY mesh device in order when
    divisible, else the whole batch runs on the first device (the
    reference replicates it)."""
    if B % mesh.size == 0:
        step = B // mesh.size
        return Placement(tuple((d, slice(d * step, (d + 1) * step),
                                slice(None)) for d in range(mesh.size)))
    return Placement(((0, slice(0, B), slice(None)),))


def batch_placement(mesh: Mesh, B: int, S: int,
                    affinity: int | None = None,
                    ) -> tuple[Placement, tuple[int, ...]]:
    """(placement, device indices) for a (B, k, S) serving batch.

    Divisible axes split across the mesh as ``batch_sharding`` says. A
    batch NEITHER axis of which divides lands WHOLE on the owning
    erasure set's home device when it has an ``affinity``, so concurrent
    sets' small dispatches spread across devices instead of all queueing
    on device 0. The device-index tuple is the reference's: what the
    dispatch occupies, fed to ``MESH_AFFINITY.record_dispatch``."""
    spec = batch_sharding(mesh, B, S)
    if affinity is not None and not spec.blocks and not spec.lanes:
        idx = affinity % DeviceAffinity.n_devices()
        return Placement(((idx, slice(0, B), slice(0, S)),)), (idx,)
    return Placement(_tiles(mesh, B, S, spec)), tuple(range(mesh.size))


class DeviceAffinity:
    """Per-erasure-set home-device assignment + per-device dispatch
    census (``MESH_AFFINITY``).

    Each erasure set registers at construction and gets the next device
    round-robin; every placed dispatch records which device indices it
    occupied, so per-set affinity is only claimed where the counters
    say so."""

    def __init__(self):
        self._mu = threading.Lock()
        self._assign: dict[str, int] = {}
        self._next = 0
        self._dispatches: dict[int, int] = {}
        self._bytes: dict[int, int] = {}

    @staticmethod
    def n_devices() -> int:
        from ..ops import batching
        return batching.device_count()

    def assign(self, owner: str) -> int | None:
        """Home device index for `owner` (idempotent); None on a
        single-device box: affinity only means something on a mesh."""
        n = self.n_devices()
        if n <= 1:
            return None
        with self._mu:
            idx = self._assign.get(owner)
            if idx is None:
                idx = self._next % n
                self._next += 1
                self._assign[owner] = idx
            return idx

    def release(self, owner: str) -> None:
        with self._mu:
            self._assign.pop(owner, None)

    def record_dispatch(self, device_indices: tuple[int, ...],
                        nbytes: int) -> None:
        with self._mu:
            for i in device_indices:
                self._dispatches[i] = self._dispatches.get(i, 0) + 1
                self._bytes[i] = self._bytes.get(i, 0) + nbytes

    def counters(self) -> dict[int, dict]:
        with self._mu:
            return {i: {"dispatches": self._dispatches.get(i, 0),
                        "bytes": self._bytes.get(i, 0)}
                    for i in sorted(set(self._dispatches)
                                    | set(self._bytes))}

    def snapshot(self) -> dict:
        """The affinity map an admin view serves."""
        with self._mu:
            return {
                "nDevices": self.n_devices(),
                "assignments": dict(sorted(self._assign.items())),
                "dispatches": {
                    str(i): {"dispatches": self._dispatches.get(i, 0),
                             "bytes": self._bytes.get(i, 0)}
                    for i in sorted(set(self._dispatches)
                                    | set(self._bytes))},
            }

    def reset(self) -> None:
        with self._mu:
            self._assign.clear()
            self._next = 0
            self._dispatches.clear()
            self._bytes.clear()


MESH_AFFINITY = DeviceAffinity()
