"""Minimum-bandwidth heal collection for REGEN objects, plus the
repair-traffic ledger both heal paths (RS and regen) report into.

Repair-by-transfer collection: to rebuild the one lost node f, each of
the d = n-1 helpers ships exactly ONE stored stripe row per block — a
ranged read via the `repair_project` storage RPC (so in a distributed
set only the d * nst projection bytes cross the wire, never the
helper's full chunk).  The shipped rows ARE the lost node's chunk rows
verbatim (ops/rs_regen.repair_rows), so assembly is a permutation, not
math.  Per repaired block this moves d * ceil(block/B) bytes of disk
AND network traffic versus the ~k * ceil(block/k) ≈ block bytes the
conventional k-shard read pays — the ≥2x reduction the regen_repair
bench measures (4+2: ~2.8x).

Fallback ladder (never torn, always byte-exact): any helper shortfall
— a second missing shard, an unreachable helper, a short projection —
drops that part's remaining groups to the conventional path: read any
k full chunks, solve the message stripes, re-encode the lost nodes
(RegenErasure.reencode_missing_batch).  Both paths emit identical
group frames, so a mid-part downgrade resumes seamlessly.  Fewer than
k readable chunks raises RegenRepairFailed (storage/errors.py).

Bitrot note: projection reads are ranged reads INSIDE a bitrot frame,
so they cannot be frame-verified here — corrupt disks were already
excluded by heal's classification pass, the rebuilt shard gets fresh
frames at write-back, and silent helper rot is the deep scrub's job
(the same trust window the reference's ranged shard reads live with).

The port's own copy of ``minio_tpu/erasure/regen/repair.py``, with no
change in behaviour but the engine's device seam (erasure/engine.py):
every frame check and re-framing hashes on the engine's
``bitrot_device``.
"""

from __future__ import annotations

import threading

import numpy as np

from ...storage import errors as serr
from ...utils import ceil_frac
from .. import bitrot


class _RepairBytesLedger:
    """Process-wide repair-traffic counters: bytes helpers read from
    media (src=disk) and bytes shipped in helper responses (src=net),
    split by repair mode (rs | regen).  Mirrored into metrics2
    (`minio_tpu_v2_heal_repair_bytes_total`) and snapshotted by the
    admin /recovery report — the observable form of the 2x claim."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counts: dict[tuple[str, str], int] = {}

    def add(self, mode: str, src: str, nbytes: int) -> None:
        if nbytes <= 0:
            return
        from ...obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_heal_repair_bytes_total",
                     {"mode": mode, "src": src}, nbytes)
        with self._mu:
            key = (mode, src)
            self._counts[key] = self._counts.get(key, 0) + nbytes

    def snapshot(self) -> dict:
        with self._mu:
            out: dict[str, dict[str, int]] = {}
            for (mode, src), v in sorted(self._counts.items()):
                out.setdefault(mode, {})[src] = v
            return out

    def reset(self) -> None:
        with self._mu:
            self._counts.clear()


REPAIR_BYTES = _RepairBytesLedger()


def regen_heal_groups(eng, bucket: str, object_name: str, fi, codec,
                      parts, missing_shards: list[int],
                      shard_of_disk: dict[int, int],
                      read_order: list[int], part_algo,
                      group_budget: int):
    """Yield (part_number, {shard: framed bytes}) per block group for a
    REGEN object — the regen counterpart of heal.py's produce_groups,
    consumed by the same write-back pipeline (so crash points, intent
    staging and commit are shared with the RS path)."""
    k, m = codec.data_blocks, codec.parity_blocks
    g = codec.g
    shard_size = codec.shard_size()
    block_size = fi.erasure.block_size
    # Healthiest disk per shard (read_order is already health-ranked).
    disk_of_shard: dict[int, int] = {}
    for i in read_order:
        disk_of_shard.setdefault(shard_of_disk[i], i)
    fast = (len(missing_shards) == 1
            and all(j in disk_of_shard for j in range(g.n)
                    if j != missing_shards[0]))
    from ...ops.rs_regen import repair_rows
    plan = (repair_rows(k, m, missing_shards[0]) if fast else None)

    for part in parts:
        algo = part_algo(part)
        hsz = bitrot.hash_size(algo) if bitrot.is_streaming(algo) else 0
        rel = f"{object_name}/{fi.data_dir}/part.{part.number}"
        n_blocks = ceil_frac(part.size, block_size)
        if n_blocks == 0:
            yield part.number, {j: b"" for j in missing_shards}
            continue
        group = max(1, group_budget // max(block_size, 1))
        part_fast = fast
        streams: dict[int, bytes] | None = None  # fallback full reads
        for b0 in range(0, n_blocks, group):
            metas = []
            for b in range(b0, min(b0 + group, n_blocks)):
                blk_len = min(block_size, part.size - b * block_size)
                metas.append((b, blk_len, codec.stripe_count(blk_len)))
            frames = None
            if part_fast:
                try:
                    frames = _collect_group_rbt(
                        eng, bucket, rel, metas, plan, disk_of_shard,
                        missing_shards[0], g, hsz, shard_size, algo)
                except serr.StorageError as exc:
                    # One flapping helper must not fail the heal: the
                    # rest of this part downgrades to the conventional
                    # any-k path (identical frames, seamless resume).
                    import logging
                    logging.getLogger("minio_tpu_torch.heal").warning(
                        "regen min-bandwidth repair of %s/%s part %d "
                        "fell back to k-chunk decode: %r", bucket,
                        object_name, part.number, exc)
                    part_fast = False
            if frames is None:
                if streams is None:
                    streams = _read_fallback_streams(
                        eng, bucket, rel, read_order, shard_of_disk, k)
                frames = _rebuild_group_conventional(
                    codec, streams, metas, missing_shards, hsz,
                    shard_size, algo, eng.bitrot_device)
            yield part.number, frames


def _collect_group_rbt(eng, bucket: str, rel: str, metas, plan,
                       disk_of_shard: dict[int, int], f: int, g,
                       hsz: int, shard_size: int, algo: str,
                       ) -> dict[int, bytes]:
    """One group's lost-node frames via repair-by-transfer: one stored
    row per helper per block, fetched as a single ranged-read RPC per
    helper covering the whole group."""
    rows_by_dest: dict[int, list[bytes]] = {}
    for helper, helper_row, dest_row in plan:
        disk = eng.disks[disk_of_shard[helper]]
        ranges = []
        for b, _blk_len, nst in metas:
            # Block b's data starts after b full framed blocks (only
            # the part-final block is short, and it is never BEFORE
            # another block); stored row r is contiguous at r * nst.
            off = b * (hsz + shard_size) + hsz + helper_row * nst
            ranges.append((off, nst))
        data = disk.repair_project(bucket, rel, ranges)
        expect = sum(nst for _b, _bl, nst in metas)
        if len(data) != expect:
            raise serr.FaultyDisk(
                f"repair_project shard {helper}: got {len(data)} "
                f"bytes, want {expect}")
        REPAIR_BYTES.add("regen", "disk", len(data))
        REPAIR_BYTES.add("regen", "net", len(data))
        pieces, off = [], 0
        for _b, _bl, nst in metas:
            pieces.append(bytes(data[off:off + nst]))
            off += nst
        rows_by_dest[dest_row] = pieces
    acc = bytearray()
    for bi in range(len(metas)):
        for r in range(g.d):
            acc += rows_by_dest[r][bi]
    return {f: bitrot.encode_stream(bytes(acc), shard_size, algo,
                                    device=eng.bitrot_device)}


def _read_fallback_streams(eng, bucket: str, rel: str,
                           read_order: list[int],
                           shard_of_disk: dict[int, int],
                           k: int) -> dict[int, bytes]:
    """Conventional path survivor reads: any k full chunk streams,
    healthiest first (counted against the regen repair ledger — the
    fallback's cost must show in the same counters the 2x claim uses)."""
    streams: dict[int, bytes] = {}
    for i in read_order:
        if len(streams) == k:
            break
        j = shard_of_disk[i]
        if j in streams:
            continue
        try:
            data = eng.disks[i].read_all(bucket, rel)
        except serr.StorageError:
            continue
        REPAIR_BYTES.add("regen", "disk", len(data))
        REPAIR_BYTES.add("regen", "net", len(data))
        streams[j] = data
    if len(streams) < k:
        raise serr.RegenRepairFailed(
            f"regen heal {bucket}/{rel}: only {len(streams)}/{k} "
            "survivor chunks readable")
    return streams


def _rebuild_group_conventional(codec, streams: dict[int, bytes],
                                metas, missing_shards: list[int],
                                hsz: int, shard_size: int, algo: str,
                                device) -> dict[int, bytes]:
    """One group's frames via any-k decode + re-encode of the lost
    nodes (RegenErasure.reencode_missing_batch, batched per group);
    frames are checked and hashed on ``device``."""
    g = codec.g
    blocks, lens = [], []
    for b, blk_len, nst in metas:
        chunk = g.d * nst
        shards: list[np.ndarray | None] = [None] * g.n
        for j, stream in streams.items():
            data = bitrot.extract_block(stream, b, chunk, shard_size,
                                        algo, device=device)
            shards[j] = np.frombuffer(data, dtype=np.uint8)
        blocks.append(shards)
        lens.append(blk_len)
    acc = {j: bytearray() for j in missing_shards}
    for per in codec.reencode_missing_batch(blocks, lens,
                                            missing_shards):
        for j in missing_shards:
            acc[j] += per[j]
    return {j: bitrot.encode_stream(bytes(acc[j]), shard_size, algo,
                                    device=device)
            for j in missing_shards}
