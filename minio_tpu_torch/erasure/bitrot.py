"""Bitrot protection: per-shard checksums in the reference's formats.

Port of minio_tpu/erasure/bitrot.py. Two modes (ref cmd/bitrot.go:99-111):
- streaming (default, HighwayHash256S): the shard file interleaves
  [32B hash][shard-block] for every shard_size sub-block
  (ref cmd/bitrot-streaming.go:46-57 write, :115-158 verify-on-read).
- whole-file (legacy): one checksum over the whole shard.

On a pinned ``device`` every HighwayHash goes through
ops/hh256_gpu.hash_chunks: equal-length rows as one batch (the ragged
tail frames of many streams too, one batch per tail length; a lone frame
is a batch of one). On ``device="cuda"`` (the default) that is kernel K2;
on ``"cpu"`` its plain PyTorch version.

``device="auto"`` is the reference's host routing over the process
dispatch device (ops/batching.py): a batch of at least
``HH_TPU_MIN_BYTES`` of equal-length chunks hashes on K2 when the
dispatch device is a card (split over the serving mesh by
parallel/mesh.rows_sharding when B divides it); everything else hashes
natively on the host (native/highwayhash.cc, the shards of a large batch
fanned out over threads past ``HOST_HASH_FANOUT_MIN``), pure Python only
when the native library is disabled. A failed K2 dispatch feeds kernprof
and hashes on the host. "auto" raises without a card unless the dispatch
device is the CPU. SHA256 and BLAKE2b stay on hashlib, as in the
reference. Data goes in and comes out as bytes / numpy arrays.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..native import hh256_chunks_native, hh256_native, hh256_rows_native
from ..ops import _cuda, batching, hh256_gpu
from ..ops.hh256 import MAGIC_KEY, HighwayHash256
from ..utils import ceil_frac

# Algorithm names as stored in metadata (ref cmd/bitrot.go:33-38).
SHA256 = "sha256"
BLAKE2B = "blake2b"
HIGHWAYHASH256 = "highwayhash256"
HIGHWAYHASH256S = "highwayhash256S"  # streaming mode

DEFAULT_ALGORITHM = HIGHWAYHASH256S

_HH = (HIGHWAYHASH256, HIGHWAYHASH256S)

AUTO = "auto"

# Under "auto", coalesced full-chunk bytes at or above this go to kernel
# K2; below it, host hashing (C++ native) wins -- the same policy shape
# as the codec's static crossover (ops/autotune.py).
HH_TPU_MIN_BYTES = 4 * 1024 * 1024

# Below this many coalesced bytes, host hashing stays on the calling
# thread: a multi-thread fan-out of sub-millisecond native hash calls
# costs more in scheduling than it saves in parallelism.
HOST_HASH_FANOUT_MIN = 8 * 1024 * 1024


def is_streaming(algo: str) -> bool:
    return algo == HIGHWAYHASH256S


def hash_size(algo: str) -> int:
    return {SHA256: 32, BLAKE2B: 64,
            HIGHWAYHASH256: 32, HIGHWAYHASH256S: 32}[algo]


def _hh_rows(rows: np.ndarray, device) -> np.ndarray:
    """(B, L>0) uint8 rows -> (B, 32) HighwayHash digests in ONE
    hash_chunks call on ``device``, counted in HH_STATS and, as every
    other kernel dispatch, in the kernel metrics (``KERNEL``)."""
    from ..obs.kernel_stats import HH256, KERNEL, timed
    dev = _cuda.resolve_device(device)
    with timed() as t:
        digs = hh256_gpu.hash_chunks(_cuda.to_device(rows, dev),
                                     MAGIC_KEY).cpu().numpy()
    KERNEL.record(HH256, dev.type == "cuda", rows.size, t.s,
                  blocks=rows.shape[0],
                  backend=batching.attempt_backend(dev))
    batching.HH_STATS.add(True, rows.size)
    return digs


def _as_array(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def _auto(device) -> bool:
    """True for ``device="auto"``, after checking that the dispatch
    device resolves (it raises without a card when it is the card)."""
    if isinstance(device, str) and device == AUTO:
        batching.dispatch_device()
        return True
    return False


def _device_hash_ok(algo: str, chunk_size: int, total_full_bytes: int,
                    ) -> bool:
    """"auto": does this batch hash on K2?"""
    if algo not in _HH:
        return False
    if chunk_size <= 0 or total_full_bytes < HH_TPU_MIN_BYTES:
        return False
    return batching.device_present() and batching._device_allowed()


def _hash_rows_device(stacked: np.ndarray, total_bytes: int,
                      n_requests: int):
    """"auto": one K2 dispatch over (B, L) uint8 rows -> (B, 32) digests,
    the rows split over the serving mesh when B divides it (rows_sharding),
    or None when the CPU kernel lane failed (callers hash on the host; a
    card's failure raises). HH_STATS counts the outcome either way."""
    from ..obs.kernel_stats import HH256, KERNEL, timed
    B = stacked.shape[0]
    try:
        dev = batching.dispatch_device()
        with timed() as t:
            mesh = batching.serving_mesh()
            if mesh is not None and B % mesh.size == 0:
                from ..parallel.mesh import rows_sharding
                census = batching.device_list()
                parts = [(rs, hh256_gpu.hash_chunks(_cuda.to_device(
                    stacked[rs], census[di]), MAGIC_KEY))
                    for di, rs, _ in rows_sharding(mesh, B).tiles]
                digs = np.empty((B, 32), dtype=np.uint8)
                for rs, d in parts:
                    digs[rs] = d.cpu().numpy()
            else:
                digs = hh256_gpu.hash_chunks(_cuda.to_device(stacked, dev),
                                             MAGIC_KEY).cpu().numpy()
        KERNEL.record(HH256, dev.type == "cuda", total_bytes, t.s,
                      blocks=B, backend=batching.attempt_backend(dev))
        batching.HH_STATS.add(True, total_bytes, n_requests)
        return digs
    except Exception as exc:  # noqa: BLE001 - CPU lane failover
        if not batching.device_dispatch_failed(exc):
            raise
        batching.HH_STATS.add(False, total_bytes, n_requests)
        return None


def _host_digest(algo: str, data) -> bytes:
    """"auto": one digest on the host, native first."""
    if algo in _HH:
        native = hh256_native(bytes(data), MAGIC_KEY)
        if native is not None:
            return native
        return HighwayHash256(MAGIC_KEY).update(bytes(data)).digest()
    return digest(algo, data, "cpu")


def _host_digest_chunks(algo: str, data: bytes,
                        chunk_size: int) -> list[bytes]:
    """"auto": consecutive chunk digests on the host, native first."""
    if len(data) == 0:
        return []
    if algo in _HH:
        from ..obs.kernel_stats import HH256, KERNEL, timed
        from ..obs.kernprof import NATIVE
        with timed() as t:
            native = hh256_chunks_native(bytes(data), chunk_size, MAGIC_KEY)
        if native is not None:
            KERNEL.record(HH256, False, len(data), t.s,
                          blocks=len(native), backend=NATIVE)
            return native
    n = ceil_frac(len(data), chunk_size)
    return [_host_digest(algo, data[i * chunk_size:(i + 1) * chunk_size])
            for i in range(n)]


def _host_digest_rows(algo: str, arr: np.ndarray) -> np.ndarray:
    """"auto": (B, chunk) -> (B, hash_size) on the host, native first,
    zero input copies for a contiguous array."""
    B = arr.shape[0]
    if algo in _HH:
        from ..obs.kernel_stats import HH256, KERNEL, timed
        from ..obs.kernprof import NATIVE
        with timed() as t:
            out = hh256_rows_native(arr, MAGIC_KEY)
        if out is not None:
            batching.HH_STATS.add(False, arr.size)
            KERNEL.record(HH256, False, arr.size, t.s, blocks=B,
                          backend=NATIVE)
            return out
    out = np.empty((B, hash_size(algo)), dtype=np.uint8)
    for i in range(B):
        out[i] = np.frombuffer(_host_digest(algo, arr[i].tobytes()),
                               dtype=np.uint8)
    return out


def _host_digest_many(algo: str, streams: list,
                      chunk_size: int) -> list[list[bytes]]:
    """"auto" host path of digest_chunks_many: on multicore hosts the
    k+m shards hash in parallel (the native kernel releases the GIL)."""
    from ..parallel.quorum import MULTICORE, parallel_map
    if len(streams) > 1 and MULTICORE and \
            sum(len(s) for s in streams) >= HOST_HASH_FANOUT_MIN:
        results, errs = parallel_map(
            [lambda s=s: _host_digest_chunks(algo, s, chunk_size)
             for s in streams])
        if not any(e is not None for e in errs):
            return results
    return [_host_digest_chunks(algo, s, chunk_size) for s in streams]


def digest(algo: str, data, device="cuda") -> bytes:
    if _auto(device):
        return _host_digest(algo, data)
    if algo in _HH:
        arr = _as_array(data)
        if arr.size == 0:
            # No packets to hash: the empty input's digest is a constant
            # of the key, taken from the host reference.
            return HighwayHash256(MAGIC_KEY).digest()
        return _hh_rows(arr[None, :], device)[0].tobytes()
    if algo == SHA256:
        return hashlib.sha256(bytes(data)).digest()
    if algo == BLAKE2B:
        return hashlib.blake2b(bytes(data), digest_size=64).digest()
    raise ValueError(f"unsupported bitrot algorithm: {algo}")


def digest_rows(algo: str, arr: np.ndarray, device="cuda") -> np.ndarray:
    """(B, chunk) uint8 -> (B, hash_size) digests; HighwayHash rows go
    through one batch."""
    B = arr.shape[0]
    if _auto(device):
        if B and _device_hash_ok(algo, arr.shape[1], arr.size):
            digs = _hash_rows_device(arr, arr.size, 1)
            if digs is not None:
                return digs
        return _host_digest_rows(algo, arr)
    if algo in _HH and B and arr.shape[1]:
        return _hh_rows(arr, device)
    out = np.empty((B, hash_size(algo)), dtype=np.uint8)
    for i in range(B):
        out[i] = np.frombuffer(digest(algo, arr[i].tobytes(), device),
                               dtype=np.uint8)
    return out


def digest_chunks(algo: str, data: bytes, chunk_size: int,
                  device="cuda") -> list[bytes]:
    """Hash consecutive chunk_size chunks (the streaming-bitrot pattern)."""
    if _auto(device):
        return _host_digest_chunks(algo, data, chunk_size)
    return digest_chunks_many(algo, [data], chunk_size, device)[0]


def digest_chunks_many(algo: str, streams: list[bytes], chunk_size: int,
                       device="cuda") -> list[list[bytes]]:
    """Per-stream chunk digests, with all full chunks of all streams
    hashed in ONE batch and the ragged tail chunks in one batch per tail
    length (a PUT's tails share a length: one batch). The digests are the
    JAX package's, which hashes the tails one by one on the host. Under
    "auto" the full chunks hash in one K2 dispatch when they clear the
    policy, the tails on the host."""
    full_counts = [len(s) // chunk_size for s in streams]
    if _auto(device):
        return _auto_digest_many(algo, streams, chunk_size, full_counts)
    if algo not in _HH:
        return [[digest(algo, s[i * chunk_size:(i + 1) * chunk_size],
                        device) for i in range(-(-len(s) // chunk_size))]
                for s in streams]
    out: list[list[bytes]] = [[] for _ in streams]
    if sum(full_counts):
        stacked = np.concatenate([
            _as_array(s)[:nf * chunk_size].reshape(nf, chunk_size)
            for s, nf in zip(streams, full_counts) if nf])
        digs = _hh_rows(stacked, device)
        row = 0
        for hs, nf in zip(out, full_counts):
            hs.extend(digs[row + i].tobytes() for i in range(nf))
            row += nf
    by_len: dict[int, list[int]] = {}
    for i, (s, nf) in enumerate(zip(streams, full_counts)):
        if len(s) > nf * chunk_size:
            by_len.setdefault(len(s) - nf * chunk_size, []).append(i)
    for idxs in by_len.values():
        tails = np.stack([_as_array(streams[i])[full_counts[i] * chunk_size:]
                          for i in idxs])
        digs = _hh_rows(tails, device)
        for row, i in enumerate(idxs):
            out[i].append(digs[row].tobytes())
    return out


def _auto_digest_many(algo: str, streams: list, chunk_size: int,
                      full_counts: list[int]) -> list[list[bytes]]:
    total_full = sum(full_counts) * chunk_size
    if not _device_hash_ok(algo, chunk_size, total_full):
        return _host_digest_many(algo, streams, chunk_size)
    stacked = np.concatenate([
        _as_array(s)[:nf * chunk_size].reshape(nf, chunk_size)
        for s, nf in zip(streams, full_counts) if nf])
    digs = _hash_rows_device(stacked, total_full, len(streams))
    if digs is None:
        return _host_digest_many(algo, streams, chunk_size)
    out: list[list[bytes]] = []
    row = 0
    for s, nf in zip(streams, full_counts):
        hs = [digs[row + i].tobytes() for i in range(nf)]
        row += nf
        tail = s[nf * chunk_size:]
        if len(tail):
            hs.append(_host_digest(algo, tail))
        out.append(hs)
    return out


def encode_stream_arrays(arrs, algo: str = DEFAULT_ALGORITHM,
                         device="cuda"):
    """Frame per-shard sub-block ARRAYS into streaming-bitrot shard
    chunks — the batched write path.

    arrs: one (n_blocks, chunk) uint8 array per shard (each row is one
    bitrot sub-block). Returns one flat uint8 array per shard laid out
    [hash][block][hash][block]..., byte-identical to ``encode_streams``
    over the equivalent bytes. Every shard's sub-blocks share the chunk
    size, so they hash in ONE batch."""
    if not is_streaming(algo):
        return [np.ascontiguousarray(a).reshape(-1) for a in arrs]
    hsize = hash_size(algo)
    if not arrs:
        return []
    if _auto(device):
        digs = _auto_rows_many(algo, arrs)
    else:
        digs = digest_rows(algo, np.concatenate(arrs, axis=0)
                           if len(arrs) > 1 else arrs[0], device)
    out, row = [], 0
    for a in arrs:
        B, S = a.shape
        frame = np.empty((B, hsize + S), dtype=np.uint8)
        frame[:, :hsize] = digs[row:row + B]
        frame[:, hsize:] = a
        row += B
        out.append(frame.reshape(-1))
    return out


def _auto_rows_many(algo: str, arrs) -> np.ndarray:
    """"auto": the digests of every shard's sub-blocks, stacked -- one K2
    dispatch when the batch clears the policy, else per shard on the
    host, fanned out over threads for a large batch."""
    total = sum(a.size for a in arrs)
    if _device_hash_ok(algo, arrs[0].shape[1], total):
        stacked = np.concatenate(arrs, axis=0) if len(arrs) > 1 \
            else arrs[0]
        digs = _hash_rows_device(stacked, total, len(arrs))
        if digs is not None:
            return digs
    from ..parallel.quorum import MULTICORE, parallel_map
    if len(arrs) > 1 and MULTICORE and total >= HOST_HASH_FANOUT_MIN:
        per, errs = parallel_map(
            [lambda a=a: _host_digest_rows(algo, a) for a in arrs])
        if not any(e is not None for e in errs):
            return np.concatenate(per, axis=0)
    return np.concatenate([_host_digest_rows(algo, a) for a in arrs],
                          axis=0)


def frame_shard(full_rows, tail: bytes | None,
                algo: str = DEFAULT_ALGORITHM, device="cuda") -> bytes:
    """Frame ONE shard's batch contribution: `full_rows` is a
    (n_blocks, shard_size) uint8 array (or None) of full-block
    sub-blocks, `tail` the final short block's bytes (or None).
    Byte-identical to this shard's slice of ``encode_stream_arrays`` +
    the tail frame of ``encode_streams``."""
    if not is_streaming(algo):
        parts = []
        if full_rows is not None and full_rows.size:
            parts.append(np.ascontiguousarray(full_rows)
                         .reshape(-1).tobytes())
        if tail:
            parts.append(bytes(tail))
        return b"".join(parts)
    hsize = hash_size(algo)
    parts = []
    if full_rows is not None and full_rows.size:
        B, S = full_rows.shape
        frame = np.empty((B, hsize + S), dtype=np.uint8)
        frame[:, :hsize] = digest_rows(algo, full_rows, device)
        frame[:, hsize:] = full_rows
        parts.append(frame.reshape(-1).tobytes())
    if tail:
        parts.append(digest(algo, tail, device) + bytes(tail))
    return b"".join(parts)


def bitrot_shard_file_size(size: int, shard_size: int, algo: str) -> int:
    """On-disk size of a shard file including interleaved hashes
    (ref cmd/bitrot.go:140)."""
    if not is_streaming(algo):
        return size
    if size < 0:
        return -1
    return ceil_frac(size, shard_size) * hash_size(algo) + size


def _frame(data: bytes, hs: list[bytes], shard_size: int) -> bytes:
    out = bytearray()
    for i, h in enumerate(hs):
        out += h
        out += data[i * shard_size:(i + 1) * shard_size]
    return bytes(out)


def encode_stream(data: bytes, shard_size: int,
                  algo: str = DEFAULT_ALGORITHM, device="cuda") -> bytes:
    """Wrap raw shard bytes in the streaming format:
    [hash][block][hash][block]... (ref cmd/bitrot-streaming.go:46)."""
    return encode_streams([data], shard_size, algo, device)[0]


def encode_streams(streams: list[bytes], shard_size: int,
                   algo: str = DEFAULT_ALGORITHM,
                   device="cuda") -> list[bytes]:
    """Batched encode_stream: frame many shards' bytes, hashing ALL their
    full sub-blocks in one batch."""
    if not is_streaming(algo):
        return list(streams)
    all_hashes = digest_chunks_many(algo, streams, shard_size, device)
    return [_frame(bytes(d), hs, shard_size)
            for d, hs in zip(streams, all_hashes)]


# Under "auto", worth one (B, L) stack copy: enough same-length frames
# that a single rows dispatch beats a Python loop of per-frame calls.
HOST_ROWS_MIN_FRAMES = 5


def verify_frames(datas: list, wants: list[bytes],
                  algo: str = DEFAULT_ALGORITHM,
                  device="cuda") -> list[bool]:
    """Batch-verify many [hash][block] frames: datas[i] (bytes or uint8
    array) must hash to wants[i]. Frames of equal length hash in one
    batch (ref streamingBitrotReader verify-per-chunk,
    cmd/bitrot-streaming.go:115, lifted to a batch)."""
    by_len: dict[int, list[int]] = {}
    for i, d in enumerate(datas):
        by_len.setdefault(len(d), []).append(i)
    ok = [False] * len(datas)
    auto = _auto(device)
    for length, idxs in by_len.items():
        if auto and (not length or algo not in _HH or (
                len(idxs) < HOST_ROWS_MIN_FRAMES and not _device_hash_ok(
                    algo, length, length * len(idxs)))):
            for i in idxs:
                ok[i] = _host_digest(algo, datas[i]) == bytes(wants[i])
            continue
        stack = np.stack([_as_array(datas[i]) for i in idxs])
        digs = digest_rows(algo, stack, device)
        for row, i in enumerate(idxs):
            ok[i] = digs[row].tobytes() == bytes(wants[i])
    return ok


class BitrotMismatch(Exception):
    """Shard sub-block hash mismatch (ref errHashMismatch,
    cmd/bitrot-streaming.go:30)."""


def extract_block(buf: bytes, block_idx: int, chunk: int, shard_size: int,
                  algo: str = DEFAULT_ALGORITHM, device="cuda") -> bytes:
    """Extract + verify one [hash][block] frame from a streaming shard
    buffer whose frame 0 starts at byte 0. `chunk` is the expected block
    payload length."""
    if not is_streaming(algo):
        return buf[block_idx * shard_size:block_idx * shard_size + chunk]
    hsz = hash_size(algo)
    base = block_idx * (hsz + shard_size)
    want = buf[base:base + hsz]
    data = buf[base + hsz:base + hsz + chunk]
    if len(want) < hsz or len(data) < chunk:
        raise BitrotMismatch("truncated shard stream")
    if digest(algo, data, device) != want:
        raise BitrotMismatch(f"content hash mismatch at block {block_idx}")
    return data


def decode_stream_at(stream: bytes, offset: int, length: int,
                     shard_size: int, algo: str = DEFAULT_ALGORITHM,
                     device="cuda") -> bytes:
    """Read logical [offset, offset+length) from a streaming-format shard
    file, verifying every covered sub-block hash
    (ref streamingBitrotReader.ReadAt, cmd/bitrot-streaming.go:115).

    offset must be shard_size-aligned, like the reference."""
    if not is_streaming(algo):
        return stream[offset:offset + length]
    if offset % shard_size != 0:
        raise ValueError("offset must be aligned to shard_size")
    hsz = hash_size(algo)
    out = bytearray()
    block_idx = offset // shard_size
    remaining = length
    while remaining > 0:
        base = block_idx * (hsz + shard_size)
        avail = len(stream) - base - hsz
        if avail <= 0:
            raise BitrotMismatch("truncated shard stream")
        chunk = min(shard_size, avail)
        block = extract_block(stream, block_idx, chunk, shard_size, algo,
                              device)
        take = min(remaining, len(block))
        out += block[:take]
        remaining -= take
        if len(block) < shard_size:
            break  # last (short) block
        block_idx += 1
    if remaining > 0:
        raise BitrotMismatch("short read from shard stream")
    return bytes(out)


def verify_stream(stream: bytes, shard_size: int,
                  algo: str = DEFAULT_ALGORITHM, device="cuda") -> bool:
    """Deep-scan a whole streaming shard file (VerifyFile equivalent,
    ref cmd/xl-storage.go:2312); all its frames verify as one batch per
    frame length."""
    if not is_streaming(algo):
        return True
    hsz = hash_size(algo)
    datas, wants = [], []
    off = 0
    while off < len(stream):
        want = stream[off:off + hsz]
        block = stream[off + hsz:off + hsz + shard_size]
        if len(want) < hsz or len(block) == 0:
            return False
        datas.append(block)
        wants.append(want)
        off += hsz + len(block)
    return all(verify_frames(datas, wants, algo, device))
