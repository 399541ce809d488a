"""Bitrot protection: per-shard checksums in the reference's formats.

Port of minio_tpu/erasure/bitrot.py. Two modes (ref cmd/bitrot.go:99-111):
- streaming (default, HighwayHash256S): the shard file interleaves
  [32B hash][shard-block] for every shard_size sub-block
  (ref cmd/bitrot-streaming.go:46-57 write, :115-158 verify-on-read).
- whole-file (legacy): one checksum over the whole shard.

Every HighwayHash goes through ops/hh256_gpu.hash_chunks on ``device``:
equal-length rows as one batch (the ragged tail frames of many streams
too, one batch per tail length; a lone frame is a batch of one). On
``device="cuda"`` (the default) that is the CUDA kernel; on ``"cpu"`` its
plain PyTorch version. SHA256 and BLAKE2b stay on hashlib, as in the
reference. Data goes in and comes out as bytes / numpy arrays.
"""

from __future__ import annotations

import hashlib

import numpy as np

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


def is_streaming(algo: str) -> bool:
    return algo == HIGHWAYHASH256S


def hash_size(algo: str) -> int:
    return {SHA256: 32, BLAKE2B: 64,
            HIGHWAYHASH256: 32, HIGHWAYHASH256S: 32}[algo]


def _hh_rows(rows: np.ndarray, device) -> np.ndarray:
    """(B, L>0) uint8 rows -> (B, 32) HighwayHash digests in ONE
    hash_chunks call on ``device``, counted in HH_STATS."""
    dev = _cuda.resolve_device(device)
    digs = hh256_gpu.hash_chunks(_cuda.to_device(rows, dev), MAGIC_KEY)
    batching.HH_STATS.add(dev.type == "cuda", rows.size)
    return digs.cpu().numpy()


def _as_array(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def digest(algo: str, data, device="cuda") -> bytes:
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
    return digest_chunks_many(algo, [data], chunk_size, device)[0]


def digest_chunks_many(algo: str, streams: list[bytes], chunk_size: int,
                       device="cuda") -> list[list[bytes]]:
    """Per-stream chunk digests, with all full chunks of all streams
    hashed in ONE batch and the ragged tail chunks in one batch per tail
    length (a PUT's tails share a length: one batch). The digests are the
    JAX package's, which hashes the tails one by one on the host."""
    full_counts = [len(s) // chunk_size for s in streams]
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
    stacked = np.concatenate(arrs, axis=0) if len(arrs) > 1 else arrs[0]
    digs = digest_rows(algo, stacked, device)
    out, row = [], 0
    for a in arrs:
        B, S = a.shape
        frame = np.empty((B, hsize + S), dtype=np.uint8)
        frame[:, :hsize] = digs[row:row + B]
        frame[:, hsize:] = a
        row += B
        out.append(frame.reshape(-1))
    return out


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
    for idxs in by_len.values():
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
