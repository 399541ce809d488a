"""Bitrot framing: the port's erasure/bitrot.py (on its CPU lane) held to
the JAX package's bitrot.py and the golden framed-shard pins, and frames
carried across in both directions."""

import hashlib

import numpy as np
import pytest

from minio_tpu.erasure import bitrot as ref_bitrot
from minio_tpu.ops import rs_cpu as ref_rs_cpu
from minio_tpu_torch import interop
from minio_tpu_torch.erasure import bitrot
from minio_tpu_torch.ops import batching

# tests/test_golden.py: streaming-bitrot shard files of shard 0 / shard 8
# of the (8,4) encode of pattern(65536), shard_size=4096.
FRAMED_LEN = 8256
FRAMED_DATA_SHA = \
    "fc894d69ec51feea973395d8b96f7be5cf7293f5cf0e9ebf7008157d3fc9fbb5"
FRAMED_DATA_FIRST_HASH = \
    "b2edb37d72d0a2d671c97136f0d594f5c9e68c6f6306ea8d4a8cd4fbffccb7d0"
FRAMED_PARITY_SHA = \
    "af6ef90e7d207f11e86d5f98bd73364dd2fbfaa3dc6bebdea0235e5e350d0fc9"

CPU = "cpu"


def pattern(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    return ((i * 131 + 17) % 251).astype(np.uint8)


def _rand(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n).astype(
        np.uint8).tobytes()


def test_golden_framed_shards():
    shards = ref_rs_cpu.encode_data(pattern(65536).tobytes(), 8, 4)
    framed = bitrot.encode_stream(shards[0].tobytes(), 4096, device=CPU)
    assert len(framed) == FRAMED_LEN
    assert hashlib.sha256(framed).hexdigest() == FRAMED_DATA_SHA
    assert framed[:32].hex() == FRAMED_DATA_FIRST_HASH
    framed_p = bitrot.encode_stream(shards[8].tobytes(), 4096, device=CPU)
    assert hashlib.sha256(framed_p).hexdigest() == FRAMED_PARITY_SHA
    assert bitrot.decode_stream_at(framed, 0, 8192, 4096, device=CPU) == \
        shards[0].tobytes()
    assert bitrot.verify_stream(framed, 4096, device=CPU)


@pytest.mark.parametrize("algo", [bitrot.HIGHWAYHASH256S,
                                  bitrot.HIGHWAYHASH256, bitrot.SHA256,
                                  bitrot.BLAKE2B])
def test_digest_equals_reference(algo):
    for n in (0, 1, 31, 32, 100, 4097):
        data = _rand(n, n)
        assert bitrot.digest(algo, data, device=CPU) == \
            ref_bitrot.digest(algo, data), (algo, n)
    data = _rand(7, 1000)
    assert bitrot.digest_chunks(algo, data, 96, device=CPU) == \
        ref_bitrot.digest_chunks(algo, data, 96)


def test_stream_functions_equal_reference():
    streams = [_rand(n, n) for n in (4096, 4097, 100, 0, 1024)]
    assert bitrot.encode_streams(streams, 1024, device=CPU) == \
        ref_bitrot.encode_streams(streams, 1024)
    assert bitrot.digest_chunks_many(bitrot.DEFAULT_ALGORITHM, streams, 64,
                                     device=CPU) == \
        ref_bitrot.digest_chunks_many(ref_bitrot.DEFAULT_ALGORITHM,
                                      streams, 64)
    for s in streams:
        assert bitrot.encode_stream(s, 1024, device=CPU) == \
            ref_bitrot.encode_stream(s, 1024)
        assert bitrot.bitrot_shard_file_size(
            len(s), 1024, bitrot.DEFAULT_ALGORITHM) == \
            ref_bitrot.bitrot_shard_file_size(
                len(s), 1024, ref_bitrot.DEFAULT_ALGORITHM)


def test_encode_stream_arrays_and_frame_shard_equal_reference():
    rng = np.random.default_rng(3)
    arrs = [rng.integers(0, 256, (3, 777)).astype(np.uint8)
            for _ in range(4)]
    got = bitrot.encode_stream_arrays(arrs, device=CPU)
    want = ref_bitrot.encode_stream_arrays(arrs)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    tail = _rand(9, 300)
    assert bitrot.frame_shard(arrs[0], tail, device=CPU) == \
        ref_bitrot.frame_shard(arrs[0], tail)
    assert bitrot.frame_shard(arrs[0], tail, bitrot.SHA256) == \
        ref_bitrot.frame_shard(arrs[0], tail, ref_bitrot.SHA256)


def test_jax_frames_verify_in_port_and_back():
    """Shard files framed by the JAX package verify and decode in the
    port, and the port's frames verify in the JAX package."""
    rng = np.random.default_rng(11)
    S = 1000
    arrs = [rng.integers(0, 256, (4, S)).astype(np.uint8) for _ in range(3)]
    tails = [_rand(20 + j, 123) for j in range(3)]
    jax_files = [np.concatenate([f, np.frombuffer(t, np.uint8)])
                 for f, t in zip(ref_bitrot.encode_stream_arrays(arrs),
                                 ref_bitrot.encode_streams(tails, S))]
    blocks, hashes = interop.shards_from_numpy(jax_files, S)
    assert len(blocks) == 5
    datas = [blocks[b][j] for b in range(5) for j in range(3)]
    wants = [hashes[b][j] for b in range(5) for j in range(3)]
    assert all(bitrot.verify_frames(datas, wants, device=CPU))
    for j in range(3):
        assert bitrot.verify_stream(jax_files[j].tobytes(), S, device=CPU)
        assert bitrot.decode_stream_at(jax_files[j].tobytes(), 0,
                                       4 * S + 123, S, device=CPU) == \
            arrs[j].tobytes() + tails[j]

    port_files = [np.concatenate([f, np.frombuffer(t, np.uint8)])
                  for f, t in zip(bitrot.encode_stream_arrays(arrs,
                                                              device=CPU),
                                  bitrot.encode_streams(tails, S,
                                                        device=CPU))]
    for j in range(3):
        assert np.array_equal(port_files[j], jax_files[j])
        assert ref_bitrot.verify_stream(port_files[j].tobytes(), S)


def test_verify_frames_flags_corruption():
    rng = np.random.default_rng(12)
    datas = [rng.integers(0, 256, 128).astype(np.uint8) for _ in range(6)]
    datas.append(rng.integers(0, 256, 37).astype(np.uint8))
    wants = [ref_bitrot.digest(ref_bitrot.DEFAULT_ALGORITHM, d.tobytes())
             for d in datas]
    datas[2] = datas[2].copy()
    datas[2][5] ^= 0xFF
    wants[6] = b"\x00" * 32
    batching.HH_STATS.reset()
    ok = bitrot.verify_frames(datas, wants, device=CPU)
    assert ok == [True, True, False, True, True, True, False]
    snap = batching.HH_STATS.snapshot()
    assert snap["tpu_dispatches"] == 2 and snap["cpu_dispatches"] == 0
    framed = bytearray(bitrot.encode_stream(_rand(13, 300), 128,
                                            device=CPU))
    framed[40] ^= 1
    assert not bitrot.verify_stream(bytes(framed), 128, device=CPU)
    with pytest.raises(bitrot.BitrotMismatch):
        bitrot.extract_block(bytes(framed), 0, 128, 128, device=CPU)


@pytest.mark.parametrize("tails", [(300, 300, 300, 300), (300, 17, 300, 0),
                                   (5, 6, 7, 8)])
def test_digest_chunks_many_batches_tails(monkeypatch, tails):
    """Full chunks of all streams hash in one hash_chunks call and the
    ragged tails in one call per distinct tail length; the digests equal
    the JAX package's, which hashes each tail on its own."""
    from minio_tpu_torch.ops import hh256_gpu

    chunk = 512
    streams = [_rand(40 + i, (2 + i) * chunk + t)
               for i, t in enumerate(tails)]
    calls = []
    real = hh256_gpu.hash_chunks

    def counting(rows, key):
        calls.append(tuple(rows.shape))
        return real(rows, key)

    monkeypatch.setattr(hh256_gpu, "hash_chunks", counting)
    got = bitrot.digest_chunks_many(bitrot.DEFAULT_ALGORITHM, streams,
                                    chunk, device=CPU)
    assert got == ref_bitrot.digest_chunks_many(
        ref_bitrot.DEFAULT_ALGORITHM, streams, chunk)
    assert len(calls) == 1 + len({t for t in tails if t})
    assert calls[0] == (sum(2 + i for i in range(len(tails))), chunk)


def test_encode_streams_tails_only_one_call(monkeypatch):
    """A PUT's tail shards (no full chunk, one shared length) hash in one
    call, and frame byte-identically to the JAX package."""
    from minio_tpu_torch.ops import hh256_gpu

    streams = [_rand(60 + j, 700) for j in range(16)]
    calls = []
    real = hh256_gpu.hash_chunks
    monkeypatch.setattr(hh256_gpu, "hash_chunks",
                        lambda rows, key: calls.append(1) or real(rows, key))
    assert bitrot.encode_streams(streams, 1024, device=CPU) == \
        ref_bitrot.encode_streams(streams, 1024)
    assert len(calls) == 1
