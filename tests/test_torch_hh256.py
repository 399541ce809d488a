"""HighwayHash-256: the hash kernel's plain version held to the JAX
package's device hash (hh256_tpu.hash_chunks) and its host reference
(ops/hh256.hh256), byte for byte. Data is made with numpy from a seed."""

import struct

import numpy as np
import pytest
import torch

from minio_tpu.ops import hh256 as ref_hh256
from minio_tpu.ops import hh256_tpu
from minio_tpu_torch.ops import hh256, hh256_gpu


def _host(chunks: np.ndarray, key: bytes = hh256.MAGIC_KEY) -> np.ndarray:
    return np.stack([np.frombuffer(ref_hh256.hh256(c.tobytes(), key),
                                   np.uint8) for c in chunks])


def _plain(chunks: np.ndarray, key: bytes = hh256.MAGIC_KEY) -> np.ndarray:
    return hh256_gpu.hash_chunks(torch.from_numpy(chunks), key).numpy()


# Each distinct length compiles the JAX kernel anew (seconds on the CPU),
# so the JAX device hash is the oracle for a few shapes and the host
# reference for all of them.
@pytest.mark.parametrize("B,L,vs_jax", [
    (1, 32, False), (2, 64, False), (7, 96, False), (4, 4096, True),
    (16, 1024, False), (3, 32 * 37, False), (5, 2731, True)])
def test_plain_equals_jax_and_host(B, L, vs_jax):
    rng = np.random.default_rng(B * 1000 + L)
    chunks = rng.integers(0, 256, (B, L)).astype(np.uint8)
    got = _plain(chunks)
    if vs_jax:
        assert np.array_equal(got, hh256_tpu.hash_chunks(chunks))
    assert np.array_equal(got, _host(chunks))


@pytest.mark.parametrize("L", [1, 3, 5, 16, 17, 31, 33, 47, 63, 100, 2731])
def test_plain_unaligned_lengths(L):
    """Every len % 32 layout of the remainder packet."""
    rng = np.random.default_rng(L)
    chunks = rng.integers(0, 256, (3, L)).astype(np.uint8)
    assert np.array_equal(_plain(chunks), _host(chunks))


def test_magic_key_vectors():
    """The published magic-key vector (100 bytes, through the remainder
    path) and the 32-aligned derivative the JAX tests pin."""
    pi = np.frombuffer(hh256.PI_100_DECIMALS.encode(), np.uint8)
    pi = pi[None].copy()
    assert _plain(pi, b"\x00" * 32)[0].tobytes() == hh256.MAGIC_KEY
    assert hh256.MAGIC_KEY == ref_hh256.MAGIC_KEY
    assert hh256.MAGIC_KEY_SELF_TEST
    data = np.frombuffer(b"0123456789abcdef" * 4, np.uint8)[None].copy()
    got = _plain(data, b"\x00" * 32)
    assert np.array_equal(got, hh256_tpu.hash_chunks(data, b"\x00" * 32))


def test_rejects_empty_and_non_2d():
    with pytest.raises(ValueError):
        hh256_gpu.hash_chunks(torch.zeros((2, 0), dtype=torch.uint8))
    with pytest.raises(ValueError):
        hh256_gpu.hash_chunks(torch.zeros(64, dtype=torch.uint8))
    with pytest.raises(ValueError):
        hh256_tpu.hash_chunks(np.zeros((2, 0), np.uint8))


@pytest.mark.parametrize("rem", [1, 3, 4, 15, 16, 17, 31])
def test_pack_remainder_equals_reference(rem):
    rng = np.random.default_rng(rem)
    tail = rng.integers(0, 256, (4, rem)).astype(np.uint8)
    got = hh256_gpu._pack_remainder(torch.from_numpy(tail), rem).numpy()
    assert np.array_equal(got.view(np.uint32),
                          hh256_tpu._pack_remainder(tail, rem))


def test_init_state_equals_reference():
    key = bytes(range(32))
    for a, b in zip(hh256_gpu._init_state_np(key),
                    hh256_tpu._init_state_np(key)):
        assert np.array_equal(a, b)


def test_strided_rows_equal_contiguous():
    """A view whose rows sit at a stride (frames inside a shard file)."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.integers(0, 256, (5, 200), dtype=np.uint8))
    view = base[:, 3:170]
    assert torch.equal(hh256_gpu.hash_chunks(view),
                       hh256_gpu.hash_chunks(view.contiguous()))
    assert np.array_equal(hh256_gpu.hash_chunks(view).numpy(),
                          _host(view.contiguous().numpy()))


# --- a numpy model of csrc/hh256.cu's scheme ----------------------------------
#
# Two threads per chain: half h carries lanes 2h, 2h+1 (packet bytes 16h ..
# 16h+15) through every packet; the halves exchange v0 only for the permute
# rounds. Bytes come from the ring of aligned 16-byte chunks, read as two
# aligned quads, the five covering words picked by shift // 4 and funnel-
# shifted by shift % 4 bytes. The zipper is the kernel's PRMT selectors.

_U32 = np.uint64(0xFFFFFFFF)


def _byte_perm(x, y, sel: int):
    """CUDA __byte_perm on u32 values held in uint64 arrays."""
    src = [(x >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)] + \
        [(y >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint64(8 * n)
    return out


def _zipper_add(v1, v0, a1, a0):
    x0, x1 = v0 & _U32, v0 >> np.uint64(32)
    y0, y1 = v1 & _U32, v1 >> np.uint64(32)
    lo0 = _byte_perm(_byte_perm(x0, x1, 0x5203), y1, 0x3240)
    hi0 = _byte_perm(x0, y1, 0x0716)
    lo1 = _byte_perm(_byte_perm(y0, y1, 0x5203), x1, 0x3240)
    hi1 = _byte_perm(y0, x1, 0x7061)
    return (a1 + ((hi1 << np.uint64(32)) | lo1),
            a0 + ((hi0 << np.uint64(32)) | lo0))


def _swap32(x):
    return (x << np.uint64(32)) | (x >> np.uint64(32))


def _mul32(a, b):
    return (a & _U32) * (b >> np.uint64(32))


def _update(s, l0, l1):
    v0, v1, mul0, mul1 = s
    for i, lane in enumerate((l0, l1)):
        v1[i] = v1[i] + mul0[i] + lane
        mul0[i] = mul0[i] ^ _mul32(v1[i], v0[i])
        v0[i] = v0[i] + mul1[i]
        mul1[i] = mul1[i] ^ _mul32(v0[i], v1[i])
    v0[1], v0[0] = _zipper_add(v1[1], v1[0], v0[1], v0[0])
    v1[1], v1[0] = _zipper_add(v0[1], v0[0], v1[1], v1[0])


def _rot32_halves(x, c: int):
    if c == 0:
        return x
    lo, hi = x & _U32, x >> np.uint64(32)
    lo = ((lo << np.uint64(c)) | (lo >> np.uint64(32 - c))) & _U32
    hi = ((hi << np.uint64(c)) | (hi >> np.uint64(32 - c))) & _U32
    return (hi << np.uint64(32)) | lo


def _remainder_byte(tail: np.ndarray, rem: int, g: int) -> np.ndarray:
    """The kernel's remainder_byte over (B, rem) tails."""
    mod4, off = rem & 3, rem & ~3
    zero = np.zeros(tail.shape[0], np.uint64)
    if g < off:
        return tail[:, g].astype(np.uint64)
    if rem & 16:
        return tail[:, off + (g - 28) + mod4 - 4].astype(np.uint64) \
            if g >= 28 else zero
    if mod4 and g in (16, 17, 18):
        idx = {16: off, 17: off + (mod4 >> 1), 18: off + mod4 - 1}[g]
        return tail[:, idx].astype(np.uint64)
    return zero


def _model_hash(buf: np.ndarray, starts, L: int, key: bytes,
                seed: int = 0) -> np.ndarray:
    """Digests of the rows buf[start:start + L] (buf's byte 0 taken as
    16-byte aligned). Ring bytes the kernel never copies hold garbage."""
    starts = np.asarray(starts)
    B, n, rem = len(starts), L // 32, L % 32
    shift = starts % 16
    base = starts - shift
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 256, (B, 32 * n + 32)).astype(np.uint8)
    for b in range(B):
        nchunk = (int(shift[b]) + 32 * n + 15) // 16 if n else 0
        stream[b, :16 * nchunk] = buf[base[b]:base[b] + 16 * nchunk]
    words = stream.view("<u4").astype(np.uint64)
    kw = struct.unpack("<4Q", key)
    halves = []
    for h in (0, 1):
        lanes = (2 * h, 2 * h + 1)
        v0 = [np.full(B, np.uint64(hh256._INIT0[i] ^ kw[i])) for i in lanes]
        v1 = [np.full(B, np.uint64(hh256._INIT1[i] ^
                                   ((kw[i] & 0xFFFFFFFF) << 32 | kw[i] >> 32)))
              for i in lanes]
        mul0 = [np.full(B, np.uint64(hh256._INIT0[i])) for i in lanes]
        mul1 = [np.full(B, np.uint64(hh256._INIT1[i])) for i in lanes]
        halves.append([v0, v1, mul0, mul1])
    o = (shift >> 2)[:, None]
    sh = (8 * (shift & 3)).astype(np.uint64)
    for t in range(n):
        for h in (0, 1):
            x = words[:, 8 * t + 4 * h:8 * t + 4 * h + 8]
            z = np.take_along_axis(x, o + np.arange(5)[None, :], axis=1)
            wd = [(((z[:, q + 1] << np.uint64(32)) | z[:, q]) >> sh) & _U32
                  for q in range(4)]
            _update(halves[h], (wd[1] << np.uint64(32)) | wd[0],
                    (wd[3] << np.uint64(32)) | wd[2])
    if rem:
        tail = np.stack([buf[s + 32 * n:s + L] for s in starts])
        for h in (0, 1):
            v0, v1 = halves[h][0], halves[h][1]
            for i in range(2):
                v0[i] = v0[i] + np.uint64((rem << 32) + rem)
                v1[i] = _rot32_halves(v1[i], rem)
            wd = []
            for q in range(4):
                w = np.zeros(B, np.uint64)
                for a in range(4):
                    w |= _remainder_byte(tail, rem, 16 * h + 4 * q + a) \
                        << np.uint64(8 * a)
                wd.append(w)
            _update(halves[h], (wd[1] << np.uint64(32)) | wd[0],
                    (wd[3] << np.uint64(32)) | wd[2])
    for _ in range(10):
        other = [list(halves[1][0]), list(halves[0][0])]   # the shuffle
        for h in (0, 1):
            _update(halves[h], _swap32(other[h][0]), _swap32(other[h][1]))
    out = np.zeros((B, 4), np.uint64)
    for h in (0, 1):
        v0, v1, mul0, mul1 = halves[h]
        a3 = (v1[1] + mul1[1]) & np.uint64(0x3FFFFFFFFFFFFFFF)
        a2, a1, a0 = v1[0] + mul1[0], v0[1] + mul0[1], v0[0] + mul0[0]
        one, two = np.uint64(1), np.uint64(2)
        out[:, 2 * h + 1] = a1 ^ ((a3 << one) | (a2 >> np.uint64(63))) ^ \
            ((a3 << two) | (a2 >> np.uint64(62)))
        out[:, 2 * h] = a0 ^ (a2 << one) ^ (a2 << two)
    return out.astype("<u8").view(np.uint8).reshape(B, 32)


@pytest.mark.parametrize("rem", range(32))
def test_model_every_remainder_equals_host(rem):
    """Every L % 32, rows at every start offset mod 16 (row stride L + 1
    walks the offsets), against the JAX package's host hh256."""
    L = 32 * 5 + rem
    rng = np.random.default_rng(500 + rem)
    buf = rng.integers(0, 256, 16 * (L + 1) + 32).astype(np.uint8)
    starts = [3 + b * (L + 1) for b in range(16)]
    rows = np.stack([buf[s:s + L] for s in starts])
    assert np.array_equal(_model_hash(buf, starts, L, hh256.MAGIC_KEY, rem),
                          _host(rows))


@pytest.mark.parametrize("B,L,offset", [(5, 2731, 0), (3, 4096 + 17, 6)])
def test_model_equals_jax(B, L, offset):
    rng = np.random.default_rng(B * 100 + L)
    stride = L + 7
    buf = rng.integers(0, 256, B * stride + offset + 32).astype(np.uint8)
    starts = [offset + b * stride for b in range(B)]
    rows = np.stack([buf[s:s + L] for s in starts])
    got = _model_hash(buf, starts, L, hh256.MAGIC_KEY)
    assert np.array_equal(got, hh256_tpu.hash_chunks(rows))
    key = bytes(range(32))
    assert np.array_equal(_model_hash(buf, starts, L, key), _host(rows, key))


def test_model_magic_key_vector():
    pi = np.frombuffer(hh256.PI_100_DECIMALS.encode(), np.uint8)
    buf = np.concatenate([np.zeros(9, np.uint8), pi, np.zeros(32, np.uint8)])
    assert _model_hash(buf, [9], 100, b"\x00" * 32)[0].tobytes() == \
        hh256.MAGIC_KEY


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 31, 32, 33, 511, 512, 513, 4096 + 17,
                               16 * 512 + 45])
def test_kernel_equals_plain(cuda_device, L):
    rng = np.random.default_rng(L)
    chunks = torch.from_numpy(rng.integers(0, 256, (64, L), dtype=np.uint8))
    got = hh256_gpu.hash_chunks(chunks.to(cuda_device)).cpu()
    assert torch.equal(got, hh256_gpu.hash_chunks_plain(chunks))
    # Rows that start at odd addresses (a view with row stride L + 3).
    wide = torch.from_numpy(rng.integers(0, 256, (8, L + 3),
                                         dtype=np.uint8))
    view = wide.to(cuda_device)[:, 1:L + 1]
    assert torch.equal(hh256_gpu.hash_chunks(view).cpu(),
                       hh256_gpu.hash_chunks_plain(wide[:, 1:L + 1]))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 15, 17, 37])
def test_kernel_every_row_offset(cuda_device, B):
    """Row starts at every offset mod 16 and batches that are not a
    multiple of the block's 16 chains."""
    rng = np.random.default_rng(B)
    L = 32 * 40 + 13
    wide = torch.from_numpy(rng.integers(0, 256, (B, L + 16),
                                         dtype=np.uint8))
    dev = wide.to(cuda_device)
    for off in range(16):
        assert torch.equal(hh256_gpu.hash_chunks(dev[:, off:off + L]).cpu(),
                           hh256_gpu.hash_chunks_plain(wide[:, off:off + L]))
