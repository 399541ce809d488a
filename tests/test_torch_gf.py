"""GF(2^8) host math and the GF kernel's plain version, held to the JAX
package byte for byte (Pallas kernel in interpret mode, the XLA bit-plane
path, and the numpy golden codec). Data is made with numpy from a seed."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import gf256 as ref_gf256
from minio_tpu.ops import rs_cpu as ref_rs_cpu
from minio_tpu.ops import rs_matrix as ref_rs_matrix
from minio_tpu.ops import rs_pallas, rs_tpu
from minio_tpu_torch.ops import gf256, rs_cpu, rs_gpu, rs_matrix

# tests/test_golden.py PARITY_PINS: (k, m) -> (sha256 of the parity bytes,
# first 16 bytes of the first parity shard) over pattern(65536).
PARITY_PINS = {
    (8, 4): ("349e8c4a461aecda6c983f13d6f0b3876c453a7ed72ed630d6e28d67d01daa37",
             "9c48c8a6f7566e2b9c5d12613df1b137"),
    (12, 4): ("5c7a06df5c73f68cf4a968e93b8609f0fcc0b09b950cc2f8f443acadf506dada",
              "eca6e1f7a622ee2ddde01b6822a2be3c"),
    (16, 4): ("63bd6b9f75a714259b8e17e560c7c3eeb5b6f3965e2143f65312bad614f6510a",
              "185d9b544ca58a06effd9176c41df84e"),
}

CPU = torch.device("cpu")


def pattern(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    return ((i * 131 + 17) % 251).astype(np.uint8)


def _plain(bm: np.ndarray, data: np.ndarray) -> np.ndarray:
    return rs_gpu.gf_apply(bm, torch.from_numpy(data)).numpy()


def _pallas(bm: np.ndarray, data: np.ndarray) -> np.ndarray:
    return np.asarray(rs_pallas.gf_apply(bm, data, interpret=True))


def _xla(bm: np.ndarray, data: np.ndarray) -> np.ndarray:
    return np.asarray(rs_tpu._gf_apply_xla(jnp.asarray(bm),
                                           jnp.asarray(data)))


@pytest.mark.parametrize("k,m", sorted(PARITY_PINS))
def test_matrices_equal_reference(k, m):
    assert np.array_equal(rs_matrix.parity_matrix(k, m),
                          ref_rs_matrix.parity_matrix(k, m))
    assert np.array_equal(
        gf256.gf_matrix_to_bitplane(rs_matrix.parity_matrix(k, m)),
        ref_gf256.gf_matrix_to_bitplane(ref_rs_matrix.parity_matrix(k, m)))
    assert np.array_equal(rs_gpu.parity_bitplane(k, m),
                          rs_tpu.parity_bitplane(k, m))
    missing = (0, 3, k + 1)
    avail = tuple(i for i in range(k + m) if i not in missing)
    got, used = rs_matrix.any_decode_matrix(k, m, avail, missing)
    want, ref_used = ref_rs_matrix.any_decode_matrix(k, m, avail, missing)
    assert np.array_equal(got, want) and used == ref_used
    assert np.array_equal(rs_gpu.any_decode_bitplane(k, m, avail, missing)[0],
                          rs_tpu.any_decode_bitplane(k, m, avail, missing)[0])


@pytest.mark.parametrize("k,m", [(4, 2), (8, 4), (16, 4)])
def test_plain_equals_pallas_and_xla(k, m):
    """tests/test_rs_pallas.py::test_encode_byte_identity's inputs."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (2, k, 384)).astype(np.uint8)
    bm = rs_tpu.parity_bitplane(k, m)
    got = _plain(bm, data)
    assert np.array_equal(got, _pallas(bm, data))
    assert np.array_equal(got, _xla(bm, data))


@pytest.mark.parametrize("k", list(range(1, 17)) + [20, 37])
def test_plain_every_k_equals_xla(k):
    """Every k a set uses, and k > 16 (more than two u64 mask words)."""
    m = 3
    rng = np.random.default_rng(100 + k)
    data = rng.integers(0, 256, (2, k, 131)).astype(np.uint8)
    bm = rs_tpu.parity_bitplane(k, m)
    assert np.array_equal(_plain(bm, data), _xla(bm, data))


def test_plain_small_and_2d():
    rng = np.random.default_rng(1)
    k, m = 4, 2
    bm = rs_tpu.parity_bitplane(k, m)
    for S in (1, 37, 128):
        data = rng.integers(0, 256, (k, S)).astype(np.uint8)
        got = _plain(bm, data)
        assert got.shape == (m, S)
        assert np.array_equal(got, _pallas(bm, data)), S


def test_plain_across_tile_seam():
    rng = np.random.default_rng(6)
    k, m = 4, 2
    S = rs_pallas._tile_for(m, k, 10**9) + 130
    data = rng.integers(0, 256, (1, k, S)).astype(np.uint8)
    bm = rs_tpu.parity_bitplane(k, m)
    assert np.array_equal(_plain(bm, data), _pallas(bm, data))


def test_plain_reconstruct():
    rng = np.random.default_rng(2)
    k, m, S = 8, 4, 260
    missing = (0, 5, k + 1)
    avail = tuple(i for i in range(k + m) if i not in missing)
    bm, used = rs_tpu.any_decode_bitplane(k, m, avail, missing)
    data = rng.integers(0, 256, (3, k, S)).astype(np.uint8)
    full = rs_gpu.encode_batch(data, k, m, device="cpu")
    survivors = full[:, list(used)]
    got = _plain(bm, survivors)
    assert np.array_equal(got, full[:, list(missing)])
    assert np.array_equal(got, _pallas(bm, survivors))
    data_missing = (0, 5)
    avail = tuple(i for i in range(k + m) if i not in data_missing)
    used = rs_tpu.decode_bitplane(k, m, avail, data_missing)[1]
    assert np.array_equal(
        rs_gpu.reconstruct_batch(full[:, used], k, m, avail, data_missing,
                                 device="cpu"),
        rs_tpu.reconstruct_batch(full[:, used], k, m, avail, data_missing))


def test_encode_blocks_layouts():
    """Batch-major and shard-major encode equal the reference's
    encode_blocks (data then parity)."""
    rng = np.random.default_rng(3)
    k, m = 8, 4
    data = rng.integers(0, 256, (3, k, 97)).astype(np.uint8)
    want = np.asarray(rs_tpu._encode_blocks_xla(
        jnp.asarray(rs_tpu.parity_bitplane(k, m)), jnp.asarray(data)))
    assert np.array_equal(rs_gpu.encode_batch(data, k, m, device="cpu"),
                          want)
    assert np.array_equal(
        rs_gpu.encode_batch_shardmajor(data, k, m, device="cpu"),
        want.transpose(1, 0, 2))


@pytest.mark.parametrize("k,m", sorted(PARITY_PINS))
def test_golden_parity_pins(k, m):
    data = pattern(65536)
    shards = rs_cpu.split(data, k, m)
    out = rs_gpu.encode_batch(shards[None, :k], k, m, device="cpu")[0]
    sha, first16 = PARITY_PINS[(k, m)]
    assert hashlib.sha256(out[k:].tobytes()).hexdigest() == sha
    assert out[k, :16].tobytes().hex() == first16
    assert np.array_equal(out, ref_rs_cpu.encode_data(data.tobytes(), k, m))


def test_rs_cpu_oracle_equals_reference():
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, 1000).astype(np.uint8).tobytes()
    k, m = 5, 3
    got = rs_cpu.encode_data(payload, k, m)
    assert np.array_equal(got, ref_rs_cpu.encode_data(payload, k, m))
    damaged = [None if i in (0, 2, 6) else got[i].copy()
               for i in range(k + m)]
    fixed = rs_cpu.reconstruct_data(damaged, k, m)
    assert rs_cpu.join(np.stack(fixed[:k]), k, len(payload)) == payload


def test_pack_bitplane_layout():
    """Word [j*8 + a, i] holds, in all four bytes, the bits of output byte
    i that bit a of input byte j feeds; columns past r are zero."""
    k, m = 11, 2
    bm = rs_gpu.parity_bitplane(k, m)
    packed = rs_gpu.pack_bitplane(bm).view(np.uint32)
    assert packed.shape == (8 * k, 4)
    assert not packed[:, m:].any()
    for col in range(8 * k):
        for i in range(m):
            word = int(packed[col, i])
            byte = word & 0xFF
            assert word == byte * 0x01010101
            for b in range(8):
                assert (byte >> b) & 1 == int(bm[i * 8 + b, col])


# --- a numpy model of csrc/gf_apply.cu's arithmetic ---------------------------


def _sign_bytes(y: np.ndarray) -> np.ndarray:
    """PRMT with selector 0xBA98: each byte of y becomes 0xFF when its bit
    7 is set, else 0."""
    out = np.zeros_like(y)
    for q in range(4):
        bit = (y >> np.uint32(8 * q + 7)) & np.uint32(1)
        out |= (bit * np.uint32(0xFF)) << np.uint32(8 * q)
    return out


def _model_gf_apply(big_m: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The kernel's scheme on (B, k, S) uint8: columns packed four to a
    u32 word (S padded to the thread's 16 columns), M_{j,a} = bit a of
    every byte as a full-byte mask, out_i ^= M_{j,a} & C[j*8 + a, i], in
    passes of up to 8 output rows. Returns (B, r, S)."""
    ctab = rs_gpu.pack_bitplane(big_m).view(np.uint32)
    r = big_m.shape[0] // 8
    B, k, S = data.shape
    x = np.zeros((B, k, -(-S // 16) * 16), np.uint8)
    x[..., :S] = data
    w = x.view("<u4")
    out = np.zeros((B, r, w.shape[-1]), np.uint32)
    for i0 in range(0, r, 8):
        for j in range(k):
            for a in range(8):
                m = _sign_bytes(w[:, j] << np.uint32(7 - a))
                for i in range(i0, min(r, i0 + 8)):
                    out[:, i] ^= m & ctab[j * 8 + a, i]
    return out.view(np.uint8)[..., :S]


def _jax_gf_apply(bm: np.ndarray, data: np.ndarray) -> np.ndarray:
    return np.asarray(rs_tpu.gf_apply(jnp.asarray(bm), jnp.asarray(data)))


@pytest.mark.parametrize("k,m,S", [(2, 1, 1), (4, 2, 37), (8, 4, 160),
                                   (12, 4, 131), (16, 4, 15), (20, 3, 33),
                                   (40, 5, 47)])
def test_model_parity_equals_jax(k, m, S):
    rng = np.random.default_rng(200 + k)
    data = rng.integers(0, 256, (2, k, S)).astype(np.uint8)
    bm = rs_tpu.parity_bitplane(k, m)
    assert np.array_equal(_model_gf_apply(bm, data), _jax_gf_apply(bm, data))


@pytest.mark.parametrize("k,m", [(8, 4), (12, 4), (40, 5)])
def test_model_decode_equals_jax(k, m):
    rng = np.random.default_rng(300 + k)
    missing = (0, 5, k + 1)
    avail = tuple(i for i in range(k + m) if i not in missing)
    bm, used = rs_tpu.any_decode_bitplane(k, m, avail, missing)
    data = rng.integers(0, 256, (2, k, 53)).astype(np.uint8)
    full = rs_gpu.encode_batch(data, k, m, device="cpu")
    got = _model_gf_apply(bm, full[:, list(used)])
    assert np.array_equal(got, full[:, list(missing)])
    assert np.array_equal(got, _jax_gf_apply(bm, full[:, list(used)]))


@pytest.mark.parametrize("r,k", [(1, 3), (9, 5), (12, 40), (17, 2)])
def test_model_any_bitplane_matrix_equals_jax(r, k):
    """Exact for any 0/1 matrix, r > 8 (several passes) included."""
    rng = np.random.default_rng(400 + r)
    bm = rng.integers(0, 2, (8 * r, 8 * k)).astype(np.float32)
    data = rng.integers(0, 256, (3, k, 29)).astype(np.uint8)
    want = _jax_gf_apply(bm, data)
    assert np.array_equal(_model_gf_apply(bm, data), want)
    assert np.array_equal(_plain(bm, data), want)


def test_plain_rejects_wrong_k():
    bm = rs_tpu.parity_bitplane(4, 2)
    with pytest.raises(ValueError):
        rs_gpu.gf_apply(bm, torch.zeros((3, 10), dtype=torch.uint8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 4), (12, 4), (16, 4),
                                 (20, 3), (40, 5)])
def test_kernel_equals_plain(cuda_device, k, m):
    rng = np.random.default_rng(k)
    bm = rs_gpu.placed_parity(k, m, cuda_device)
    for S in (1, 127, 4097, 4112, 873814):
        x = torch.from_numpy(rng.integers(0, 256, (3, k, S),
                                          dtype=np.uint8))
        want = rs_gpu.encode_blocks(rs_gpu.placed_parity(k, m, CPU), x)
        got = rs_gpu.encode_blocks(bm, x.to(cuda_device)).cpu()
        assert torch.equal(got, want), (k, m, S)
        got = rs_gpu.encode_blocks_shardmajor(bm, x.to(cuda_device)).cpu()
        assert torch.equal(got, want.transpose(0, 1)), (k, m, S)


@pytest.mark.gpu
@pytest.mark.parametrize("off", [0, 1, 4, 8])
def test_kernel_unaligned_rows_and_decode(cuda_device, off):
    """Row starts that are not 16-byte aligned (a view at an offset) and a
    decode matrix; a random 0/1 matrix with r > 8."""
    rng = np.random.default_rng(50 + off)
    k, m, S = 12, 4, 4096
    wide = torch.from_numpy(rng.integers(0, 256, (2, k, S + 16),
                                         dtype=np.uint8))
    x = wide[:, :, off:off + S]
    bm = rs_gpu.placed_parity(k, m, cuda_device)
    want = rs_gpu.gf_apply_plain(bm.dense.cpu(), x)
    assert torch.equal(rs_gpu.gf_apply(bm, x.to(cuda_device)).cpu(), want)
    missing = (0, 5, 13)
    avail = tuple(i for i in range(k + m) if i not in missing)
    dm, used = rs_gpu.placed_any_decode(k, m, avail, missing, cuda_device)
    full = rs_gpu.encode_blocks(bm, wide.to(cuda_device))
    got = rs_gpu.gf_apply(dm, full[:, list(used), off:off + S])
    assert torch.equal(got, full[:, list(missing), off:off + S])
    big = rng.integers(0, 2, (8 * 12, 8 * 5)).astype(np.float32)
    y = wide[:, :5, off:off + S]
    assert torch.equal(rs_gpu.gf_apply(big, y.to(cuda_device)).cpu(),
                       rs_gpu.gf_apply(big, y))
