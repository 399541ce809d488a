"""Reed-Solomon on the card: GF(2^8) linear maps as GF(2) bit-plane products.

Port of minio_tpu/ops/rs_tpu.py and ops/rs_pallas.py. An (r, k) GF(2^8)
matrix lowers to an (8r, 8k) 0/1 matrix over GF(2)
(gf256.gf_matrix_to_bitplane); applying it to shard bytes is one kernel
launch (csrc/gf_apply.cu) that serves encode, reconstruct and heal — only
the matrix differs. The matrix is a run-time argument, packed once per
(k, m) or (k, m, available, missing) into the kernel's C words and cached
per device (the counterpart of rs_tpu._placed_parity / _placed_any_decode).

Every function that takes a tensor runs where the tensor lies: on a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it runs the
plain PyTorch version ``gf_apply_plain``. The reference's
disable-Pallas-and-fall-back-to-XLA policy is deliberately not carried
over. The host API (``encode_batch`` & co.) takes numpy arrays and an
explicit ``device``, default the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _cuda
from .gf256 import gf_matrix_to_bitplane
from .rs_matrix import any_decode_matrix, decode_matrix, parity_matrix

# --- host-side matrix prep ----------------------------------------------------


@lru_cache(maxsize=None)
def parity_bitplane(k: int, m: int) -> np.ndarray:
    """(8m, 8k) float32 0/1 bit-plane matrix generating parity."""
    return gf_matrix_to_bitplane(parity_matrix(k, m)).astype(np.float32)


@lru_cache(maxsize=1024)
def decode_bitplane(k: int, m: int, available: tuple[int, ...],
                    missing: tuple[int, ...]) -> tuple[np.ndarray, list[int]]:
    """Bit-plane matrix rebuilding `missing` data shards from survivors.

    Returns (bitplane_matrix (8*len(missing), 8k), used_shard_indices).
    """
    dec, used = decode_matrix(k, m, list(available))
    rows = dec[list(missing), :]
    return gf_matrix_to_bitplane(rows).astype(np.float32), used


@lru_cache(maxsize=1024)
def any_decode_bitplane(k: int, m: int, available: tuple[int, ...],
                        missing: tuple[int, ...],
                        ) -> tuple[np.ndarray, tuple[int, ...]]:
    """Bit-plane matrix rebuilding arbitrary missing shards (data and
    parity) from survivors (see rs_matrix.any_decode_matrix)."""
    mat, used = any_decode_matrix(k, m, available, missing)
    return gf_matrix_to_bitplane(mat).astype(np.float32), used


def pack_bitplane(big_m) -> np.ndarray:
    """(8r, 8k) 0/1 matrix -> (8k, r rounded up to 4) int32 C words.

    Word [j*8 + a, i] holds, in each of its four bytes, the byte
    sum_b big_m[i*8 + b, j*8 + a] << b: the bits of output byte i that
    bit a of input byte j feeds. The kernel ANDs it with the full-byte
    mask of bit a of four input columns and XORs the result into output
    row i (csrc/gf_apply.cu); columns past r are zero."""
    bits = (np.asarray(big_m) != 0).astype(np.uint32)
    rows, cols = bits.shape
    if cols % 8 or rows % 8:
        raise ValueError(f"bit-plane matrix shape {bits.shape} is not "
                         "(8r, 8k)")
    r = rows // 8
    weights = (1 << np.arange(8, dtype=np.uint32))[None, :, None]
    col_bytes = (bits.reshape(r, 8, cols) * weights).sum(axis=1)  # (r, 8k)
    out = np.zeros((cols, -(-r // 4) * 4), dtype=np.uint32)
    out[:, :r] = col_bytes.T * np.uint32(0x01010101)
    return out.view(np.int32)


class BitMatrix:
    """A bit-plane matrix placed on one device: the dense float32 form the
    plain version multiplies with and the packed C words the kernel
    reads (``pack_bitplane``)."""

    __slots__ = ("dense", "packed", "r", "k")

    def __init__(self, dense: torch.Tensor, packed: torch.Tensor):
        self.dense = dense
        self.packed = packed
        self.r = dense.shape[0] // 8
        self.k = dense.shape[1] // 8

    @classmethod
    def from_numpy(cls, big_m, device) -> "BitMatrix":
        dev = torch.device(device)
        dense = np.asarray(big_m, dtype=np.float32)
        return cls(torch.from_numpy(dense.copy()).to(dev),
                   torch.from_numpy(pack_bitplane(dense)).to(dev))

    @property
    def device(self) -> torch.device:
        return self.dense.device

    def to(self, device) -> "BitMatrix":
        return BitMatrix(self.dense.to(device), self.packed.to(device))


def as_bitmatrix(big_m, device) -> BitMatrix:
    """A BitMatrix on ``device`` from a BitMatrix, tensor or array."""
    dev = torch.device(device)
    if isinstance(big_m, BitMatrix):
        return big_m if big_m.device == dev else big_m.to(dev)
    if isinstance(big_m, torch.Tensor):
        big_m = big_m.detach().cpu().numpy()
    return BitMatrix.from_numpy(big_m, dev)


@lru_cache(maxsize=1024)
def placed_parity(k: int, m: int, device: torch.device) -> BitMatrix:
    """parity_bitplane placed on ``device`` once (the hot PUT path never
    re-packs or re-transfers the matrix)."""
    return BitMatrix.from_numpy(parity_bitplane(k, m), device)


@lru_cache(maxsize=1024)
def placed_decode(k: int, m: int, available: tuple[int, ...],
                  missing: tuple[int, ...], device: torch.device,
                  ) -> tuple[BitMatrix, list[int]]:
    bm, used = decode_bitplane(k, m, available, missing)
    return BitMatrix.from_numpy(bm, device), used


@lru_cache(maxsize=1024)
def placed_any_decode(k: int, m: int, available: tuple[int, ...],
                      missing: tuple[int, ...], device: torch.device,
                      ) -> tuple[BitMatrix, tuple[int, ...]]:
    bm, used = any_decode_bitplane(k, m, available, missing)
    return BitMatrix.from_numpy(bm, device), used


# --- the kernel and its plain version ------------------------------------------

# Columns per pass of the plain version: bounds its float32 bit planes to
# 8k * _PLAIN_COLS * 4 bytes.
_PLAIN_COLS = 1 << 22


def gf_apply_plain(big_m: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: unpack bits, float32 matmul,
    ``& 1``, pack. Exact: popcounts are <= 8k <= 2048 < 2^24.

    big_m: (8r, 8k) 0/1 tensor; shards: (..., k, S) uint8 on the same
    device. Returns (..., r, S) uint8."""
    r, k = big_m.shape[0] // 8, big_m.shape[1] // 8
    lead, S = shards.shape[:-2], shards.shape[-1]
    dev = shards.device
    x = shards.reshape(-1, k, S)
    B = x.shape[0]
    cols = x.permute(1, 0, 2).reshape(k, B * S)
    m = big_m.to(device=dev, dtype=torch.float32)
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    weights = torch.arange(8, device=dev, dtype=torch.int32)
    out = torch.empty((r, B * S), dtype=torch.uint8, device=dev)
    step = max(1, _PLAIN_COLS // (8 * k))
    for c0 in range(0, B * S, step):
        xs = cols[:, c0:c0 + step]
        n = xs.shape[1]
        bits = ((xs[:, None, :] >> shifts[None, :, None]) & 1)
        acc = m @ bits.reshape(8 * k, n).to(torch.float32)
        ob = (acc.to(torch.int32) & 1).reshape(r, 8, n)
        out[:, c0:c0 + n] = (ob << weights[None, :, None]).sum(
            dim=1).to(torch.uint8)
    return out.reshape(r, B, S).permute(1, 0, 2).reshape(*lead, r, S)


def gf_apply_cuda(bm: BitMatrix, x: torch.Tensor, out: torch.Tensor,
                  o_bstride: int, o_rstride: int, o_row0: int,
                  copy_data: bool) -> None:
    """Launch csrc/gf_apply.cu on x (B, k, S) uint8 (unit stride along S)
    into ``out`` at the given element strides. Counts its launches."""
    if x.device.type != "cuda" or out.device != x.device or \
            bm.device != x.device:
        raise ValueError("gf_apply_cuda needs x, out and the matrix on "
                         "one CUDA device")
    if x.dtype != torch.uint8 or out.dtype != torch.uint8 or \
            x.dim() != 3 or x.stride(2) != 1:
        raise ValueError("gf_apply_cuda needs (B, k, S) uint8 with unit "
                         "stride along S")
    B, k, S = x.shape
    if k != bm.k:
        raise ValueError(f"shards have k={k}, matrix has k={bm.k}")
    lib = _cuda.build()
    rc = lib.gf_apply_launch(
        x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), o_bstride,
        o_rstride, o_row0, int(copy_data), bm.packed.data_ptr(), bm.r,
        bm.k, B, S, _cuda.stream_handle(x.device))
    _cuda.check(rc, "gf_apply")
    gf_apply_cuda.launches += 1


gf_apply_cuda.launches = 0


def _norm(big_m, shards: torch.Tensor) -> tuple[BitMatrix, torch.Tensor]:
    if not isinstance(shards, torch.Tensor):
        raise TypeError("shards must be a torch.Tensor")
    if shards.dtype != torch.uint8 or shards.dim() < 2:
        raise ValueError("shards must be (..., k, S) uint8")
    if shards.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {shards.device}")
    bm = as_bitmatrix(big_m, shards.device)
    if shards.shape[-2] != bm.k:
        raise ValueError(
            f"shards sublane dim {shards.shape[-2]} != k={bm.k}")
    return bm, shards


def _batched(shards: torch.Tensor) -> torch.Tensor:
    x = shards.reshape(-1, shards.shape[-2], shards.shape[-1])
    return x if x.stride(2) == 1 else x.contiguous()


def gf_apply(big_m, shards: torch.Tensor) -> torch.Tensor:
    """Apply a bit-plane GF matrix to shard bytes.

    big_m: BitMatrix, or an (8r, 8k) 0/1 tensor/array (packed per call).
    shards: (..., k, S) uint8 tensor. Returns (..., r, S) uint8 on the
    same device."""
    bm, shards = _norm(big_m, shards)
    if shards.device.type == "cpu":
        return gf_apply_plain(bm.dense, shards)
    lead, S = shards.shape[:-2], shards.shape[-1]
    x = _batched(shards)
    out = torch.empty((x.shape[0], bm.r, S), dtype=torch.uint8,
                      device=shards.device)
    gf_apply_cuda(bm, x, out, bm.r * S, S, 0, False)
    return out.reshape(*lead, bm.r, S)


def encode_blocks(big_m, data: torch.Tensor) -> torch.Tensor:
    """(..., k, S) data -> (..., k+m, S) all shards (parity after data).
    On the card one launch writes both the data copy and the parity."""
    bm, data = _norm(big_m, data)
    k, r = bm.k, bm.r
    lead, S = data.shape[:-2], data.shape[-1]
    if data.device.type == "cpu":
        out = torch.empty((*lead, k + r, S), dtype=torch.uint8)
        out[..., :k, :] = data
        out[..., k:, :] = gf_apply_plain(bm.dense, data)
        return out
    x = _batched(data)
    out = torch.empty((x.shape[0], k + r, S), dtype=torch.uint8,
                      device=data.device)
    gf_apply_cuda(bm, x, out, (k + r) * S, S, k, True)
    return out.reshape(*lead, k + r, S)


def encode_blocks_shardmajor(big_m, data: torch.Tensor) -> torch.Tensor:
    """(B, k, S) data -> SHARD-MAJOR (k+m, B, S), the layout bitrot
    framing wants; on the card the kernel writes it directly."""
    bm, data = _norm(big_m, data)
    if data.dim() != 3:
        raise ValueError("encode_blocks_shardmajor expects (B, k, S)")
    k, r = bm.k, bm.r
    B, _, S = data.shape
    if data.device.type == "cpu":
        out = torch.empty((k + r, B, S), dtype=torch.uint8)
        out[:k] = data.transpose(0, 1)
        out[k:] = gf_apply_plain(bm.dense, data).transpose(0, 1)
        return out
    x = _batched(data)
    out = torch.empty((k + r, B, S), dtype=torch.uint8, device=data.device)
    gf_apply_cuda(bm, x, out, S, B * S, k, True)
    return out


# --- convenience host API -----------------------------------------------------


def encode_batch(data: np.ndarray, k: int, m: int,
                 device="cuda") -> np.ndarray:
    """Encode a (B, k, S) or (k, S) uint8 batch on ``device``; returns
    numpy (B, k+m, S) / (k+m, S)."""
    dev = _cuda.resolve_device(device)
    x = _cuda.to_device(data, dev)
    return encode_blocks(placed_parity(k, m, dev), x).cpu().numpy()


def encode_batch_shardmajor(data: np.ndarray, k: int, m: int,
                            device="cuda") -> np.ndarray:
    """Encode (B, k, S) on ``device``; returns numpy (k+m, B, S)."""
    dev = _cuda.resolve_device(device)
    x = _cuda.to_device(data, dev)
    return encode_blocks_shardmajor(placed_parity(k, m, dev),
                                    x).cpu().numpy()


def reconstruct_batch(shards: np.ndarray, k: int, m: int,
                      available: tuple[int, ...],
                      missing: tuple[int, ...],
                      device="cuda") -> np.ndarray:
    """Rebuild `missing` data shards for a batch sharing one erasure mask.

    shards: (B, n_used, S) uint8 — ONLY the survivors actually used, i.e.
    the first k available in index order. Returns (B, len(missing), S)."""
    dev = _cuda.resolve_device(device)
    bm, used = placed_decode(k, m, tuple(available), tuple(missing), dev)
    if shards.shape[-2] != len(used):
        raise ValueError(
            f"expected {len(used)} survivor shards, got {shards.shape[-2]}")
    return gf_apply(bm, _cuda.to_device(shards, dev)).cpu().numpy()
