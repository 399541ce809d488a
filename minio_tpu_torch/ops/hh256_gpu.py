"""HighwayHash-256 on the card: the bitrot checksum over many chunks at once.

Port of minio_tpu/ops/hh256_tpu.py. The hash is a serial chain per chunk,
so the batch is the parallelism: B equal-length chunks hash in lockstep,
two CUDA threads per chunk (one for each half of the native u64 state),
the chunk's bytes staged through shared memory ahead of the hash
(csrc/hh256.cu). The remainder packet (len % 32 bytes) is built inside
the kernel with the byte layout of ops/hh256.py ``_update_remainder``.

``hash_chunks`` runs where its input lies: on a CUDA tensor it launches
the kernel (or raises); on a CPU tensor it runs ``hash_chunks_plain``, the
reference's u32-pair chain written in int64 tensors masked to 32 bits
(mirroring hh256_tpu.py's ``_add64`` / ``_mul32x32`` / ``_update_lanes``).
"""

from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np
import torch

from . import _cuda
from .hh256 import _INIT0, _INIT1, MAGIC_KEY

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _swap32_int(x: int) -> int:
    return ((x & 0xFFFFFFFF) << 32) | (x >> 32)


@lru_cache(maxsize=8)
def _init_state_np(key: bytes) -> tuple[np.ndarray, ...]:
    """(v0lo, v0hi, v1lo, v1hi, mul0lo, mul0hi, mul1lo, mul1hi), each
    (4,) uint32 — the per-lane init vectors for this key (the kernel
    computes the same from the key words)."""
    kw = struct.unpack("<4Q", key)
    v0 = [_INIT0[i] ^ kw[i] for i in range(4)]
    v1 = [_INIT1[i] ^ _swap32_int(kw[i]) for i in range(4)]

    def split(vals):
        lo = np.array([v & 0xFFFFFFFF for v in vals], dtype=np.uint32)
        hi = np.array([v >> 32 for v in vals], dtype=np.uint32)
        return lo, hi

    return (*split(v0), *split(v1), *split(_INIT0), *split(_INIT1))


def _pack_remainder(tail: torch.Tensor, rem: int) -> torch.Tensor:
    """(B, rem) trailing bytes -> (B, 32) uint8 remainder packets, exactly
    hh256._update_remainder's byte layout (static given rem)."""
    B = tail.shape[0]
    size_mod4 = rem & 3
    remainder_off = rem & ~3
    packet = torch.zeros((B, 32), dtype=torch.uint8, device=tail.device)
    packet[:, :remainder_off] = tail[:, :remainder_off]
    if rem & 16:
        for i in range(4):
            packet[:, 28 + i] = tail[:, remainder_off + i + size_mod4 - 4]
    elif size_mod4:
        packet[:, 16] = tail[:, remainder_off]
        packet[:, 17] = tail[:, remainder_off + (size_mod4 >> 1)]
        packet[:, 18] = tail[:, remainder_off + size_mod4 - 1]
    return packet


# --- u64-as-u32-pair primitives in int64 tensors (exact, wrapping) -------------


def _add64(alo, ahi, blo, bhi):
    s = alo + blo
    return s & _M32, (ahi + bhi + (s >> 32)) & _M32


def _mul32x32(a, b):
    """Full 64-bit product of two u32 values -> (lo, hi)."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    m00, m01, m10, m11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    t = (m00 >> 16) + (m01 & _M16) + (m10 & _M16)
    lo = (m00 & _M16) | ((t << 16) & _M32)
    hi = (m11 + (m01 >> 16) + (m10 >> 16) + (t >> 16)) & _M32
    return lo, hi


def _byte64(lo, hi, idx: int):
    w = lo if idx < 4 else hi
    return (w >> (8 * (idx % 4))) & 0xFF


def _from_bytes64(byte_map):
    lo = hi = None
    for dest, b in byte_map:
        w = b << (8 * (dest % 4))
        if dest < 4:
            lo = w if lo is None else lo | w
        else:
            hi = w if hi is None else hi | w
    return lo, hi


def _zipper_lo(xlo, xhi, ylo, yhi):
    """hh256._zipper_merge_and_add's add[i0] term (x = its v0, y = v1)."""
    return _from_bytes64([
        (0, _byte64(xlo, xhi, 3)), (1, _byte64(ylo, yhi, 4)),
        (3, _byte64(xlo, xhi, 5)), (4, _byte64(ylo, yhi, 6)),
        (2, _byte64(xlo, xhi, 2)), (5, _byte64(xlo, xhi, 1)),
        (6, _byte64(ylo, yhi, 7)), (7, _byte64(xlo, xhi, 0)),
    ])


def _zipper_hi(xlo, xhi, ylo, yhi):
    """hh256._zipper_merge_and_add's add[i1] term."""
    return _from_bytes64([
        (0, _byte64(ylo, yhi, 3)), (1, _byte64(xlo, xhi, 4)),
        (2, _byte64(ylo, yhi, 2)), (3, _byte64(ylo, yhi, 5)),
        (4, _byte64(ylo, yhi, 1)), (5, _byte64(xlo, xhi, 6)),
        (6, _byte64(ylo, yhi, 0)), (7, _byte64(xlo, xhi, 7)),
    ])


def _zip_add(src_lo, src_hi, dst_lo, dst_hi):
    xlo, xhi = src_lo[0::2], src_hi[0::2]          # lanes 0, 2
    ylo, yhi = src_lo[1::2], src_hi[1::2]          # lanes 1, 3
    e_lo, e_hi = _zipper_lo(xlo, xhi, ylo, yhi)    # -> dst lanes 0, 2
    o_lo, o_hi = _zipper_hi(xlo, xhi, ylo, yhi)    # -> dst lanes 1, 3
    add_lo = torch.stack([e_lo, o_lo], dim=1).reshape(dst_lo.shape)
    add_hi = torch.stack([e_hi, o_hi], dim=1).reshape(dst_hi.shape)
    return _add64(dst_lo, dst_hi, add_lo, add_hi)


def _update_lanes(st, plo, phi):
    """One 32-byte packet for all B chunks; st is 8 (4, B) tensors."""
    v0lo, v0hi, v1lo, v1hi, m0lo, m0hi, m1lo, m1hi = st
    tlo, thi = _add64(m0lo, m0hi, plo, phi)
    v1lo, v1hi = _add64(v1lo, v1hi, tlo, thi)
    qlo, qhi = _mul32x32(v1lo, v0hi)
    m0lo, m0hi = m0lo ^ qlo, m0hi ^ qhi
    v0lo, v0hi = _add64(v0lo, v0hi, m1lo, m1hi)
    qlo, qhi = _mul32x32(v0lo, v1hi)
    m1lo, m1hi = m1lo ^ qlo, m1hi ^ qhi
    v0lo, v0hi = _zip_add(v1lo, v1hi, v0lo, v0hi)
    v1lo, v1hi = _zip_add(v0lo, v0hi, v1lo, v1hi)
    return v0lo, v0hi, v1lo, v1hi, m0lo, m0hi, m1lo, m1hi


def _modular_reduction(a3lo, a3hi, a2lo, a2hi, a1lo, a1hi, a0lo, a0hi):
    """(m1lo, m1hi, m0lo, m0hi) per hh256._modular_reduction."""
    a3hi = a3hi & 0x3FFFFFFF
    m1lo = a1lo ^ (((a3lo << 1) & _M32) | (a2hi >> 31)) \
        ^ (((a3lo << 2) & _M32) | (a2hi >> 30))
    m1hi = a1hi ^ (((a3hi << 1) | (a3lo >> 31)) & _M32) \
        ^ (((a3hi << 2) | (a3lo >> 30)) & _M32)
    m0lo = a0lo ^ ((a2lo << 1) & _M32) ^ ((a2lo << 2) & _M32)
    m0hi = a0hi ^ (((a2hi << 1) | (a2lo >> 31)) & _M32) \
        ^ (((a2hi << 2) | (a2lo >> 30)) & _M32)
    return m1lo, m1hi, m0lo, m0hi


def _rot32(w, c: int):
    return w if c == 0 else ((w << c) & _M32) | (w >> (32 - c))


def _words(b: torch.Tensor) -> torch.Tensor:
    """(..., 4n) uint8 -> (..., n) little-endian u32 words in int64."""
    q = b.reshape(*b.shape[:-1], -1, 4).to(torch.int64)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)


def hash_chunks_plain(chunks: torch.Tensor,
                      key: bytes = MAGIC_KEY) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, L) uint8 -> (B, 32)."""
    B, L = chunks.shape
    dev = chunks.device
    n_full, rem = divmod(L, 32)
    init = [torch.from_numpy(v.astype(np.int64)).to(dev)[:, None]
            .expand(4, B) for v in _init_state_np(key)]
    st = tuple(init)
    if n_full:
        words = _words(chunks[:, :n_full * 32].reshape(B, n_full, 32))
        words = words.permute(1, 2, 0).contiguous()      # (n, 8, B)
        for i in range(n_full):
            st = _update_lanes(st, words[i, 0::2], words[i, 1::2])
    if rem:
        v0lo, v0hi, v1lo, v1hi = st[:4]
        v0lo, v0hi = _add64(v0lo, v0hi, rem, rem)
        st = (v0lo, v0hi, _rot32(v1lo, rem & 31), _rot32(v1hi, rem & 31),
              *st[4:])
        pkt = _words(_pack_remainder(chunks[:, n_full * 32:], rem)).T
        st = _update_lanes(st, pkt[0::2], pkt[1::2])
    perm = torch.tensor([2, 3, 0, 1], device=dev)
    for _ in range(10):
        # swap32 in pair form: the packet's lo word is v0's hi word.
        st = _update_lanes(st, st[1][perm], st[0][perm])
    v0lo, v0hi, v1lo, v1hi, m0lo, m0hi, m1lo, m1hi = st
    slo, shi = _add64(v1lo, v1hi, m1lo, m1hi)
    tlo, thi = _add64(v0lo, v0hi, m0lo, m0hi)
    h1lo, h1hi, h0lo, h0hi = _modular_reduction(
        slo[1], shi[1], slo[0], shi[0], tlo[1], thi[1], tlo[0], thi[0])
    h3lo, h3hi, h2lo, h2hi = _modular_reduction(
        slo[3], shi[3], slo[2], shi[2], tlo[3], thi[3], tlo[2], thi[2])
    words = torch.stack([h0lo, h0hi, h1lo, h1hi, h2lo, h2hi, h3lo, h3hi],
                        dim=1)                            # (B, 8)
    shifts = torch.tensor([0, 8, 16, 24], device=dev)
    return ((words[:, :, None] >> shifts) & 0xFF).reshape(B, 32).to(
        torch.uint8)


def hash_chunks_cuda(chunks: torch.Tensor, key: bytes) -> torch.Tensor:
    """Launch csrc/hh256.cu on (B, L) uint8 rows (unit stride along L,
    any row stride). Counts its launches."""
    if chunks.device.type != "cuda" or chunks.stride(1) != 1:
        raise ValueError("hash_chunks_cuda needs a CUDA (B, L) tensor with "
                         "unit stride along L")
    B, L = chunks.shape
    out = torch.empty((B, 32), dtype=torch.uint8, device=chunks.device)
    kw = struct.unpack("<4Q", key)
    lib = _cuda.build()
    rc = lib.hh256_launch(chunks.data_ptr(), chunks.stride(0), B, L, *kw,
                          out.data_ptr(), _cuda.stream_handle(chunks.device))
    _cuda.check(rc, "hh256")
    hash_chunks_cuda.launches += 1
    return out


hash_chunks_cuda.launches = 0


def hash_chunks(chunks: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """Hash B equal-length chunks where the tensor lies.

    chunks: (B, L) uint8 tensor, L > 0. Returns (B, 32) uint8 digests on
    the same device, byte-identical to ops/hh256.HighwayHash256."""
    if not isinstance(chunks, torch.Tensor):
        raise TypeError("chunks must be a torch.Tensor")
    if chunks.dim() != 2:
        raise ValueError("chunks must be (B, L)")
    if chunks.shape[1] == 0:
        raise ValueError("chunk length must be positive")
    if chunks.dtype != torch.uint8:
        raise ValueError("chunks must be uint8")
    if len(key) != 32:
        raise ValueError("HighwayHash key must be 32 bytes")
    if chunks.device.type == "cpu":
        return hash_chunks_plain(chunks, key)
    if chunks.device.type != "cuda":
        raise ValueError(f"unsupported device {chunks.device}")
    if chunks.stride(1) != 1:
        chunks = chunks.contiguous()
    return hash_chunks_cuda(chunks, key)
