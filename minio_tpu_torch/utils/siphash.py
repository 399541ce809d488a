"""SipHash-2-4 (64-bit) — object→set placement hash.

The reference places objects onto erasure sets with
`siphash.Sum64(key) % numSets`, keyed by the deployment ID
(ref cmd/erasure-sets.go:623 sipHashMod, dchest/siphash). Pure Python:
placement is one hash per object operation, nowhere near the data plane.

The port's own copy of ``minio_tpu/utils/siphash.py``, with no change in
behaviour.
"""

from __future__ import annotations

import struct

M = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & M


def siphash24(key: bytes, data: bytes) -> int:
    """SipHash-2-4 64-bit output, little-endian key/data."""
    if len(key) != 16:
        raise ValueError("siphash key must be 16 bytes")
    k0, k1 = struct.unpack("<QQ", key)
    v0 = 0x736F6D6570736575 ^ k0
    v1 = 0x646F72616E646F6D ^ k1
    v2 = 0x6C7967656E657261 ^ k0
    v3 = 0x7465646279746573 ^ k1

    def rounds(n: int) -> None:
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & M
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & M
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & M
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & M
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)

    b = len(data) & 0xFF
    end = len(data) - (len(data) % 8)
    for off in range(0, end, 8):
        m = struct.unpack_from("<Q", data, off)[0]
        v3 ^= m
        rounds(2)
        v0 ^= m
    last = b << 56
    tail = data[end:]
    for i, c in enumerate(tail):
        last |= c << (8 * i)
    v3 ^= last
    rounds(2)
    v0 ^= last
    v2 ^= 0xFF
    rounds(4)
    return (v0 ^ v1 ^ v2 ^ v3) & M


def sip_hash_mod(key: str, cardinality: int, deployment_id: bytes) -> int:
    """Object→set index (ref sipHashMod, cmd/erasure-sets.go:623)."""
    if cardinality <= 0:
        return -1
    return siphash24(deployment_id, key.encode("utf-8")) % cardinality
