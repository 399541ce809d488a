"""Raw snappy block format, pure Python (ref the reference's vendored
golang/snappy used by pkg/s3select/internal/parquet-go for page
decompression; format spec: google/snappy format_description.txt).

Parquet data pages use the RAW block format (no framing/stream
wrapper): a varint uncompressed length followed by literal/copy
elements. The decoder below handles every element type; the encoder is
a greedy 4-byte-hash matcher emitting literals and 2-byte-offset
copies — simple, always valid, and compresses repetitive data well
enough to exercise the copy paths in tests and produce real fixtures.

The port's own copy of ``minio_tpu/utils/snappy.py``, with no change in
behaviour.
"""

from __future__ import annotations


class SnappyError(ValueError):
    pass


def _uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise SnappyError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint overflow")


def decompress(buf: bytes) -> bytes:
    """Decode one raw snappy block."""
    want, pos = _uvarint(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                       # literal
            ln = tag >> 2
            if ln >= 60:                    # 60..63: extra length bytes
                nb = ln - 59
                if pos + nb > n:
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            ln += 1
            if pos + ln > n:
                raise SnappyError("truncated literal")
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                       # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise SnappyError("truncated copy-1")
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            ln = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            ln = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise SnappyError("copy offset out of range")
        start = len(out) - off
        if off >= ln:
            # Non-overlapping: the whole source range already exists —
            # one slice copy instead of ln appends.
            out += out[start:start + ln]
        else:
            # Overlapping copies repeat recent output byte-by-byte.
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != want:
        raise SnappyError(
            f"length mismatch: header {want}, decoded {len(out)}")
    return bytes(out)


def _emit_literal(out: bytearray, lit: memoryview | bytes) -> None:
    ln = len(lit) - 1
    if ln < 60:
        out.append(ln << 2)
    else:
        nb = (ln.bit_length() + 7) // 8
        out.append((59 + nb) << 2)
        out += ln.to_bytes(nb, "little")
    out += lit


def compress(data: bytes) -> bytes:
    """Encode one raw snappy block (literals + 2-byte-offset copies)."""
    n = len(data)
    out = bytearray()
    ln = n
    while True:                             # uvarint(len)
        b = ln & 0x7F
        ln >>= 7
        out.append(b | (0x80 if ln else 0))
        if not ln:
            break
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    pos = lit_start = 0
    while pos + 4 <= n:
        key = data[pos:pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is None or pos - cand > 0xFFFF:
            pos += 1
            continue
        # Extend the 4-byte match as far as it goes (cap 64/element).
        length = 4
        while (pos + length < n and length < 64
               and data[cand + length] == data[pos + length]):
            length += 1
        if lit_start < pos:
            _emit_literal(out, data[lit_start:pos])
        out.append(((length - 1) << 2) | 2)
        out += (pos - cand).to_bytes(2, "little")
        pos += length
        lit_start = pos
    if lit_start < n:
        _emit_literal(out, data[lit_start:])
    return bytes(out)
