"""AWS event-stream framing for SelectObjectContent responses (ref
pkg/s3select/message.go — same binary protocol: 4-byte total length,
4-byte headers length, 4-byte prelude CRC32, headers, payload, 4-byte
message CRC32; headers are (name-len, name, type=7, value-len, value)).

The port's own copy of ``minio_tpu/s3select/message.py``, with no change in
behaviour.
"""

from __future__ import annotations

import struct
import zlib


def _header(name: str, value: str) -> bytes:
    nb = name.encode()
    vb = value.encode()
    return (bytes([len(nb)]) + nb + b"\x07"
            + struct.pack(">H", len(vb)) + vb)


def encode_message(headers: list[tuple[str, str]], payload: bytes) -> bytes:
    hdr = b"".join(_header(n, v) for n, v in headers)
    total = 16 + len(hdr) + len(payload)
    prelude = struct.pack(">II", total, len(hdr))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + hdr + payload
    return body + struct.pack(">I", zlib.crc32(body))


def records_message(payload: bytes) -> bytes:
    return encode_message(
        [(":message-type", "event"), (":event-type", "Records"),
         (":content-type", "application/octet-stream")], payload)


def continuation_message() -> bytes:
    return encode_message(
        [(":message-type", "event"), (":event-type", "Cont")], b"")


def progress_message(scanned: int, processed: int, returned: int) -> bytes:
    xml = (f"<Progress><BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Progress>"
           ).encode()
    return encode_message(
        [(":message-type", "event"), (":event-type", "Progress"),
         (":content-type", "text/xml")], xml)


def stats_message(scanned: int, processed: int, returned: int) -> bytes:
    xml = (f"<Stats><BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Stats>").encode()
    return encode_message(
        [(":message-type", "event"), (":event-type", "Stats"),
         (":content-type", "text/xml")], xml)


def end_message() -> bytes:
    return encode_message(
        [(":message-type", "event"), (":event-type", "End")], b"")


def error_message(code: str, description: str) -> bytes:
    return encode_message(
        [(":message-type", "error"), (":error-code", code),
         (":error-message", description)], b"")


def decode_messages(stream: bytes) -> list[dict]:
    """Parse a response byte stream back into messages (client/test
    side). Returns [{"headers": {...}, "payload": bytes}, ...]."""
    out = []
    pos = 0
    while pos + 16 <= len(stream):
        total, hlen = struct.unpack_from(">II", stream, pos)
        (pcrc,) = struct.unpack_from(">I", stream, pos + 8)
        if zlib.crc32(stream[pos:pos + 8]) != pcrc:
            raise ValueError("prelude CRC mismatch")
        body = stream[pos:pos + total - 4]
        (mcrc,) = struct.unpack_from(">I", stream, pos + total - 4)
        if zlib.crc32(body) != mcrc:
            raise ValueError("message CRC mismatch")
        hdrs = {}
        hpos = pos + 12
        hend = hpos + hlen
        while hpos < hend:
            nlen = stream[hpos]
            hpos += 1
            name = stream[hpos:hpos + nlen].decode()
            hpos += nlen
            if stream[hpos] != 7:
                raise ValueError("unsupported header value type")
            hpos += 1
            (vlen,) = struct.unpack_from(">H", stream, hpos)
            hpos += 2
            hdrs[name] = stream[hpos:hpos + vlen].decode()
            hpos += vlen
        payload = stream[hend:pos + total - 4]
        out.append({"headers": hdrs, "payload": payload})
        pos += total
    return out
