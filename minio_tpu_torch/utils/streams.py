"""Streaming primitives for the O(block)-memory data plane.

The reference keeps memory O(block) for unbounded objects by striping
every PUT/GET through fixed 10MiB blocks (ref Erasure.Encode loop,
cmd/erasure-encode.go:73-109; blockwise decode cmd/erasure-decode.go:
248-263). These helpers give every layer a common reader shape so the
handler, the engine, and the storage layer pass chunks — never whole
objects — between each other.

The port's own copy of ``minio_tpu/utils/streams.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Iterator

# How many stripe blocks one device dispatch encodes (bounds PUT-path
# memory at ~batch_bytes * (k+m)/k while keeping TPU batches dense).
DEFAULT_BATCH_BYTES = 32 * 1024 * 1024

# PUT-pipeline batch: one producer item of the bounded encode/write
# pipeline (utils/pipeline.py). Smaller than DEFAULT_BATCH_BYTES so a
# large part splits into several batches that actually overlap (encode
# N+1 while N's shards fan out), while one batch still clears the
# device-dispatch threshold (erasure/codec.TPU_MIN_BYTES) — and peak
# PUT memory drops to ~(depth+1) × PUT_BATCH_BYTES × (k+m)/k.
PUT_BATCH_BYTES = 8 * 1024 * 1024


class Reader:
    """Minimal pull interface: read(n) -> up to n bytes, b'' at EOF."""

    def read(self, n: int) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError


class BytesReader(Reader):
    def __init__(self, data: bytes):
        self._view = memoryview(data)
        self._pos = 0

    def read(self, n: int) -> bytes:
        chunk = self._view[self._pos:self._pos + n]
        self._pos += len(chunk)
        return bytes(chunk)


class IterReader(Reader):
    """Adapts an iterator of chunks to read(n)."""

    def __init__(self, it: Iterable[bytes]):
        self._it = iter(it)
        self._buf = bytearray()
        self._eof = False

    def read(self, n: int) -> bytes:
        while len(self._buf) < n and not self._eof:
            try:
                self._buf += next(self._it)
            except StopIteration:
                self._eof = True
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class LimitReader(Reader):
    """Caps a file-like object at `limit` bytes (an HTTP body whose
    socket stays open past Content-Length).

    Reads are atomic (one lock): when a pipelined PUT fails mid-stream,
    the server's keep-alive drain loop may briefly overlap with the
    pipeline worker finishing its current batch read — serialized reads
    keep the byte accounting (and therefore the connection framing)
    exact no matter which thread consumes the remainder."""

    def __init__(self, f, limit: int):
        import threading
        self._f = f
        self._left = limit
        self._mu = threading.Lock()

    def read(self, n: int) -> bytes:
        with self._mu:
            if self._left <= 0:
                return b""
            chunk = self._f.read(min(n, self._left))
            self._left -= len(chunk)
            return chunk

    def remaining(self) -> int:
        """Bytes of the capped window not yet consumed — the front
        door's keep-alive hygiene reads this to decide drain vs close
        for an abandoned body."""
        with self._mu:
            return self._left


class ChunkedTEReader(Reader):
    """Incremental ``Transfer-Encoding: chunked`` decoder over a
    blocking socket file (the threaded front door's ``rfile``): read(n)
    returns DECODED payload bytes, b'' once the terminal 0-chunk and
    trailer section have been consumed. The async front door decodes
    the same framing loop-side (`s3/asyncserver._ChunkedTEParser`);
    this is its pull-model twin so both doors accept chunked bodies.

    Framing errors raise ValueError; exceeding `max_decoded` raises
    ChunkedTooLarge (a ValueError) so the caller can answer 413 vs 400.
    remaining() is 0 only after clean EOF — an abandoned chunked body
    has no byte count to drain by, so keep-alive hygiene must close."""

    MAX_LINE = 8192          # chunk-size line incl. extensions
    MAX_TRAILER = 16 * 1024  # total trailer-section bytes

    def __init__(self, f, max_decoded: int = -1):
        self._f = f
        self._left = 0        # payload bytes left in current chunk
        self._need_crlf = False
        self._done = False
        self._decoded = 0
        self._max = max_decoded

    def _read_line(self) -> bytes:
        line = self._f.readline(self.MAX_LINE + 2)
        if not line:
            raise ValueError("chunked body: EOF inside framing")
        if not line.endswith(b"\n"):
            raise ValueError("chunked body: framing line too long")
        return line.strip(b"\r\n")

    def _consume_crlf(self) -> None:
        b = self._f.read(1)
        if b == b"\r":
            b = self._f.read(1)
        if b != b"\n":
            raise ValueError("chunked body: missing CRLF after chunk")

    def _next_chunk(self) -> None:
        line = self._read_line()
        size_s = line.split(b";", 1)[0].strip()
        try:
            size = int(size_s, 16)
        except ValueError:
            raise ValueError(
                f"chunked body: bad chunk size {size_s[:32]!r}") from None
        if size == 0:
            total = 0
            while True:
                t = self._read_line()
                if not t:
                    break
                total += len(t)
                if total > self.MAX_TRAILER:
                    raise ValueError("chunked body: trailer too large")
            self._done = True
            return
        if self._max >= 0 and self._decoded + size > self._max:
            raise ChunkedTooLarge("chunked body exceeds size cap")
        self._left = size

    def read(self, n: int) -> bytes:
        if self._done or n <= 0:
            return b""
        while self._left == 0:
            if self._need_crlf:
                self._consume_crlf()
                self._need_crlf = False
            self._next_chunk()
            if self._done:
                return b""
        take = min(n, self._left)
        data = self._f.read(take)
        if len(data) < take:
            raise ValueError("chunked body: EOF inside chunk data")
        self._left -= take
        self._decoded += take
        if self._left == 0:
            self._need_crlf = True
        return data

    def remaining(self) -> int:
        return 0 if self._done else 1


class ChunkedTooLarge(ValueError):
    """Decoded chunked body crossed the caller's cap (413, not 400)."""


class PushbackReader(Reader):
    """Prepends already-consumed bytes back onto an inner reader (the
    one-byte lookahead the PUT pipeline uses to tell a final
    exactly-full batch from a continuing stream)."""

    def __init__(self, head: bytes, inner: Reader):
        self._head = head
        self._inner = inner

    def read(self, n: int) -> bytes:
        if self._head:
            out = bytes(self._head[:n])
            self._head = self._head[n:]
            return out
        return self._inner.read(n)


class HashingReader(Reader):
    """Tees md5 (etag) + optional sha256 + size off a stream while the
    engine consumes it (ref pkg/hash/reader.go — verification happens at
    stream end, and a mismatch aborts the in-flight write)."""

    def __init__(self, inner: Reader, want_md5: bytes | None = None,
                 want_sha256: str = "", expect_size: int = -1):
        self.inner = inner
        self._md5 = hashlib.md5()
        self._sha = hashlib.sha256() if want_sha256 else None
        self.want_md5 = want_md5
        self.want_sha256 = want_sha256
        self.expect_size = expect_size
        self.size = 0

    def read(self, n: int) -> bytes:
        chunk = self.inner.read(n)
        if chunk:
            self._md5.update(chunk)
            if self._sha is not None:
                self._sha.update(chunk)
            self.size += len(chunk)
            if 0 <= self.expect_size < self.size:
                raise ChecksumError("body exceeds declared size")
        return chunk

    def etag(self) -> str:
        return self._md5.hexdigest()

    def verify(self) -> None:
        """Raise ChecksumError when the declared digests don't match
        what streamed through; call at EOF."""
        if 0 <= self.expect_size != self.size:
            raise ChecksumError(
                f"size mismatch: declared {self.expect_size}, "
                f"read {self.size}")
        if self.want_md5 is not None and \
                self._md5.digest() != self.want_md5:
            raise ChecksumError("Content-MD5 mismatch")
        if self._sha is not None and \
                self._sha.hexdigest() != self.want_sha256:
            raise ChecksumError("x-amz-content-sha256 mismatch")


class ChecksumError(Exception):
    pass


def ensure_reader(data) -> Reader:
    """bytes / Reader / file-like / iterable -> Reader."""
    if isinstance(data, Reader):
        return data
    if isinstance(data, (bytes, bytearray, memoryview)):
        return BytesReader(bytes(data))
    if hasattr(data, "read"):
        return _FileReader(data)
    return IterReader(data)


class _FileReader(Reader):
    def __init__(self, f):
        self._f = f

    def read(self, n: int) -> bytes:
        return self._f.read(n) or b""


def read_exactly(reader: Reader, n: int) -> bytes:
    """Read exactly n bytes unless EOF arrives first."""
    parts = []
    left = n
    while left > 0:
        chunk = reader.read(left)
        if not chunk:
            break
        parts.append(chunk)
        left -= len(chunk)
    return b"".join(parts)


def batch_size(block_size: int,
               batch_bytes: int = DEFAULT_BATCH_BYTES) -> int:
    """The exact byte length of every non-final iter_batches batch —
    the single source of truth callers (engine._stream_shard_writes)
    use to recognize a final short batch."""
    return max(1, batch_bytes // block_size) * block_size


def iter_batches(reader: Reader, block_size: int,
                 batch_bytes: int = DEFAULT_BATCH_BYTES,
                 ) -> Iterator[bytes]:
    """Yield batches that are multiples of block_size (except the final
    short one), so downstream encode batches always align on stripe
    boundaries. Yields nothing for an empty stream."""
    per = batch_size(block_size, batch_bytes)
    while True:
        chunk = read_exactly(reader, per)
        if not chunk:
            return
        yield chunk
        if len(chunk) < per:
            return
