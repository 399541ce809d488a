"""Pure-Python Parquet reader + writer for S3 Select (ref
pkg/s3select/internal/parquet-go — the reference vendors an 18k-LoC
Go parquet stack; this is a from-scratch minimal implementation of the
same on-wire format).

Supported (flat schemas, the S3 Select case):
  - thrift compact protocol (the only parquet metadata encoding)
  - PLAIN encoding for BOOLEAN/INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY
  - RLE/bit-packed hybrid for definition levels and RLE_DICTIONARY
    indices (+ dictionary pages)
  - UNCOMPRESSED, SNAPPY (utils/snappy.py) and GZIP pages
  - OPTIONAL columns (nulls via def level 0)
Writer emits one row group, PLAIN, optionally snappy/gzip-compressed —
enough for tests and CONVERT-style tooling; reader handles
dictionary-encoded files too.

The port's own copy of ``minio_tpu/s3select/parquet.py``, with no change in
behaviour.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

MAGIC = b"PAR1"

# parquet.thrift Type
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
# Encoding
ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE = 0, 2, 3
ENC_RLE_DICT = 8
# Codec
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP = 0, 1, 2
_CODEC_NAMES = {None: CODEC_UNCOMPRESSED, "snappy": CODEC_SNAPPY,
                "gzip": CODEC_GZIP}
# Repetition
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# PageType
PAGE_DATA, PAGE_INDEX, PAGE_DICT = 0, 1, 2


class ParquetError(Exception):
    pass


# ---------------------------------------------------------------------------
# thrift compact protocol
# ---------------------------------------------------------------------------

CT_STOP, CT_TRUE, CT_FALSE, CT_BYTE, CT_I16, CT_I32, CT_I64, \
    CT_DOUBLE, CT_BINARY, CT_LIST, CT_SET, CT_MAP, CT_STRUCT = range(13)


class TReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def skip(self, ctype: int) -> None:
        if ctype in (CT_TRUE, CT_FALSE):
            return
        if ctype == CT_BYTE:
            self.pos += 1
        elif ctype in (CT_I16, CT_I32, CT_I64):
            self.varint()
        elif ctype == CT_DOUBLE:
            self.pos += 8
        elif ctype == CT_BINARY:
            self.read_binary()
        elif ctype in (CT_LIST, CT_SET):
            size, et = self.list_header()
            for _ in range(size):
                self.skip(et)
        elif ctype == CT_MAP:
            size = self.varint()
            if size:
                kv = self.buf[self.pos]
                self.pos += 1
                for _ in range(size):
                    self.skip(kv >> 4)
                    self.skip(kv & 0x0F)
        elif ctype == CT_STRUCT:
            for _fid, ft in self.fields():
                self.skip(ft)
        else:
            raise ParquetError(f"bad thrift type {ctype}")

    def fields(self):
        """Yield (field_id, ctype) until STOP; caller must consume or
        skip each value (bools are consumed by the header itself and
        yielded as CT_TRUE/CT_FALSE)."""
        last = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            if b == 0:
                return
            delta = b >> 4
            ctype = b & 0x0F
            fid = (last + delta) if delta else self.zigzag()
            last = fid
            yield fid, ctype

    def list_header(self) -> tuple[int, int]:
        b = self.buf[self.pos]
        self.pos += 1
        size = b >> 4
        if size == 15:
            size = self.varint()
        return size, b & 0x0F


class TWriter:
    def __init__(self):
        self.out = bytearray()
        self._last: list[int] = [0]

    def varint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def field(self, fid: int, ctype: int) -> None:
        delta = fid - self._last[-1]
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self.zigzag(fid)
        self._last[-1] = fid

    def i32(self, fid: int, v: int) -> None:
        self.field(fid, CT_I32)
        self.zigzag(v)

    def i64(self, fid: int, v: int) -> None:
        self.field(fid, CT_I64)
        self.zigzag(v)

    def binary(self, fid: int, v: bytes) -> None:
        self.field(fid, CT_BINARY)
        self.varint(len(v))
        self.out += v

    def begin_struct(self, fid: int) -> None:
        self.field(fid, CT_STRUCT)
        self._last.append(0)

    def end_struct(self) -> None:
        self.out.append(0)  # STOP
        self._last.pop()

    def list_begin(self, fid: int, etype: int, size: int) -> None:
        self.field(fid, CT_LIST)
        if size < 15:
            self.out.append((size << 4) | etype)
        else:
            self.out.append((15 << 4) | etype)
            self.varint(size)

    def stop(self) -> None:
        self.out.append(0)


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid (levels + dictionary indices)
# ---------------------------------------------------------------------------


def rle_decode(data: bytes, bit_width: int, count: int) -> list[int]:
    out: list[int] = []
    r = TReader(data)
    byte_w = (bit_width + 7) // 8
    while len(out) < count and r.pos < len(data):
        header = r.varint()
        if header & 1:  # bit-packed groups
            groups = header >> 1
            n_bits = groups * 8 * bit_width
            raw = r.buf[r.pos:r.pos + (n_bits + 7) // 8]
            r.pos += (n_bits + 7) // 8
            acc = int.from_bytes(raw, "little")
            mask = (1 << bit_width) - 1
            for i in range(groups * 8):
                out.append((acc >> (i * bit_width)) & mask)
        else:  # RLE run
            run = header >> 1
            v = int.from_bytes(r.buf[r.pos:r.pos + byte_w], "little")
            r.pos += byte_w
            out.extend([v] * run)
    return out[:count]


def rle_encode(values, bit_width: int) -> bytes:
    """RLE runs only (adequate for levels and our writer).  Run
    boundaries found vectorized — an 8M-row all-present level column
    is one run, not 8M python comparisons."""
    import numpy as np
    arr = np.asarray(values, dtype=np.int64)
    if arr.size == 0:
        return b""
    change = np.flatnonzero(arr[1:] != arr[:-1])
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [arr.size]))
    w = TWriter()
    byte_w = max(1, (bit_width + 7) // 8)
    for s, e in zip(starts.tolist(), ends.tolist()):
        w.varint((e - s) << 1)
        w.out += int(arr[s]).to_bytes(byte_w, "little")
    return bytes(w.out)


# ---------------------------------------------------------------------------
# schema model
# ---------------------------------------------------------------------------


@dataclass
class Column:
    name: str
    ptype: int               # parquet physical type
    optional: bool = True
    is_string: bool = False  # BYTE_ARRAY rendered as str


@dataclass
class _Chunk:
    ptype: int
    codec: int
    data_off: int = 0
    dict_off: int = 0
    num_values: int = 0
    total_uncompressed: int = 0
    path: list[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


_NP_ENC_DTYPES = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4",
                  DOUBLE: "<f8"}


def _plain_encode(ptype: int, values) -> bytes:
    import numpy as np
    if ptype == BOOLEAN:
        arr = np.asarray(values, dtype=bool)
        return np.packbits(arr, bitorder="little").tobytes()
    if ptype in _NP_ENC_DTYPES:
        # np serialization is byte-identical to the struct.pack loop
        # (explicit little-endian dtypes) and vectorized — the 256MiB
        # bench fixture writes in seconds, not minutes.  ndarray
        # inputs need EXPLICIT range/kind checks: np casts unsafely
        # where struct.pack raised (int64 2^40 -> int32 would wrap
        # silently, a float array would truncate to int).
        want = np.dtype(_NP_ENC_DTYPES[ptype])
        try:
            if isinstance(values, np.ndarray):
                arr = values
                if arr.dtype != want:
                    if want.kind == "i":
                        if arr.dtype.kind not in "iu":
                            raise ParquetError(
                                f"unencodable values: {arr.dtype} "
                                "array for an integer column")
                        info = np.iinfo(want)
                        if arr.size and (int(arr.min()) < info.min
                                         or int(arr.max())
                                         > info.max):
                            raise ParquetError(
                                "unencodable values: out of range "
                                f"for {want}")
                    elif want == np.dtype("<f4") \
                            and arr.dtype.kind == "f" and arr.size:
                        finite = arr[np.isfinite(arr)]
                        if finite.size and float(np.abs(finite).max()) \
                                > float(np.finfo(np.float32).max):
                            raise ParquetError(
                                "unencodable values: float too "
                                "large for FLOAT")
                    arr = arr.astype(want)
            else:
                # the direct constructor RAISES on out-of-range
                # python ints, matching the old struct.pack behavior
                arr = np.asarray(values, dtype=want)
        except (OverflowError, TypeError, ValueError) as e:
            raise ParquetError(f"unencodable values: {e}")
        return np.ascontiguousarray(arr).tobytes()
    if ptype == BYTE_ARRAY:
        out = bytearray()
        for v in values:
            b = v.encode() if isinstance(v, str) else bytes(v)
            out += struct.pack("<I", len(b)) + b
        return bytes(out)
    raise ParquetError(f"unsupported type {ptype}")


def write_parquet(columns: list[Column], rows: list[dict],
                  codec: str | None = None) -> bytes:
    """One row group, PLAIN; codec None | "snappy" | "gzip" compresses
    every data page (fixture generation + CONVERT tooling parity with
    the reference's compressed-page support)."""
    return write_parquet_columns(
        columns, {c.name: [r.get(c.name) for r in rows]
                  for c in columns}, len(rows), codec)


def write_parquet_columns(columns: list[Column], col_data: dict,
                          num_rows: int,
                          codec: str | None = None) -> bytes:
    """Column-major writer entry: ``col_data`` maps column name to a
    list (None = null) or an ndarray (no nulls) of ``num_rows``
    values.  The bench's 256MiB fixtures hand arrays straight through
    to the vectorized PLAIN encoder instead of transposing dict rows."""
    import numpy as np
    codec_id = _CODEC_NAMES[codec]
    out = bytearray(MAGIC)
    chunks = []
    for col in columns:
        raw = col_data[col.name]
        if len(raw) != num_rows:
            raise ParquetError(
                f"column {col.name}: {len(raw)} values, "
                f"expected {num_rows}")
        if isinstance(raw, np.ndarray):
            def_levels = (np.ones(num_rows, dtype=np.int64)
                          if col.optional else [])
            values = raw
        elif col.optional:
            def_levels = [0 if v is None else 1 for v in raw]
            values = [v for v in raw if v is not None]
        else:
            if any(v is None for v in raw):
                raise ParquetError(f"null in REQUIRED column "
                                   f"{col.name}")
            def_levels = []
            values = raw
        body = bytearray()
        if col.optional:
            lv = rle_encode(def_levels, 1)
            body += struct.pack("<I", len(lv)) + lv
        body += _plain_encode(col.ptype, values)

        uncomp_len = len(body)
        if codec_id == CODEC_SNAPPY:
            from ..utils import snappy
            body = bytearray(snappy.compress(bytes(body)))
        elif codec_id == CODEC_GZIP:
            import gzip as _gzip
            body = bytearray(_gzip.compress(bytes(body)))

        ph = TWriter()
        ph.i32(1, PAGE_DATA)
        ph.i32(2, uncomp_len)
        ph.i32(3, len(body))
        ph.begin_struct(5)  # DataPageHeader
        ph.i32(1, num_rows)
        ph.i32(2, ENC_PLAIN)
        ph.i32(3, ENC_RLE)  # def levels
        ph.i32(4, ENC_RLE)  # rep levels (absent for flat)
        ph.end_struct()
        ph.stop()

        off = len(out)
        out += bytes(ph.out) + body
        chunks.append((col, off, len(ph.out) + len(body), num_rows,
                       len(ph.out) + uncomp_len))

    # FileMetaData footer (thrift list items are bare structs encoded
    # back-to-back — no field headers between them).
    fm2 = TWriter()
    fm2.i32(1, 1)  # version
    fm2.list_begin(2, CT_STRUCT, len(columns) + 1)  # schema

    def schema_element(w, name, ptype=None, repetition=None,
                       num_children=None):
        w._last.append(0)
        if ptype is not None:
            w.i32(1, ptype)
        if repetition is not None:
            w.i32(3, repetition)
        w.binary(4, name.encode())
        if num_children is not None:
            w.i32(5, num_children)
        w.out.append(0)
        w._last.pop()

    schema_element(fm2, "schema", num_children=len(columns))
    for col in columns:
        schema_element(fm2, col.name, ptype=col.ptype,
                       repetition=OPTIONAL if col.optional
                       else REQUIRED)
    fm2.i64(3, num_rows)
    fm2.list_begin(4, CT_STRUCT, 1)  # row_groups
    # RowGroup struct (list item: no field header)
    fm2._last.append(0)
    fm2.list_begin(1, CT_STRUCT, len(columns))  # columns
    total = 0  # RowGroup.total_byte_size is UNCOMPRESSED per the spec
    for col, off, clen, nvals, uclen in chunks:
        total += uclen
        fm2._last.append(0)  # ColumnChunk
        fm2.i64(2, off)  # file_offset
        fm2.begin_struct(3)  # ColumnMetaData
        fm2.i32(1, col.ptype)
        fm2.list_begin(2, CT_I32, 1)
        fm2.zigzag(ENC_PLAIN)
        fm2.list_begin(3, CT_BINARY, 1)
        fm2.varint(len(col.name.encode()))
        fm2.out += col.name.encode()
        fm2.i32(4, codec_id)
        fm2.i64(5, nvals)
        fm2.i64(6, uclen)
        fm2.i64(7, clen)
        fm2.i64(9, off)  # data_page_offset
        fm2.end_struct()
        fm2.out.append(0)  # end ColumnChunk
        fm2._last.pop()
    fm2.i64(2, total)
    fm2.i64(3, num_rows)
    fm2.out.append(0)  # end RowGroup
    fm2._last.pop()
    fm2.stop()

    footer = bytes(fm2.out)
    out += footer
    out += struct.pack("<I", len(footer))
    out += MAGIC
    return bytes(out)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _read_schema(r: TReader) -> list[Column]:
    size, _ = r.list_header()
    cols: list[Column] = []
    for i in range(size):
        name = ""
        ptype = None
        rep = REQUIRED
        nchild = 0
        for fid, ct in r.fields():
            if fid == 1:
                ptype = r.zigzag()
            elif fid == 3:
                rep = r.zigzag()
            elif fid == 4:
                name = r.read_binary().decode()
            elif fid == 5:
                nchild = r.zigzag()
            else:
                r.skip(ct)
        if i == 0:
            continue  # root
        if nchild:
            raise ParquetError(
                f"nested schema (group {name!r}) not supported — "
                "flat schemas only")
        if rep == REPEATED:
            raise ParquetError(
                f"REPEATED column {name!r} not supported")
        cols.append(Column(name=name, ptype=ptype,
                           optional=(rep == OPTIONAL),
                           is_string=(ptype == BYTE_ARRAY)))
    return cols


def _read_column_meta(r: TReader) -> _Chunk:
    ch = _Chunk(ptype=0, codec=0)
    for fid, ct in r.fields():
        if fid == 1:
            ch.ptype = r.zigzag()
        elif fid == 3:
            size, _ = r.list_header()
            ch.path = [r.read_binary().decode() for _ in range(size)]
        elif fid == 4:
            ch.codec = r.zigzag()
        elif fid == 5:
            ch.num_values = r.zigzag()
        elif fid == 6:
            ch.total_uncompressed = r.zigzag()
        elif fid == 9:
            ch.data_off = r.zigzag()
        elif fid == 11:
            ch.dict_off = r.zigzag()
        else:
            r.skip(ct)
    return ch


def _plain_decode(ptype: int, buf: bytes, pos: int, n: int,
                  as_str: bool) -> tuple[list, int]:
    if ptype == BOOLEAN:
        acc = int.from_bytes(buf[pos:pos + (n + 7) // 8], "little")
        return [bool((acc >> i) & 1) for i in range(n)], \
            pos + (n + 7) // 8
    if ptype in (INT32, FLOAT):
        fmt = "<i" if ptype == INT32 else "<f"
        vals = [struct.unpack_from(fmt, buf, pos + 4 * i)[0]
                for i in range(n)]
        return vals, pos + 4 * n
    if ptype in (INT64, DOUBLE):
        fmt = "<q" if ptype == INT64 else "<d"
        vals = [struct.unpack_from(fmt, buf, pos + 8 * i)[0]
                for i in range(n)]
        return vals, pos + 8 * n
    if ptype == BYTE_ARRAY:
        vals = []
        for _ in range(n):
            ln = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            v = buf[pos:pos + ln]
            pos += ln
            vals.append(v.decode("utf-8", "replace") if as_str else v)
        return vals, pos
    raise ParquetError(f"unsupported physical type {ptype}")


def _read_page_header(r: TReader) -> dict:
    h = {"type": None, "comp_size": 0, "uncomp_size": 0,
         "num_values": 0, "encoding": ENC_PLAIN,
         "def_encoding": ENC_RLE}
    for fid, ct in r.fields():
        if fid == 1:
            h["type"] = r.zigzag()
        elif fid == 2:
            h["uncomp_size"] = r.zigzag()
        elif fid == 3:
            h["comp_size"] = r.zigzag()
        elif fid in (5, 7):  # DataPageHeader / DictionaryPageHeader
            for f2, c2 in r.fields():
                if f2 == 1:
                    h["num_values"] = r.zigzag()
                elif f2 == 2:
                    h["encoding"] = r.zigzag()
                elif f2 == 3:
                    h["def_encoding"] = r.zigzag()
                else:
                    r.skip(c2)
        else:
            r.skip(ct)
    return h


def _decompress(codec: int, data: bytes, uncomp: int) -> bytes:
    """Page decompression: UNCOMPRESSED, SNAPPY (raw block format,
    utils/snappy.py) and GZIP — the codecs the reference's vendored
    parquet stack supports (pkg/s3select/internal/parquet-go; real-
    world parquet is nearly always snappy)."""
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec == CODEC_SNAPPY:
        from ..utils import snappy
        try:
            out = snappy.decompress(data)
        except snappy.SnappyError as e:
            raise ParquetError(f"bad snappy page: {e}")
    elif codec == CODEC_GZIP:
        import zlib
        try:
            out = zlib.decompress(data, 47)  # gzip or zlib wrapper
        except zlib.error as e:
            raise ParquetError(f"bad gzip page: {e}")
    else:
        raise ParquetError(f"unsupported parquet codec {codec}")
    if len(out) != uncomp:
        raise ParquetError(
            f"page inflated to {len(out)}, header says {uncomp}")
    return out


def read_parquet(data: bytes) -> tuple[list[Column], list[dict]]:
    """Full decode of a flat parquet file -> (schema columns, rows).
    Any malformed input surfaces as ParquetError."""
    try:
        return _read_parquet(data)
    except ParquetError:
        raise
    except (IndexError, ValueError, struct.error, KeyError,
            OverflowError, UnicodeDecodeError) as e:
        raise ParquetError(f"malformed parquet: "
                           f"{type(e).__name__}: {e}")


def read_footer(data: bytes) -> tuple[list[Column], list[dict]]:
    """Parse the FileMetaData footer: (schema columns, row groups as
    {"chunks": [_Chunk], "num_rows": int}).  Shared by the row reader
    and the columnar batch reader (s3select/columnar.py); per-group
    row counts fall back to the widest chunk's num_values for writers
    that omit RowGroup.num_rows."""
    if data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetError("not a parquet file")
    flen = struct.unpack("<I", data[-8:-4])[0]
    r = TReader(data, len(data) - 8 - flen)

    cols: list[Column] = []
    num_rows = 0
    groups: list[dict] = []
    for fid, ct in r.fields():
        if fid == 2:
            cols = _read_schema(r)
        elif fid == 3:
            num_rows = r.zigzag()
        elif fid == 4:
            size, _ = r.list_header()
            for _ in range(size):
                chunks: list[_Chunk] = []
                g_rows = 0
                for f2, c2 in r.fields():
                    if f2 == 1:
                        n, _ = r.list_header()
                        for _ in range(n):
                            chunk = None
                            for f3, c3 in r.fields():
                                if f3 == 3:
                                    chunk = _read_column_meta(r)
                                else:
                                    r.skip(c3)
                            if chunk is not None:
                                chunks.append(chunk)
                    elif f2 == 3:
                        g_rows = r.zigzag()
                    else:
                        r.skip(c2)
                if not g_rows:
                    g_rows = max((c.num_values for c in chunks),
                                 default=0)
                groups.append({"chunks": chunks, "num_rows": g_rows})
        else:
            r.skip(ct)
    if num_rows and not groups:
        raise ParquetError("row count without row groups")
    return cols, groups


def uncompressed_size(data: bytes) -> int:
    """Total uncompressed bytes across all column chunks — the honest
    BytesProcessed for a whole-file (row engine) Parquet scan."""
    _, groups = read_footer(data)
    return sum(c.total_uncompressed for g in groups
               for c in g["chunks"])


def _read_parquet(data: bytes) -> tuple[list[Column], list[dict]]:
    cols, groups = read_footer(data)
    num_rows = sum(g["num_rows"] for g in groups)
    row_groups = [g["chunks"] for g in groups]

    by_name = {c.name: c for c in cols}
    columns_data: dict[str, list] = {c.name: [] for c in cols}
    for chunks in row_groups:
        for ch in chunks:
            name = ch.path[-1] if ch.path else ""
            col = by_name.get(name)
            if col is None:
                continue
            columns_data[name].extend(
                _read_chunk_values(data, ch, col))
    rows = []
    for i in range(num_rows):
        rows.append({c.name: (columns_data[c.name][i]
                              if i < len(columns_data[c.name]) else None)
                     for c in cols})
    return cols, rows


def _read_chunk_values(data: bytes, ch: _Chunk, col: Column) -> list:
    out: list = []
    dictionary: list | None = None
    pos = ch.dict_off or ch.data_off
    remaining = ch.num_values
    while remaining > 0:
        r = TReader(data, pos)
        h = _read_page_header(r)
        body = _decompress(
            ch.codec, data[r.pos:r.pos + h["comp_size"]],
            h["uncomp_size"])
        pos = r.pos + h["comp_size"]
        if h["type"] == PAGE_DICT:
            dictionary, _ = _plain_decode(
                col.ptype, body, 0, h["num_values"], col.is_string)
            continue
        if h["type"] == PAGE_INDEX:
            continue  # index pages carry no values
        if h["type"] != PAGE_DATA:
            raise ParquetError(
                f"unsupported page type {h['type']} "
                "(data page v1 only)")
        n = h["num_values"]
        bpos = 0
        if col.optional:
            lv_len = struct.unpack_from("<I", body, 0)[0]
            levels = rle_decode(body[4:4 + lv_len], 1, n)
            bpos = 4 + lv_len
        else:
            levels = [1] * n
        present = sum(levels)
        if h["encoding"] in (ENC_RLE_DICT, ENC_PLAIN_DICT):
            if dictionary is None:
                raise ParquetError("dictionary page missing")
            bit_width = body[bpos]
            idx = rle_decode(body[bpos + 1:], bit_width, present)
            vals = [dictionary[i] for i in idx]
        else:
            vals, _ = _plain_decode(col.ptype, body, bpos, present,
                                    col.is_string)
        it = iter(vals)
        out.extend(next(it) if lv else None for lv in levels)
        remaining -= n
    return out


def parquet_records(data: bytes):
    """Yield dict records for the SQL engine (ref the parquet reader
    feeding pkg/s3select/select.go)."""
    _, rows = read_parquet(data)
    yield from rows


# ---------------------------------------------------------------------------
# columnar (vectorized) decode — the scan engine's fast path
# ---------------------------------------------------------------------------


def rle_decode_np(data: bytes, bit_width: int,
                  count: int) -> "np.ndarray":
    """Vectorized RLE/bit-packed hybrid decode -> int64 array.
    Byte-identical to rle_decode (tested); bit-packed groups unpack
    through np.unpackbits instead of a per-value python loop."""
    import numpy as np
    out = np.empty(count, dtype=np.int64)
    filled = 0
    r = TReader(data)
    byte_w = (bit_width + 7) // 8
    weights = (np.int64(1) << np.arange(max(bit_width, 1),
                                        dtype=np.int64))
    while filled < count and r.pos < len(data):
        header = r.varint()
        if header & 1:  # bit-packed groups
            groups = header >> 1
            nvals = groups * 8
            nbytes = (nvals * bit_width + 7) // 8
            raw = np.frombuffer(r.buf, np.uint8, nbytes, r.pos)
            r.pos += nbytes
            if bit_width == 0:
                vals = np.zeros(nvals, dtype=np.int64)
            else:
                bits = np.unpackbits(raw, bitorder="little")
                usable = (bits.size // bit_width) * bit_width
                vals = (bits[:usable].astype(np.int64)
                        .reshape(-1, bit_width) @ weights)
            take = min(nvals, count - filled, len(vals))
            out[filled:filled + take] = vals[:take]
            filled += take
        else:  # RLE run
            run = header >> 1
            v = int.from_bytes(bytes(r.buf[r.pos:r.pos + byte_w]),
                               "little")
            r.pos += byte_w
            take = min(run, count - filled)
            out[filled:filled + take] = v
            filled += take
    return out[:filled]


def _plain_decode_np(ptype: int, buf: bytes, pos: int, n: int,
                     as_str: bool):
    """PLAIN page decode, vectorized: numeric types come back as a
    zero-copy np view over the page body (the row reader's per-value
    struct.unpack loop is the single hottest line of the old scan)."""
    import numpy as np
    if ptype == BOOLEAN:
        raw = np.frombuffer(buf, np.uint8, (n + 7) // 8, pos)
        return np.unpackbits(raw, bitorder="little")[:n].astype(bool)
    if ptype in (INT32, FLOAT):
        return np.frombuffer(buf, "<i4" if ptype == INT32 else "<f4",
                             n, pos)
    if ptype in (INT64, DOUBLE):
        return np.frombuffer(buf, "<i8" if ptype == INT64 else "<f8",
                             n, pos)
    if ptype == BYTE_ARRAY:
        vals, _ = _plain_decode(ptype, buf, pos, n, as_str)
        return vals
    raise ParquetError(f"unsupported physical type {ptype}")


def decode_chunk_np(data: bytes, ch: _Chunk, col: Column) -> dict:
    """One column chunk -> typed arrays for the scan engine:
    {"values": ndarray|list|None, "null": bool ndarray|None,
     "codes": int ndarray|None, "dict": list|None,
     "nrows": int, "unc_bytes": int}.

    Dictionary-encoded BYTE_ARRAY pages keep their (codes, dictionary)
    form — a string predicate then evaluates once per DISTINCT value
    and gathers, instead of once per row."""
    import numpy as np
    pos = ch.dict_off or ch.data_off
    remaining = ch.num_values
    parts: list[tuple] = []   # ("vals", arr|list) | ("codes", arr)
    nullparts: list = []
    dictionary = None
    unc = 0
    while remaining > 0:
        r = TReader(data, pos)
        h = _read_page_header(r)
        body = _decompress(
            ch.codec, data[r.pos:r.pos + h["comp_size"]],
            h["uncomp_size"])
        pos = r.pos + h["comp_size"]
        if h["type"] == PAGE_DICT:
            dictionary = _plain_decode_np(
                col.ptype, body, 0, h["num_values"], col.is_string)
            unc += h["uncomp_size"]
            continue
        if h["type"] == PAGE_INDEX:
            continue
        if h["type"] != PAGE_DATA:
            raise ParquetError(
                f"unsupported page type {h['type']} "
                "(data page v1 only)")
        unc += h["uncomp_size"]
        n = h["num_values"]
        bpos = 0
        present_mask = None
        if col.optional:
            lv_len = struct.unpack_from("<I", body, 0)[0]
            levels = rle_decode_np(body[4:4 + lv_len], 1, n)
            if len(levels) < n:
                raise ParquetError("truncated definition levels")
            present_mask = levels.astype(bool)
            present = int(present_mask.sum())
            bpos = 4 + lv_len
            nullparts.append(~present_mask)
        else:
            present = n
            nullparts.append(np.zeros(n, dtype=bool))
        if h["encoding"] in (ENC_RLE_DICT, ENC_PLAIN_DICT):
            if dictionary is None:
                raise ParquetError("dictionary page missing")
            bw = body[bpos]
            idx = rle_decode_np(body[bpos + 1:], bw, present)
            if len(idx) < present:
                raise ParquetError("truncated dictionary indices")
            if col.is_string:
                codes = np.full(n, -1, dtype=np.int64)
                if present_mask is None:
                    codes[:] = idx
                else:
                    codes[present_mask] = idx
                parts.append(("codes", codes))
            else:
                darr = np.asarray(dictionary)
                parts.append(("vals", _scatter_np(
                    darr[idx], n, present_mask)))
        else:
            vals = _plain_decode_np(col.ptype, body, bpos, present,
                                    col.is_string)
            if col.is_string:
                if present_mask is None:
                    parts.append(("vals", vals))
                else:
                    full = [""] * n
                    it = iter(vals)
                    for i, p in enumerate(present_mask.tolist()):
                        if p:
                            full[i] = next(it)
                    parts.append(("vals", full))
            else:
                parts.append(("vals", _scatter_np(
                    np.asarray(vals), n, present_mask)))
        remaining -= n
    null = None
    if col.optional and nullparts:
        null = (nullparts[0] if len(nullparts) == 1
                else np.concatenate(nullparts))
        if not null.any():
            null = None
    out = {"values": None, "null": null, "codes": None, "dict": None,
           "nrows": ch.num_values, "unc_bytes": unc}
    kinds = {k for k, _ in parts}
    if kinds == {"codes"}:
        codes = (parts[0][1] if len(parts) == 1
                 else np.concatenate([p[1] for p in parts]))
        out["codes"] = codes
        out["dict"] = list(dictionary)
        return out
    vals_list: list = []
    for kind, p in parts:
        if kind == "codes":
            # Mixed plain/dict pages in one chunk: resolve codes so
            # the chunk presents one uniform values sequence.
            p = [dictionary[i] if i >= 0 else "" for i in p.tolist()]
        vals_list.append(p)
    if not vals_list:
        out["values"] = [] if col.is_string else np.zeros(0)
        return out
    if col.is_string:
        merged: list = []
        for p in vals_list:
            merged.extend(p if isinstance(p, list) else list(p))
        out["values"] = merged
    else:
        out["values"] = (vals_list[0] if len(vals_list) == 1
                         else np.concatenate(vals_list))
    return out


def _scatter_np(vals, n: int, mask):
    import numpy as np
    if mask is None:
        return vals
    out = np.zeros(n, dtype=vals.dtype)
    out[mask] = vals
    return out
