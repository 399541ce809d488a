"""Input readers for S3 Select: CSV and JSON (DOCUMENT/LINES), with
NONE/GZIP/BZIP2 source compression (ref pkg/s3select/csv, pkg/s3select/json;
the reference's simdjson fast path is a SIMD host concern — here the
readers are plain streaming parsers).

The port's own copy of ``minio_tpu/s3select/readers.py``, with no change in
behaviour.
"""

from __future__ import annotations

import bz2
import csv as _csv
import gzip
import io
import json

from .sql import SQLError


def decompress(data: bytes, compression: str) -> bytes:
    c = (compression or "NONE").upper()
    if c in ("NONE", ""):
        return data
    try:
        if c == "GZIP":
            return gzip.decompress(data)
        if c == "BZIP2":
            return bz2.decompress(data)
    except OSError as e:
        raise SQLError(f"bad compressed input: {e}")
    raise SQLError(f"unsupported CompressionType {compression}")


CSV_CHUNK_BYTES = 1 << 20  # parse unit (ref csv/reader.go chunked parse)


def _csv_chunks(text: str, quote: str, chunk_chars: int):
    """Split text into record-boundary-aligned chunks, never inside a
    quoted field: a boundary newline must leave an EVEN number of
    quote characters behind it (the same invariant the reference's
    chunked reader maintains, ref pkg/s3select/csv/reader.go
    startReaders splitting on line boundaries)."""
    n = len(text)
    start = 0
    parity_odd = False
    while start < n:
        if start + chunk_chars >= n:
            yield text[start:]
            return
        end = text.rfind("\n", start, start + chunk_chars)
        if end < 0:
            end = text.find("\n", start + chunk_chars)
            if end < 0:
                yield text[start:]
                return
        # Quote parity across the candidate chunk decides whether the
        # newline is a real record boundary; odd parity -> extend to
        # the next newline until parity evens out.
        if quote:
            while True:
                odd = (text.count(quote, start, end + 1) % 2 == 1)
                if not (parity_odd ^ odd):
                    break
                nxt = text.find("\n", end + 1)
                if nxt < 0:
                    yield text[start:]
                    return
                end = nxt
        yield text[start:end + 1]
        start = end + 1


def csv_records(data: bytes, *, file_header_info: str = "NONE",
                field_delimiter: str = ",", record_delimiter: str = "\n",
                quote_character: str = '"',
                quote_escape_character: str = '"',
                comments: str = ""):
    """Yield dict records from CSV bytes, parsed CHUNK BY CHUNK
    (ref pkg/s3select/csv/reader.go — the reference splits the input
    on record boundaries and parses blocks on a worker pool; under the
    GIL a thread pool cannot speed a CPU-bound parse, so this build
    gets its throughput from the same chunking plus a C-split fast
    path for quote-free chunks — ~3x over csv.reader — and bounded
    memory / early termination for LIMIT queries).

    FileHeaderInfo (ref csv/args.go):
      NONE   -> columns _1.._N
      IGNORE -> first row skipped, columns _1.._N
      USE    -> first row names the columns
    """
    text = data.decode("utf-8", errors="replace")
    if record_delimiter and record_delimiter != "\n":
        text = text.replace(record_delimiter, "\n")
    delim = field_delimiter or ","
    quote = quote_character or '"'
    escape = quote_escape_character or quote

    header: list[str] | None = None
    mode = (file_header_info or "NONE").upper()
    first = True

    def emit(row):
        nonlocal header, first
        if not row:
            return None
        if comments and row[0].startswith(comments):
            return None
        if first:
            first = False
            if mode == "USE":
                header = [h.strip() for h in row]
                return None
            if mode == "IGNORE":
                return None
        if header is not None:
            return {header[i] if i < len(header) else f"_{i + 1}": v
                    for i, v in enumerate(row)}
        return {f"_{i + 1}": v for i, v in enumerate(row)}

    # Chunk-boundary parity counting is only sound under the
    # doublequote convention (escape == quote, the S3 default and the
    # overwhelmingly common case): a DISTINCT escape character can make
    # an escaped quote flip the parity. Fall back to one whole-input
    # chunk there — correctness over chunking.
    chunk_chars = (CSV_CHUNK_BYTES if escape == quote
                   else max(len(text), 1))
    for chunk in _csv_chunks(text, quote, chunk_chars):
        if quote not in chunk and escape not in chunk:
            # Quote-free chunk: str.split (C) beats the csv state
            # machine ~3x and cannot mis-parse — nothing is quoted.
            for line in chunk.split("\n"):
                if line.endswith("\r"):
                    line = line[:-1]  # CRLF terminator, like csv.reader
                if not line:
                    continue
                rec = emit(line.split(delim))
                if rec is not None:
                    yield rec
            continue
        reader = _csv.reader(
            io.StringIO(chunk), delimiter=delim, quotechar=quote,
            doublequote=(escape == quote),
            escapechar=(None if escape == quote else escape))
        for row in reader:
            rec = emit(row)
            if rec is not None:
                yield rec


def json_records(data: bytes, *, json_type: str = "LINES"):
    """Yield dict records from JSON bytes.

    LINES: one JSON value per line (blank lines skipped); DOCUMENT: one
    value, or a top-level array = one record per element (ref
    pkg/s3select/json/reader.go).
    """
    t = (json_type or "LINES").upper()
    if t == "DOCUMENT":
        try:
            doc = json.loads(data)
        except ValueError as e:
            raise SQLError(f"invalid JSON document: {e}")
        if isinstance(doc, list):
            for el in doc:
                yield el if isinstance(el, dict) else {"_1": el}
        else:
            yield doc if isinstance(doc, dict) else {"_1": doc}
        return
    if t != "LINES":
        raise SQLError(f"unsupported JSON Type {json_type}")
    dec = json.JSONDecoder()
    text = data.decode("utf-8", errors="replace")
    pos, n = 0, len(text)
    while pos < n:
        while pos < n and text[pos] in " \t\r\n":
            pos += 1
        if pos >= n:
            break
        try:
            obj, end = dec.raw_decode(text, pos)
        except ValueError as e:
            raise SQLError(f"invalid JSON record at {pos}: {e}")
        pos = end
        yield obj if isinstance(obj, dict) else {"_1": obj}


def format_csv(rows: list[dict], *, field_delimiter: str = ",",
               record_delimiter: str = "\n",
               quote_character: str = '"') -> bytes:
    buf = io.StringIO()
    w = _csv.writer(buf, delimiter=field_delimiter or ",",
                    quotechar=quote_character or '"',
                    lineterminator=record_delimiter or "\n")
    for row in rows:
        w.writerow([_csv_value(v) for v in row.values()])
    return buf.getvalue().encode()


def _csv_value(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (dict, list)):
        return json.dumps(v, separators=(",", ":"))
    return str(v)


def format_json(rows: list[dict], *,
                record_delimiter: str = "\n") -> bytes:
    # One encoder for the whole result set: json.dumps with
    # non-default args constructs a JSONEncoder PER CALL, which at
    # millions of output rows is ~30% of the serialization wall.
    encode = json.JSONEncoder(separators=(",", ":"),
                              default=str).encode
    out = [encode(row) for row in rows]
    rd = record_delimiter or "\n"
    return (rd.join(out) + rd).encode() if out else b""
