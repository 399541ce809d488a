"""Typed column batches for the columnar S3 Select scan engine.

CSV and Parquet inputs decompose into per-column typed arrays instead
of per-row dicts: numeric columns ride as device-eligible float64
arrays (with an ``intish`` flag so integer semantics stay exact),
strings as U-dtype arrays or — when the Parquet page was dictionary
encoded — as (codes, dictionary) pairs so a predicate evaluates once
per DISTINCT value and gathers.  Every column carries three masks:

- ``null``  — SQL NULL cells (Parquet definition level 0)
- ``miss``  — the field is ABSENT (ragged CSV rows): MISSING, which
  ``IS MISSING`` distinguishes from NULL
- a per-row **fallback mask** seeded here (int64 magnitudes past
  float64's 2^53 exact-integer range, >15-digit numeric strings) and
  grown by the compiler (division by zero, complex LIKE survivors):
  rows the vectorized path cannot decide EXACTLY take the row engine
  (s3select/fallback.py), so semantics never drift from the oracle.

The row readers (readers.csv_records / parquet.parquet_records) stay
untouched as the semantics oracle and the fallback execution tier.

The port's own copy of ``minio_tpu/s3select/columnar.py``, with no change in
behaviour.
"""

from __future__ import annotations

import numpy as np

from . import readers

# Rows per CSV column batch: bounds the U-array working set while
# keeping the vectorized ops wide enough to amortize dispatch.
CSV_BATCH_ROWS = 65536

# A string column whose U-dtype materialization would exceed this is
# not vectorized (one pathological 1MiB field would expand EVERY row
# to that width); the engine then falls back to the row tier.
MAX_U_BYTES = 64 << 20

# Integer-looking strings longer than this many characters can exceed
# float64's exact-integer range; those rows take the row fallback so
# dynamic-typed comparisons stay exact.
SAFE_NUM_CHARS = 15
# float64 exact-integer bound (2^53): int64 cells past it are
# fallback-masked at load, intish intermediates past it at eval.
INT_EXACT = float(1 << 53)

_ABSENT = object()   # py_value marker for a MISSING cell


class Column:
    """One typed column: raw values + null/miss/fallback masks.

    kind is "num" (raw int32/int64/float32/float64), "bool", or
    "str" (raw list[str] / U array / object array, or None when
    dictionary-backed via ``codes`` + ``dict_values``).
    """

    __slots__ = ("name", "kind", "raw", "null", "miss", "intish",
                 "codes", "dict_values", "_f64", "_u", "_strnum",
                 "_nrows")

    def __init__(self, name: str, kind: str, raw=None, null=None,
                 miss=None, intish: bool = False, codes=None,
                 dict_values=None, nrows: int | None = None):
        self.name = name
        self.kind = kind
        self.raw = raw
        self.null = null
        self.miss = miss
        self.intish = intish
        self.codes = codes
        self.dict_values = dict_values
        if nrows is None:
            nrows = len(codes) if raw is None else len(raw)
        self._nrows = nrows
        self._f64 = None
        self._u = None
        self._strnum = None

    @property
    def nrows(self) -> int:
        return self._nrows

    def null_mask(self) -> np.ndarray:
        """NULL-or-MISSING (the SQL `_is_null` notion)."""
        n = self._nrows
        out = np.zeros(n, dtype=bool)
        if self.null is not None:
            out |= self.null
        if self.miss is not None:
            out |= self.miss
        return out

    def miss_mask(self) -> np.ndarray:
        if self.miss is not None:
            return self.miss
        return np.zeros(self._nrows, dtype=bool)

    def data_nbytes(self) -> int:
        """Payload bytes this column carries — the dispatch-size
        input for the autotuner's batch-size bucket."""
        if self.codes is not None:
            return int(self.codes.nbytes) + sum(
                len(s) for s in self.dict_values)
        if isinstance(self.raw, np.ndarray):
            return int(self.raw.nbytes)
        return sum(len(s) for s in self.raw)

    # -- numeric views --------------------------------------------------

    def f64(self) -> tuple[np.ndarray, np.ndarray | None]:
        """(float64 values, fallback mask|None) for a num column."""
        if self._f64 is None:
            vals = np.asarray(self.raw)
            fb = None
            if vals.dtype.kind in "iu":
                if vals.dtype.itemsize >= 8:
                    big = np.abs(vals.astype(np.float64)) >= INT_EXACT
                    if big.any():
                        fb = big
                vals = vals.astype(np.float64)
            elif vals.dtype != np.float64:
                vals = vals.astype(np.float64)
            self._f64 = (vals, fb)
        return self._f64

    def strnum(self) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """Dynamic numeric coercion of a str column, vectorized:
        (float64 values, ok mask, fallback mask|None).  Rows that do
        not parse are simply not-ok (a comparison there answers False,
        like the row engine's `_coerced_pair`); parseable cells longer
        than SAFE_NUM_CHARS fall back for exactness."""
        if self._strnum is None:
            if self.codes is not None:
                # dummy-pad an empty (all-null chunk) dictionary, as
                # in str_rep — the rows are null-masked regardless
                dv, dok, dlen = _parse_str_array(self.dict_values
                                                 or [""])
                codes = np.clip(self.codes, 0, None)
                vals = dv[codes]
                ok = dok[codes] & (self.codes >= 0)
                lens = dlen[codes]
            else:
                vals, ok, lens = _parse_str_array(self.raw)
            fb = ok & (lens > SAFE_NUM_CHARS)
            self._strnum = (vals, ok, fb if fb.any() else None)
        return self._strnum

    # -- string views ---------------------------------------------------

    def str_rep(self):
        """Vectorizable string representation:
        ("dict", U-array-of-dict, codes) for dictionary-backed columns
        (predicates evaluate per DISTINCT value, then gather),
        ("u", U-array) otherwise, or None when the U materialization
        would blow the memory cap."""
        if self.codes is not None:
            if self._u is None:
                # An all-null chunk can carry an EMPTY dictionary —
                # pad with one dummy entry so clipped-code gathers
                # stay in bounds (every row is null-masked anyway).
                self._u = np.asarray(self.dict_values or [""],
                                     dtype=np.str_)
            return ("dict", self._u, self.codes)
        if self._u is None:
            arr = self.raw
            if not isinstance(arr, np.ndarray) or arr.dtype.kind != "U":
                total = 0
                maxlen = 0
                for s in arr:
                    ln = len(s)
                    total += ln
                    if ln > maxlen:
                        maxlen = ln
                if maxlen * 4 * max(1, self._nrows) > MAX_U_BYTES:
                    return None
                u = np.asarray(arr, dtype=np.str_)
                # numpy U storage silently DROPS trailing NUL chars;
                # a lossy conversion here would diverge from the row
                # engine on equality/LIKE — refuse it instead.
                if int(np.char.str_len(u).sum()) != total:
                    return None
                arr = u
            self._u = arr
        return ("u", self._u)

    # -- exact materialization ------------------------------------------

    def py_value(self, i: int):
        """The exact python value the row reader would have produced
        for this cell; _ABSENT when the field is missing."""
        if self.miss is not None and self.miss[i]:
            return _ABSENT
        if self.null is not None and self.null[i]:
            return None
        if self.codes is not None:
            return self.dict_values[int(self.codes[i])]
        v = self.raw[i]
        if self.kind == "str":
            return str(v)
        if self.kind == "bool":
            return bool(v)
        dt = np.asarray(self.raw).dtype
        return int(v) if dt.kind in "iu" else float(v)

    def py_values(self, idx: np.ndarray) -> list:
        """Bulk py_value for many rows: column-wise ndarray.tolist()
        (exact python ints/floats/bools/strs) instead of per-cell
        method calls — the projection tail of a high-selectivity scan
        lives here."""
        if self.codes is not None:
            dv = self.dict_values
            vals = [dv[c] if c >= 0 else None
                    for c in self.codes.take(idx).tolist()]
        elif self.kind == "str" and not isinstance(self.raw,
                                                   np.ndarray):
            raw = self.raw
            vals = [raw[i] for i in idx.tolist()]
        else:
            vals = np.asarray(self.raw).take(idx).tolist()
        if self.null is not None:
            for j in np.flatnonzero(self.null.take(idx)).tolist():
                vals[j] = None
        if self.miss is not None:
            for j in np.flatnonzero(self.miss.take(idx)).tolist():
                vals[j] = _ABSENT
        return vals


def _parse_str_array(arr) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(float64 values, parse-ok mask, per-cell char length) for a
    sequence of strings.  Whole-array astype is the fast path; any
    non-conforming cell drops to an exact per-element float() parse
    (the row engine's own coercion) so e.g. '1_0' stays consistent."""
    src = None
    if isinstance(arr, np.ndarray) and arr.dtype.kind == "U":
        u = arr
    else:
        src = list(arr)
        maxlen = max((len(s) for s in src), default=0)
        if maxlen * 4 * max(1, len(src)) > MAX_U_BYTES:
            # one wide cell would inflate EVERY row to its width —
            # the bounded per-element parse below is exact anyway
            u = None
        else:
            u = np.asarray(src, dtype=np.str_)
            # numpy U storage drops trailing NULs — if the conversion
            # was lossy, parse the ORIGINAL strings per element.
            if int(np.char.str_len(u).sum()) != \
                    sum(len(s) for s in src):
                u = None
    if u is not None:
        lens = np.char.str_len(u)
        try:
            with np.errstate(all="ignore"):
                vals = u.astype(np.float64)
            return vals, np.ones(len(u), dtype=bool), lens
        except ValueError:
            src = u.tolist()
    n = len(src)
    lens = np.asarray([len(s) for s in src], dtype=np.int64)
    vals = np.zeros(n, dtype=np.float64)
    ok = np.zeros(n, dtype=bool)
    for i, s in enumerate(src):
        try:
            vals[i] = float(s)
            ok[i] = True
        except ValueError:
            pass
    return vals, ok, lens


class ColumnBatch:
    """One batch of rows as typed columns, plus the exact-record
    escape hatch the fallback tier and the projector use."""

    def __init__(self, names: list[str], cols: dict[str, Column],
                 nrows: int, nbytes: int):
        self.names = names
        self.cols = cols
        self.nrows = nrows
        # Decoded bytes this batch actually processed — the honest
        # BytesProcessed numerator (only the columns that were read).
        self.nbytes = nbytes
        self._lower: dict[str, Column] | None = None

    def col(self, name: str) -> Column | None:
        """Mirror sql.Col's lookup: exact key, else the LAST column
        whose lowercased name matches (the row engine's lowered-dict
        rebuild lets later keys win)."""
        c = self.cols.get(name)
        if c is not None:
            return c
        if self._lower is None:
            self._lower = {n.lower(): self.cols[n] for n in self.names}
        return self._lower.get(name.lower())

    def record(self, i: int) -> dict:
        """The exact dict the row reader would have yielded for row i
        (missing fields absent, not None)."""
        out = {}
        for name in self.names:
            v = self.cols[name].py_value(i)
            if v is not _ABSENT:
                out[name] = v
        return out

    def records(self, idxs) -> list[dict]:
        """Exact reader-identical records for many rows, built
        column-wise.  The no-MISSING common case zips straight into
        dicts; ragged rows drop their absent keys per row."""
        idx = np.asarray(list(idxs), dtype=np.int64)
        if idx.size == 0:
            return []
        per_col = [self.cols[n].py_values(idx) for n in self.names]
        if not any(c.miss is not None and c.miss.take(idx).any()
                   for c in self.cols.values()):
            names = self.names
            return [dict(zip(names, row)) for row in zip(*per_col)]
        out = []
        for j in range(len(idx)):
            rec = {}
            for name, vals in zip(self.names, per_col):
                v = vals[j]
                if v is not _ABSENT:
                    rec[name] = v
            out.append(rec)
        return out


# ---------------------------------------------------------------------------
# CSV -> column batches
# ---------------------------------------------------------------------------


def csv_column_batches(data: bytes, *, file_header_info: str = "NONE",
                       field_delimiter: str = ",",
                       record_delimiter: str = "\n",
                       quote_character: str = '"',
                       quote_escape_character: str = '"',
                       comments: str = "",
                       batch_rows: int = CSV_BATCH_ROWS):
    """Yield ColumnBatch objects from CSV bytes with the same header /
    comment / CRLF semantics as readers.csv_records (the oracle the
    differential suite holds this against)."""
    text = data.decode("utf-8", errors="replace")
    if record_delimiter and record_delimiter != "\n":
        text = text.replace(record_delimiter, "\n")
    delim = field_delimiter or ","
    quote = quote_character or '"'
    escape = quote_escape_character or quote
    mode = (file_header_info or "NONE").upper()

    # Fast vectorized path: quote-free, CR-free, NUL-free (numpy U
    # storage truncates trailing NULs), comment-free input with
    # uniform field counts splits into columns with np.char
    # partitions — no per-cell python.  Anything irregular takes the
    # row-by-row builder below (same output, proven by the oracle).
    if (quote not in text and escape not in text and "\r" not in text
            and "\x00" not in text and not comments):
        yield from _csv_fast_batches(text, delim, mode, batch_rows)
        return
    yield from _csv_slow_batches(text, delim, quote, escape, mode,
                                 comments, batch_rows)


def _csv_names(header: list[str] | None, width: int) -> list[str]:
    if header is None:
        return [f"_{j + 1}" for j in range(width)]
    return [header[j] if j < len(header) else f"_{j + 1}"
            for j in range(width)]


def _batch_bytes(nrows: int, width: int, cell_chars: float) -> int:
    # Processed-bytes estimate for CSV batches: the characters this
    # batch's cells actually carried (delimiters included).
    return int(nrows * width * cell_chars)


def _csv_fast_batches(text: str, delim: str, mode: str,
                      batch_rows: int):
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    lines = [ln for ln in lines if ln]
    if not lines:
        return
    header: list[str] | None = None
    if mode == "USE":
        header = [h.strip() for h in lines[0].split(delim)]
        lines = lines[1:]
    elif mode == "IGNORE":
        lines = lines[1:]
    for start in range(0, len(lines), batch_rows):
        chunk = lines[start:start + batch_rows]
        # U-array width is the WIDEST line: one pathological 1MiB
        # line would inflate every row to that width (nrows x maxlen
        # x 4 bytes) — bound the allocation BEFORE it happens.
        maxlen = max(len(ln) for ln in chunk)
        if maxlen * 4 * len(chunk) > MAX_U_BYTES:
            yield from _rows_to_batches(
                (ln.split(delim) for ln in chunk), header,
                len(chunk), sum(len(ln) for ln in chunk))
            continue
        arr = np.asarray(chunk, dtype=np.str_)
        counts = np.char.count(arr, delim)
        width = int(counts[0]) + 1 if len(counts) else 1
        if not (counts == width - 1).all():
            # Ragged rows: the uniform-width partition trick would
            # conflate "absent field" with "empty field"; per-row path.
            yield from _rows_to_batches(
                (ln.split(delim) for ln in chunk), header,
                len(chunk), sum(len(ln) for ln in chunk))
            continue
        names = _csv_names(header, width)
        cols: dict[str, Column] = {}
        rest = arr
        for j in range(width):
            if j < width - 1:
                part = np.char.partition(rest, delim)
                field, rest = part[:, 0], part[:, 2]
            else:
                field = rest
            cols[names[j]] = Column(names[j], "str", raw=field)
        yield ColumnBatch(names, cols, len(chunk),
                          sum(len(ln) + 1 for ln in chunk))


def _csv_slow_batches(text: str, delim: str, quote: str, escape: str,
                      mode: str, comments: str, batch_rows: int):
    """Row-by-row builder sharing readers' chunked parse (quote
    parity, distinct escape handling, CRLF, comments)."""
    import csv as _csv
    import io

    chunk_chars = (readers.CSV_CHUNK_BYTES if escape == quote
                   else max(len(text), 1))
    header: list[str] | None = None
    first = True
    pend_rows: list[list[str]] = []
    pend_chars = 0

    def flush():
        nonlocal pend_rows, pend_chars
        if pend_rows:
            rows, chars = pend_rows, pend_chars
            pend_rows, pend_chars = [], 0
            yield from _rows_to_batches(rows, header, len(rows), chars)

    for chunk in readers._csv_chunks(text, quote, chunk_chars):
        if quote not in chunk and escape not in chunk:
            rows_iter = []
            for line in chunk.split("\n"):
                if line.endswith("\r"):
                    line = line[:-1]
                if line:
                    rows_iter.append(line.split(delim))
        else:
            reader = _csv.reader(
                io.StringIO(chunk), delimiter=delim, quotechar=quote,
                doublequote=(escape == quote),
                escapechar=(None if escape == quote else escape))
            rows_iter = [row for row in reader if row]
        for row in rows_iter:
            if comments and row[0].startswith(comments):
                continue
            if first:
                first = False
                if mode == "USE":
                    header = [h.strip() for h in row]
                    continue
                if mode == "IGNORE":
                    continue
            pend_rows.append(row)
            pend_chars += sum(len(f) + 1 for f in row)
            if len(pend_rows) >= batch_rows:
                yield from flush()
    yield from flush()


def _rows_to_batches(rows_iter, header: list[str] | None, nrows: int,
                     nbytes: int):
    """list-of-fields rows -> one ColumnBatch (ragged rows carry a
    MISSING mask; extra fields past the header become _N columns)."""
    rows = list(rows_iter)
    if not rows:
        return
    width = max(len(r) for r in rows)
    names = _csv_names(header, width)
    cols: dict[str, Column] = {}
    n = len(rows)
    for j in range(width):
        vals = [""] * n
        miss = None
        for i, r in enumerate(rows):
            if j < len(r):
                vals[i] = r[j]
            else:
                if miss is None:
                    miss = np.zeros(n, dtype=bool)
                miss[i] = True
        cols[names[j]] = Column(names[j], "str", raw=vals, miss=miss)
    yield ColumnBatch(names, cols, n, nbytes)


# ---------------------------------------------------------------------------
# Parquet -> column batches
# ---------------------------------------------------------------------------


def parquet_column_batches(data: bytes, wanted: set[str] | None = None):
    """Yield one ColumnBatch per Parquet row group, decoding ONLY the
    columns the query references (projection/predicate pushdown —
    ``wanted`` None = all).  Numeric pages decode via np.frombuffer,
    dictionary-encoded strings stay as (codes, dictionary) so string
    predicates evaluate once per distinct value."""
    from . import parquet as pq
    cols, groups = pq.read_footer(data)
    by_name = {c.name: c for c in cols}
    names = [c.name for c in cols]
    if wanted is None:
        take = names
    else:
        # sql.Col resolves case-INSENSITIVELY; pruning must keep any
        # column a case-mismatched reference could still resolve to,
        # or the scan silently types it as absent.
        wanted_lower = {w.lower() for w in wanted}
        take = [n for n in names
                if n in wanted or n.lower() in wanted_lower]
    for g in groups:
        nrows = g["num_rows"]
        batch_cols: dict[str, Column] = {}
        nbytes = 0
        for ch in g["chunks"]:
            name = ch.path[-1] if ch.path else ""
            col = by_name.get(name)
            if col is None or name not in take:
                continue
            decoded = pq.decode_chunk_np(data, ch, col)
            nbytes += decoded["unc_bytes"]
            if nrows == 0:
                nrows = decoded["nrows"]
            batch_cols[name] = _parquet_column(name, col, decoded)
        # Columns the query never touches still need MISSING/None
        # semantics on materialized records: represent them as
        # all-null placeholders ONLY when the caller asked for all
        # columns (SELECT *); pruned scans never materialize them.
        yield ColumnBatch([n for n in names if n in batch_cols],
                          batch_cols, nrows, nbytes)


def _parquet_column(name: str, col, decoded: dict) -> Column:
    from . import parquet as pq
    null = decoded["null"]
    if decoded.get("codes") is not None:
        return Column(name, "str", null=null,
                      codes=decoded["codes"],
                      dict_values=decoded["dict"])
    vals = decoded["values"]
    if col.ptype == pq.BOOLEAN:
        return Column(name, "bool", raw=vals, null=null)
    if col.ptype == pq.BYTE_ARRAY:
        return Column(name, "str", raw=vals, null=null)
    return Column(name, "num", raw=vals, null=null,
                  intish=(col.ptype in (pq.INT32, pq.INT64)))
