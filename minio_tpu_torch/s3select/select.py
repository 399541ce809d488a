"""SelectObjectContent orchestrator: request XML -> readers -> SQL ->
event-stream response (ref S3Select, pkg/s3select/select.go:208,
Evaluate:398, NewS3Select:541).

The port's own copy of ``minio_tpu/s3select/select.py``. ``run_select``
takes a ``device``: the card (``"cuda"``, the default) runs the
columnar scan's predicate kernel, ``"cpu"`` its plain version, and
``"auto"`` the lane the codec autotuner measured fastest for each batch
(ops/select_kernels.py ``choose_lane``); without a card and without
``device="cpu"`` (or a CPU dispatch device under "auto") it raises.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from ..ops import _cuda
from . import message, readers, sql


class S3SelectError(Exception):
    def __init__(self, code: str, desc: str):
        super().__init__(desc)
        self.code = code
        self.description = desc


def _strip_ns(root: ET.Element) -> ET.Element:
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


def parse_request(body: bytes) -> dict:
    """Parse SelectObjectContentRequest XML into a plain dict
    (ref ParseSelectParameters)."""
    try:
        root = _strip_ns(ET.fromstring(body))
    except ET.ParseError as e:
        raise S3SelectError("MalformedXML", f"invalid request XML: {e}")
    if root.tag != "SelectObjectContentRequest":
        raise S3SelectError("MalformedXML",
                            f"unexpected root {root.tag}")
    expr = root.findtext("Expression") or ""
    etype = (root.findtext("ExpressionType") or "SQL").upper()
    if etype != "SQL":
        raise S3SelectError("InvalidExpressionType",
                            f"unsupported ExpressionType {etype}")
    req = {"expression": expr, "input": {}, "output": {},
           "progress": False}
    ins = root.find("InputSerialization")
    if ins is None:
        raise S3SelectError("MalformedXML", "missing InputSerialization")
    req["input"]["compression"] = ins.findtext("CompressionType") or "NONE"
    csv_el = ins.find("CSV")
    json_el = ins.find("JSON")
    parquet_el = ins.find("Parquet")
    if csv_el is not None:
        req["input"]["format"] = "CSV"
        req["input"]["csv"] = {
            "FileHeaderInfo": csv_el.findtext("FileHeaderInfo") or "NONE",
            "RecordDelimiter": csv_el.findtext("RecordDelimiter") or "\n",
            "FieldDelimiter": csv_el.findtext("FieldDelimiter") or ",",
            "QuoteCharacter": csv_el.findtext("QuoteCharacter") or '"',
            "QuoteEscapeCharacter":
                csv_el.findtext("QuoteEscapeCharacter") or '"',
            "Comments": csv_el.findtext("Comments") or "",
        }
    elif json_el is not None:
        req["input"]["format"] = "JSON"
        req["input"]["json"] = {
            "Type": json_el.findtext("Type") or "LINES"}
    elif parquet_el is not None:
        req["input"]["format"] = "Parquet"
        if req["input"]["compression"] not in ("", "NONE"):
            raise S3SelectError(
                "InvalidRequestParameter",
                "CompressionType must be NONE for Parquet input")
    else:
        raise S3SelectError(
            "MalformedXML",
            "InputSerialization needs CSV, JSON or Parquet")
    outs = root.find("OutputSerialization")
    if outs is None:
        raise S3SelectError("MalformedXML",
                            "missing OutputSerialization")
    ocsv = outs.find("CSV")
    ojson = outs.find("JSON")
    if ocsv is not None:
        req["output"]["format"] = "CSV"
        req["output"]["csv"] = {
            "RecordDelimiter": ocsv.findtext("RecordDelimiter") or "\n",
            "FieldDelimiter": ocsv.findtext("FieldDelimiter") or ",",
            "QuoteCharacter": ocsv.findtext("QuoteCharacter") or '"',
        }
    elif ojson is not None:
        req["output"]["format"] = "JSON"
        req["output"]["json"] = {
            "RecordDelimiter": ojson.findtext("RecordDelimiter") or "\n"}
    else:
        raise S3SelectError("MalformedXML",
                            "OutputSerialization needs CSV or JSON")
    prog = root.find("RequestProgress")
    if prog is not None and (prog.findtext("Enabled") or ""
                             ).lower() == "true":
        req["progress"] = True
    return req


def _execute(req: dict, data: bytes,
             device) -> tuple[list, int, str, int]:
    """Run the query -> (rows, processed_bytes, engine, fallback_rows).

    The columnar scan engine (s3select/engine.py) serves CSV/Parquet
    when it can lower the query EXACTLY; the row engine stays the
    oracle and the fallback.  processed_bytes is what the scan
    actually decoded (for a pruned Parquet scan: only the referenced
    columns' uncompressed pages) — the honest BytesProcessed."""
    from . import engine as scan_engine
    fmt = req["input"]["format"]
    if fmt == "Parquet":
        # Parquet is never additionally whole-object compressed
        # (pages carry their own codec, ref S3 API).
        import struct as _pstruct

        from .parquet import (ParquetError, parquet_records,
                              read_footer, uncompressed_size)
        try:
            query = sql.parse(req["expression"])
        except sql.SQLError:
            # Row-path error precedence: invalid DATA answers
            # InvalidDataSource before invalid SQL answers
            # InvalidQuery.  Footer-level validation only — a FULL
            # row decode here (what the row engine does) would burn
            # ~40s of CPU per bad query against a 256MiB object, an
            # error path any client can repeat; deep page corruption
            # paired with invalid SQL answers InvalidQuery instead,
            # a divergence only doubly-invalid requests can see.
            try:
                read_footer(data)
            except ParquetError as e:
                raise S3SelectError("InvalidDataSource", str(e))
            except (IndexError, ValueError, _pstruct.error, KeyError,
                    OverflowError, UnicodeDecodeError) as e:
                raise S3SelectError(
                    "InvalidDataSource",
                    f"malformed parquet: {type(e).__name__}: {e}")
            raise
        try:
            try:
                rows, info = scan_engine.scan(query, "Parquet", data,
                                              None, device)
                return (rows, info["processed"], info["engine"],
                        info["fallback_rows"])
            except scan_engine.Unsupported:
                pass
            except sql.SQLError:
                raise
            except (IndexError, ValueError, _pstruct.error, KeyError,
                    OverflowError, UnicodeDecodeError) as e:
                # The columnar decoder hits malformed input OUTSIDE
                # read_parquet's catch-all; same classification.
                raise S3SelectError(
                    "InvalidDataSource",
                    f"malformed parquet: {type(e).__name__}: {e}")
            records = list(parquet_records(data))
        except ParquetError as e:
            raise S3SelectError("InvalidDataSource", str(e))
        rows = sql.execute(query, records)
        try:
            processed = uncompressed_size(data)
        except ParquetError:
            processed = len(data)
        return rows, processed, "row", 0
    data = readers.decompress(data, req["input"].get("compression"))
    if fmt == "CSV":
        c = req["input"]["csv"]
        query = sql.parse(req["expression"])
        try:
            rows, info = scan_engine.scan(query, "CSV", data, c,
                                          device)
            return (rows, info["processed"], info["engine"],
                    info["fallback_rows"])
        except scan_engine.Unsupported:
            pass
        records = readers.csv_records(
            data,
            file_header_info=c["FileHeaderInfo"],
            field_delimiter=c["FieldDelimiter"],
            record_delimiter=c["RecordDelimiter"],
            quote_character=c["QuoteCharacter"],
            quote_escape_character=c["QuoteEscapeCharacter"],
            comments=c["Comments"])
    else:
        records = readers.json_records(
            data, json_type=req["input"]["json"]["Type"])
        query = sql.parse(req["expression"])
    rows = sql.execute(query, records)
    return rows, len(data), "row", 0


def _record_metrics(scanned: int, processed: int, returned: int,
                    engine: str, fallback_rows: int) -> None:
    from ..obs.metrics2 import METRICS2
    METRICS2.inc("minio_tpu_v2_select_scanned_bytes_total", None,
                 scanned)
    if processed:
        METRICS2.inc("minio_tpu_v2_select_processed_bytes_total",
                     None, processed)
    if returned:
        METRICS2.inc("minio_tpu_v2_select_returned_bytes_total",
                     None, returned)
    METRICS2.inc("minio_tpu_v2_select_requests_total",
                 {"engine": engine})
    if fallback_rows:
        METRICS2.inc("minio_tpu_v2_select_fallback_rows_total", None,
                     fallback_rows)


def run_select(req: dict, data: bytes, device="cuda") -> bytes:
    """Execute a parsed select request over object bytes; returns the
    full event-stream response body.  Progress/Stats events carry the
    REAL scan volume: BytesScanned = object bytes read, BytesProcessed
    = bytes the scan decoded (columnar Parquet scans prune to the
    referenced columns), BytesReturned = payload bytes.  The columnar
    scan's predicate dispatches run on ``device``."""
    from ..obs.span import TRACER
    from ..ops.select_kernels import resolve_scan_device
    device = resolve_scan_device(device)
    raw_len = len(data)
    processed = 0
    engine_used = "row"
    fallback_rows = 0
    try:
        # The span covers scan AND output serialization: a big result
        # set's formatting is scan work product, and a scan-bound
        # request must blame `scan-kernel`, not client-stream.
        with TRACER.span("select.scan") as span:
            rows, processed, engine_used, fallback_rows = \
                _execute(req, data, device)
            if span is not None and getattr(span, "tags", None) \
                    is not None:
                span.tags["engine"] = engine_used
                span.tags["rows"] = len(rows)
            if req["output"]["format"] == "CSV":
                o = req["output"]["csv"]
                payload = readers.format_csv(
                    rows, field_delimiter=o["FieldDelimiter"],
                    record_delimiter=o["RecordDelimiter"],
                    quote_character=o["QuoteCharacter"])
            else:
                payload = readers.format_json(
                    rows, record_delimiter=req["output"]["json"][
                        "RecordDelimiter"])
    except sql.SQLError as e:
        _record_metrics(raw_len, processed, 0, "error", fallback_rows)
        return message.error_message("InvalidQuery", str(e))
    except S3SelectError as e:
        _record_metrics(raw_len, processed, 0, "error", fallback_rows)
        return message.error_message(e.code, e.description)

    _record_metrics(raw_len, processed, len(payload), engine_used,
                    fallback_rows)
    frames = []
    if req.get("progress"):
        frames.append(message.progress_message(raw_len, processed,
                                               len(payload)))
    for i in range(0, len(payload), 1 << 20):
        frames.append(message.records_message(payload[i:i + (1 << 20)]))
    frames.append(message.stats_message(raw_len, processed,
                                        len(payload)))
    frames.append(message.end_message())
    return b"".join(frames)
