"""Columnar scan engine for SelectObjectContent.

Drives typed column batches (s3select/columnar.py) through the
compiled vectorized predicate (s3select/compile.py) dispatched by
ops/select_kernels.py, with the row engine (sql.execute) kept as the
semantics oracle and the fallback tier:

- queries the compiler cannot lower EXACTLY raise ``Unsupported`` and
  the caller runs the row oracle on the whole object;
- rows the vectorized path cannot decide (fallback mask) re-evaluate
  on the row tier IN ROW ORDER — including LIMIT interactions and the
  row engine's raise-on-division-by-zero behavior;
- output rows materialize as exact records and project through the
  row engine's projection code (s3select/fallback.py), so formatted
  output is byte-identical to the oracle;
- aggregates accumulate vectorized (COUNT/SUM/AVG via masked
  reductions with a LEFT-FOLD cumsum so float rounding matches the
  row engine's sequential ``total += n``; MIN/MAX recover the exact
  python-typed winner by re-evaluating the single winning row).

Set ``MINIO_SELECT_ENGINE=row`` to pin the row oracle (the bench's
paired runs and the differential suite use it).

The port's own copy of ``minio_tpu/s3select/engine.py``. ``scan`` takes
the ``device`` its predicate dispatches run on (ops/select_kernels.py):
``"cuda"`` launches the predicate-scan kernel, ``"cpu"`` runs its plain
version.
"""

from __future__ import annotations

import os

import numpy as np

from . import fallback, sql
from .columnar import csv_column_batches, parquet_column_batches
from .compile import CompileError, Plan, lower

ROW = "row"
COLUMNAR = "columnar"


class Unsupported(Exception):
    """No exact columnar lowering — the row oracle serves the query."""


def engine_mode() -> str:
    return os.environ.get("MINIO_SELECT_ENGINE", "").strip().lower()


def referenced_columns(query: sql.Query) -> set[str] | None:
    """Top-level column names the query touches, or None when it
    needs every column (SELECT *, bare-alias Star, nested paths)."""
    if query.projections is None:
        return None
    names: set[str] = set()
    nodes: list = [p.expr for p in query.projections]
    if query.where is not None:
        nodes.append(query.where)
    nodes.extend(a.arg for a in query.aggregates
                 if a.arg is not None)
    while nodes:
        node = nodes.pop()
        if isinstance(node, sql.Star):
            return None
        if isinstance(node, sql.Col):
            if not node.path or not isinstance(node.path[0], str):
                return None
            names.add(node.path[0])
            continue
        for attr in ("left", "right", "inner", "value", "lo", "hi",
                     "pattern", "arg"):
            child = getattr(node, attr, None)
            if isinstance(child, sql.Node):
                nodes.append(child)
        for child in getattr(node, "options", ()) or ():
            nodes.append(child)
        for child in getattr(node, "args", ()) or ():
            nodes.append(child)
    return names


def scan(query: sql.Query, fmt: str, data: bytes,
         csv_cfg: dict | None, device="cuda") -> tuple[list, dict]:
    """Run the query columnar -> (rows, info) with info carrying
    processed bytes / scanned rows / fallback-row count.  Raises
    Unsupported when the row oracle must serve it instead.  Predicate
    dispatches run on ``device``."""
    if engine_mode() == ROW:
        raise Unsupported("engine pinned to row")
    if query.table_path:
        raise Unsupported("FROM S3Object.path input")
    if fmt == "Parquet":
        wanted = referenced_columns(query)
        batches = parquet_column_batches(data, wanted)
    elif fmt == "CSV":
        c = csv_cfg or {}
        batches = csv_column_batches(
            data,
            file_header_info=c.get("FileHeaderInfo", "NONE"),
            field_delimiter=c.get("FieldDelimiter", ","),
            record_delimiter=c.get("RecordDelimiter", "\n"),
            quote_character=c.get("QuoteCharacter", '"'),
            quote_escape_character=c.get("QuoteEscapeCharacter", '"'),
            comments=c.get("Comments", ""))
    else:
        raise Unsupported(f"format {fmt}")
    return _run(query, batches, device)


class _Scan:
    """Per-query compiled state, built against the first batch."""

    def __init__(self, query: sql.Query, first_batch):
        self.query = query
        self.where_plan = (Plan(lower(query.where, first_batch))
                           if query.where is not None else None)
        self.arg_plans = [
            (Plan(lower(a.arg, first_batch))
             if a.arg is not None else None)
            for a in query.aggregates]


def _run(query: sql.Query, batches, device) -> tuple[list, dict]:
    from ..ops import select_kernels
    info = {"processed": 0, "rows": 0, "fallback_rows": 0,
            "engine": COLUMNAR}
    out: list = []
    limit = query.limit
    scan_state: _Scan | None = None
    agg_states = ([sql._AggState(a.name) for a in query.aggregates]
                  if query.aggregates else None)

    for batch in batches:
        info["processed"] += batch.nbytes
        info["rows"] += batch.nrows
        if scan_state is None:
            # CompileError here = no exact lowering for this query:
            # Unsupported, the caller reruns on the row oracle.
            try:
                scan_state = _Scan(query, batch)
            except CompileError as e:
                raise Unsupported(str(e))
        row_tier = False
        ok = fb = None
        if scan_state.where_plan is not None:
            try:
                ok, fb = select_kernels.eval_predicate(
                    scan_state.where_plan, batch, device)
            except CompileError:
                # batch-shape drift (schema change, over-wide
                # strings): this one batch runs on the row tier
                row_tier = True
        else:
            ok = np.ones(batch.nrows, dtype=bool)
            fb = np.zeros(batch.nrows, dtype=bool)

        if agg_states is not None:
            done = _agg_batch(query, scan_state, agg_states, batch,
                              ok, fb, row_tier, info)
            if not done:
                _agg_batch_rows(query, agg_states, batch, info)
            continue

        if row_tier:
            if _emit_batch_rows(query, batch, out, limit, info):
                break
            continue
        if _emit_batch(query, batch, ok, fb, out, limit, info):
            break

    if agg_states is not None:
        # Swap Agg nodes for computed values and project once — the
        # row engine's own finalize (sql.execute's aggregate tail).
        for a, st in zip(query.aggregates, agg_states):
            a.eval = sql._AggValue(st.result()).eval  # type: ignore
        return [fallback.project_one(query, {})], info
    return out, info


# -- row emission ------------------------------------------------------------


def _project_cols(query: sql.Query, batch, sel: list) -> list | None:
    """Vectorized projection for plain-Col (or SELECT *) projections:
    output dicts build column-wise from exact py values, skipping the
    per-row projector entirely.  None when any projection needs the
    row projector (computed expressions, aliases over functions) —
    value-identical either way: Col.eval on a materialized record IS
    the cell's py value, and MISSING projects as None."""
    if query.projections is None:
        return batch.records(sel)
    names: list[str] = []
    refs: list[str] = []
    for i, p in enumerate(query.projections):
        e = p.expr
        if not isinstance(e, sql.Col) or len(e.path) != 1 or \
                not isinstance(e.path[0], str):
            return None
        names.append(p.alias or sql._projection_name(e, i))
        refs.append(e.path[0])
    idx = np.asarray(sel, dtype=np.int64)
    cols_vals = []
    from .columnar import _ABSENT
    for cname in refs:
        col = batch.col(cname)
        if col is None:
            cols_vals.append([None] * len(idx))
            continue
        vals = col.py_values(idx)
        if col.miss is not None:
            vals = [None if v is _ABSENT else v for v in vals]
        cols_vals.append(vals)
    out = []
    for row in zip(*cols_vals):
        rec: dict = {}
        for n, v in zip(names, row):
            rec[n] = v
        out.append(rec)
    return out


def _emit_batch(query, batch, ok, fb, out: list, limit, info) -> bool:
    """Vectorized selection with in-order fallback resolution.
    Returns True when LIMIT is satisfied."""
    room = None if limit is None else limit - len(out)
    if room is not None and room <= 0:
        return True
    if not fb.any():
        idx = np.flatnonzero(ok)
        if room is not None:
            idx = idx[:room]
        sel = [int(i) for i in idx]
    else:
        # Fallback rows resolve in row order, exactly when the oracle
        # would reach them (a division-by-zero past LIMIT stays
        # unraised) — but the ok-runs BETWEEN fallback positions stay
        # vectorized, so one poisoned cell in an 8M-row batch doesn't
        # degrade the whole emission to a per-row python walk.
        sel: list = []
        start = 0
        full = False

        def take_run(end: int | None) -> bool:
            nonlocal start
            seg = np.flatnonzero(ok[start:end])
            if start:
                seg = seg + start
            if room is not None and len(sel) + len(seg) >= room:
                sel.extend(int(i) for i in seg[:room - len(sel)])
                return True
            sel.extend(int(i) for i in seg)
            return False

        for f in np.flatnonzero(fb).tolist():
            if take_run(f):
                full = True
                break
            info["fallback_rows"] += 1
            if fallback.eval_where(query.where, batch.record(f)):
                sel.append(f)
                if room is not None and len(sel) >= room:
                    full = True
                    break
            start = f + 1
        if not full:
            take_run(None)
    fast = _project_cols(query, batch, sel)
    if fast is None:
        fast = fallback.project_rows(query, batch.records(sel))
    out.extend(fast)
    return limit is not None and len(out) >= limit


def _emit_batch_rows(query, batch, out: list, limit, info) -> bool:
    """Whole batch on the row tier (compiler refused its shape)."""
    for i in range(batch.nrows):
        info["fallback_rows"] += 1
        rec = batch.record(i)
        if not fallback.eval_where(query.where, rec):
            continue
        out.append(fallback.project_one(query, rec))
        if limit is not None and len(out) >= limit:
            return True
    return False


# -- aggregates --------------------------------------------------------------


def _agg_batch(query, scan_state, states, batch, ok, fb, row_tier,
               info) -> bool:
    """Vectorized aggregate accumulation for one batch; returns False
    when the batch needs the ORDER-EXACT row tier instead (fallback
    rows present, NaN min/max poisoning, arg fallback)."""
    if row_tier or fb is None or fb.any():
        return False
    from .compile import Ctx, _as_num
    ctx = Ctx(np, batch.nrows, batch=batch)
    updates = []
    for a, st, aplan in zip(query.aggregates, states,
                            scan_state.arg_plans):
        if aplan is None:   # COUNT(*)
            updates.append((st, "count*", int(ok.sum()), None, None))
            continue
        try:
            vv = aplan.root.run(ctx)
        except CompileError:
            return False
        if vv.fb is not None and (ok & vv.fb).any():
            return False
        valid = np.broadcast_to(np.asarray(vv.valid),
                                (batch.nrows,))
        if a.name == "count":
            # COUNT(expr) counts non-NULL values, parseable or not
            updates.append((st, "count*", int((ok & valid).sum()),
                            None, None))
            continue
        vals, nok, nfb, _ = _as_num(ctx, vv)
        if nfb is not None and (ok & nfb).any():
            return False
        m = ok & valid & np.broadcast_to(np.asarray(nok),
                                         (batch.nrows,))
        vals = np.broadcast_to(np.asarray(vals, dtype=np.float64),
                               (batch.nrows,))
        sel = vals[m]
        if a.name in ("min", "max") and len(sel) and \
                np.isnan(sel).any():
            # python min/max treat NaN positionally; row tier decides
            return False
        updates.append((st, a.name, int(m.sum()), sel,
                        (a, np.flatnonzero(m))))
    # All aggregates vectorizable: commit the batch's updates.
    for st, name, cnt, sel, winner in updates:
        if name == "count*":
            st.count += cnt
            continue
        st.count += cnt
        if sel is None or not len(sel):
            continue
        # LEFT-FOLD sum: cumsum is sequential, so float rounding
        # matches the row engine's per-row `total += n` exactly.
        st.total = float(np.cumsum(
            np.concatenate(([st.total], sel)))[-1])
        if name in ("min", "max"):
            a, idxs = winner
            j = int(idxs[np.argmin(sel) if name == "min"
                         else np.argmax(sel)])
            cand = sql._num(fallback.eval_arg(a.arg,
                                              batch.record(j)))
            if name == "min":
                st.minv = (cand if st.minv is None
                           else min(st.minv, cand))
            else:
                st.maxv = (cand if st.maxv is None
                           else max(st.maxv, cand))
    return True


def _agg_batch_rows(query, states, batch, info) -> None:
    """Order-exact aggregate accumulation on the row tier."""
    for i in range(batch.nrows):
        info["fallback_rows"] += 1
        rec = batch.record(i)
        if fallback.eval_where(query.where, rec):
            fallback.agg_update(query, states, rec)
