"""Row-engine tier of the columnar scan engine — the ONE module the
columnar scan path may evaluate ``sql.Node.eval`` per record from
(mtpu-lint R10 pins that boundary; everything else in the scan path
must stay vectorized).

Three jobs:

- **fallback rows**: rows the vectorized predicate marked undecidable
  (division by zero, exact-integer overflow, complex-LIKE prefilter
  survivors) re-evaluate here with full row semantics, in row order —
  including the row engine's raise-on-division-by-zero behavior;
- **row-tier batches**: a batch whose shape the compiler refused
  (schema drift, over-wide strings) runs entirely here;
- **projection**: output rows materialize through the row engine's
  projection semantics (alias naming, MISSING -> None), evaluated only
  for rows that PASSED the scan — at low selectivity this is the
  cheap tail of the query, and it is exactly oracle-identical.

The port's own copy of ``minio_tpu/s3select/fallback.py``, with no change in
behaviour.
"""

from __future__ import annotations

from . import sql
from .sql import MISSING


def eval_where(where: sql.Node | None, rec: dict) -> bool:
    """Row-engine WHERE semantics for one record (raises SQLError
    exactly where the row engine would, e.g. division by zero)."""
    return where is None or where.eval(rec) is True


def eval_arg(node: sql.Node, rec: dict):
    """Row-engine evaluation of one expression (aggregate args, the
    exact-typed min/max winner)."""
    return node.eval(rec)


def project_one(query: sql.Query, rec: dict):
    """The row engine's projection of one record (sql.execute's inner
    ``project``, verbatim semantics)."""
    if query.projections is None:
        return rec
    row = {}
    for i, p in enumerate(query.projections):
        v = p.expr.eval(rec)
        if v is MISSING:
            v = None
        row[p.alias or sql._projection_name(p.expr, i)] = v
    return row


def project_rows(query: sql.Query, recs: list[dict]) -> list[dict]:
    return [project_one(query, rec) for rec in recs]


def agg_update(query: sql.Query, states: list, rec: dict) -> None:
    """One record's aggregate accumulation (row engine semantics —
    COUNT(expr) skips NULL/MISSING, numeric coercion per value)."""
    for a, st in zip(query.aggregates, states):
        st.update(a.arg.eval(rec) if a.arg is not None else 1)
