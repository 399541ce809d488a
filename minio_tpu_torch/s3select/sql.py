"""S3 Select SQL: tokenizer, recursive-descent parser, evaluator
(ref pkg/s3select/sql — the reference uses a participle grammar +
dynamic-typed evaluator; same language subset here).

Supported: SELECT projections (*, expressions, aliases), FROM
S3Object[.path] with alias, WHERE with AND/OR/NOT, comparisons,
BETWEEN, [NOT] LIKE (with ESCAPE), [NOT] IN, IS [NOT] NULL/MISSING,
arithmetic + - * / %, functions (LOWER UPPER TRIM LTRIM RTRIM
CHAR_LENGTH CHARACTER_LENGTH SUBSTRING COALESCE NULLIF CAST ABS),
aggregates (COUNT SUM AVG MIN MAX), LIMIT.

Dynamic typing mirrors the reference: CSV fields are strings; a
comparison against a numeric operand attempts numeric coercion, and
rows where coercion fails simply don't match (SQL null semantics).

The port's own copy of ``minio_tpu/s3select/sql.py``, with no change in
behaviour.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class SQLError(Exception):
    """Parse or evaluation error -> S3 error InvalidQuery."""


MISSING = object()   # field absent (distinct from SQL NULL)


# -- tokenizer -------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<string>'(?:[^']|'')*')
  | (?P<op><>|<=|>=|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.|\[|\])
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "limit", "as", "and", "or", "not",
    "between", "like", "escape", "in", "is", "null", "missing", "true",
    "false", "cast",
}


@dataclass
class Tok:
    kind: str   # number ident qident string op kw eof
    value: str


def tokenize(s: str) -> list[Tok]:
    out, pos = [], 0
    while pos < len(s):
        mo = _TOKEN_RE.match(s, pos)
        if not mo:
            raise SQLError(f"unexpected character {s[pos]!r} at {pos}")
        pos = mo.end()
        kind = mo.lastgroup
        if kind == "ws":
            continue
        val = mo.group()
        if kind == "ident" and val.lower() in KEYWORDS:
            out.append(Tok("kw", val.lower()))
        elif kind == "qident":
            out.append(Tok("ident", val[1:-1].replace('""', '"')))
        elif kind == "string":
            out.append(Tok("string", val[1:-1].replace("''", "'")))
        else:
            out.append(Tok(kind, val))
    out.append(Tok("eof", ""))
    return out


# -- AST -------------------------------------------------------------------

class Node:
    def eval(self, rec: dict):  # pragma: no cover - interface
        raise NotImplementedError


@dataclass
class Lit(Node):
    value: object

    def eval(self, rec):
        return self.value


@dataclass
class Col(Node):
    """Column/path reference, already stripped of the table alias.
    path items are str keys or int indexes."""
    path: tuple

    def eval(self, rec):
        cur = rec
        for p in self.path:
            if isinstance(p, int):
                if isinstance(cur, list) and 0 <= p < len(cur):
                    cur = cur[p]
                else:
                    return MISSING
            elif isinstance(cur, dict):
                if p in cur:
                    cur = cur[p]
                else:
                    # case-insensitive fallback (ref sql identifiers)
                    lowered = {k.lower(): v for k, v in cur.items()}
                    if p.lower() in lowered:
                        cur = lowered[p.lower()]
                    else:
                        return MISSING
            else:
                return MISSING
        return cur


@dataclass
class Star(Node):
    def eval(self, rec):
        return rec


def _num(v):
    """Best-effort numeric coercion; None on failure."""
    if v is MISSING or v is None or isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        try:
            f = float(v)
            return int(f) if f.is_integer() and ("." not in v
                                                 and "e" not in v.lower()
                                                 ) else f
        except ValueError:
            return None
    return None


def _is_null(v):
    return v is None or v is MISSING


@dataclass
class Arith(Node):
    op: str
    left: Node
    right: Node

    def eval(self, rec):
        a = _num(self.left.eval(rec))
        b = _num(self.right.eval(rec))
        if a is None or b is None:
            return None
        try:
            if self.op == "+":
                return a + b
            if self.op == "-":
                return a - b
            if self.op == "*":
                return a * b
            if self.op == "/":
                return a / b
            if self.op == "%":
                return a % b
        except ZeroDivisionError:
            raise SQLError("division by zero")
        raise SQLError(f"bad arith op {self.op}")


@dataclass
class Neg(Node):
    inner: Node

    def eval(self, rec):
        v = _num(self.inner.eval(rec))
        return None if v is None else -v


def _coerced_pair(a, b):
    """Dynamic typing: if either side is numeric, try numeric compare;
    else string compare; bools compare to bools."""
    if isinstance(a, bool) or isinstance(b, bool):
        if isinstance(a, bool) and isinstance(b, bool):
            return a, b
        return None
    if isinstance(a, (int, float)) or isinstance(b, (int, float)):
        na, nb = _num(a), _num(b)
        if na is None or nb is None:
            return None
        return na, nb
    if isinstance(a, str) and isinstance(b, str):
        return a, b
    return None


@dataclass
class Cmp(Node):
    op: str
    left: Node
    right: Node

    def eval(self, rec):
        a = self.left.eval(rec)
        b = self.right.eval(rec)
        if _is_null(a) or _is_null(b):
            return None
        pair = _coerced_pair(a, b)
        if pair is None:
            return False
        a, b = pair
        return {"=": a == b, "!=": a != b, "<>": a != b,
                "<": a < b, "<=": a <= b,
                ">": a > b, ">=": a >= b}[self.op]


@dataclass
class Between(Node):
    value: Node
    lo: Node
    hi: Node
    negate: bool

    def eval(self, rec):
        lo = Cmp(">=", self.value, self.lo).eval(rec)
        hi = Cmp("<=", self.value, self.hi).eval(rec)
        if lo is None or hi is None:
            return None
        r = lo and hi
        return (not r) if self.negate else r


def like_to_re(pattern: str, escape: str | None) -> re.Pattern:
    out, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


@dataclass
class Like(Node):
    value: Node
    pattern: Node
    escape: str | None
    negate: bool

    def eval(self, rec):
        v = self.value.eval(rec)
        p = self.pattern.eval(rec)
        if _is_null(v) or _is_null(p):
            return None
        r = bool(like_to_re(str(p), self.escape).match(str(v)))
        return (not r) if self.negate else r


@dataclass
class In(Node):
    value: Node
    options: list
    negate: bool

    def eval(self, rec):
        v = self.value.eval(rec)
        if _is_null(v):
            return None
        hit = any(Cmp("=", Lit(v), o).eval(rec) is True
                  for o in self.options)
        return (not hit) if self.negate else hit


@dataclass
class IsNull(Node):
    value: Node
    negate: bool      # IS NOT NULL
    missing: bool     # IS [NOT] MISSING

    def eval(self, rec):
        v = self.value.eval(rec)
        r = (v is MISSING) if self.missing else _is_null(v)
        return (not r) if self.negate else r


@dataclass
class BoolOp(Node):
    op: str           # and | or
    left: Node
    right: Node

    def eval(self, rec):
        a = self.left.eval(rec)
        b = self.right.eval(rec)
        av = None if a is None else bool(a)
        bv = None if b is None else bool(b)
        if self.op == "and":
            if av is False or bv is False:
                return False
            if av is None or bv is None:
                return None
            return True
        if av is True or bv is True:
            return True
        if av is None or bv is None:
            return None
        return False


@dataclass
class Not(Node):
    inner: Node

    def eval(self, rec):
        v = self.inner.eval(rec)
        return None if v is None else (not bool(v))


def _cast(v, typ: str):
    if _is_null(v):
        return None
    t = typ.lower()
    try:
        if t in ("int", "integer", "bigint", "smallint"):
            return int(float(v))
        if t in ("float", "double", "decimal", "numeric", "real"):
            return float(v)
        if t in ("string", "varchar", "char", "text"):
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, float) and v.is_integer():
                return str(int(v))
            return str(v)
        if t in ("bool", "boolean"):
            if isinstance(v, str):
                if v.lower() in ("true", "1"):
                    return True
                if v.lower() in ("false", "0"):
                    return False
                raise ValueError(v)
            return bool(v)
    except (ValueError, TypeError):
        raise SQLError(f"cannot cast {v!r} to {typ}")
    raise SQLError(f"unsupported cast type {typ}")


@dataclass
class Func(Node):
    name: str
    args: list

    def eval(self, rec):
        n = self.name
        if n == "cast":
            return _cast(self.args[0].eval(rec), self.args[1].value)
        vals = [a.eval(rec) for a in self.args]
        if n == "coalesce":
            for v in vals:
                if not _is_null(v):
                    return v
            return None
        if n == "nullif":
            return None if Cmp("=", Lit(vals[0]),
                               Lit(vals[1])).eval(rec) is True else vals[0]
        if n in ("lower", "upper", "trim", "ltrim", "rtrim"):
            v = vals[0]
            if _is_null(v):
                return None
            s = str(v)
            return {"lower": s.lower, "upper": s.upper, "trim": s.strip,
                    "ltrim": s.lstrip, "rtrim": s.rstrip}[n]()
        if n in ("char_length", "character_length", "length"):
            v = vals[0]
            return None if _is_null(v) else len(str(v))
        if n == "abs":
            v = _num(vals[0])
            return None if v is None else abs(v)
        if n == "substring":
            v = vals[0]
            if _is_null(v):
                return None
            s = str(v)
            ns = _num(vals[1])
            start = int(ns) if ns is not None else 1
            ln = int(_num(vals[2])) if len(vals) > 2 else None
            # SQL SUBSTRING: 1-based; start below 1 clamps but the end
            # position start+len is computed from the ORIGINAL start.
            i0 = max(start - 1, 0)
            if ln is None:
                return s[i0:]
            end = max(start - 1 + ln, i0)
            return s[i0:end]
        raise SQLError(f"unknown function {n}")


AGG_FUNCS = {"count", "sum", "avg", "min", "max"}


@dataclass
class Agg(Node):
    """Aggregate placeholder; accumulated by the executor."""
    name: str
    arg: Node | None   # None = COUNT(*)
    index: int = -1    # slot in the accumulator array

    def eval(self, rec):  # only valid after finalize; executor swaps
        raise SQLError("aggregate outside aggregation context")


# -- parser ----------------------------------------------------------------

@dataclass
class Projection:
    expr: Node
    alias: str | None


@dataclass
class Query:
    projections: list[Projection] | None   # None = SELECT *
    where: Node | None
    limit: int | None
    aggregates: list[Agg]
    table_path: tuple   # path under S3Object, e.g. FROM S3Object.a.b


class Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.i = 0
        self.alias = "s3object"
        self.aggregates: list[Agg] = []

    # token helpers
    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: str | None = None) -> Tok | None:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: str | None = None) -> Tok:
        t = self.accept(kind, value)
        if t is None:
            raise SQLError(
                f"expected {value or kind}, got {self.peek().value!r}")
        return t

    def _int_token(self, what: str) -> int:
        t = self.expect("number")
        try:
            return int(t.value)
        except ValueError:
            raise SQLError(f"{what} must be an integer, got {t.value!r}")

    # grammar
    def parse(self) -> Query:
        self.expect("kw", "select")
        # FROM clause first pass: find alias so column refs can strip it.
        save = self.i
        depth = 0
        table_path: tuple = ()
        while True:
            t = self.peek()
            if t.kind == "eof":
                break
            if t.kind == "op" and t.value == "(":
                depth += 1
            if t.kind == "op" and t.value == ")":
                depth -= 1
            if t.kind == "kw" and t.value == "from" and depth == 0:
                self.next()
                table_path = self._parse_from()
                break
            self.next()
        end_from = self.i
        self.i = save

        projections = self._parse_projections()
        if self.peek().kind == "kw" and self.peek().value == "from":
            self.i = end_from   # skip the FROM clause we already parsed
        where = None
        limit = None
        if self.accept("kw", "where"):
            where = self._expr()
        if self.accept("kw", "limit"):
            limit = self._int_token("LIMIT")
        self.expect("eof")
        return Query(projections, where, limit, self.aggregates,
                     table_path)

    def _parse_from(self) -> tuple:
        t = self.expect("ident")
        if t.value.lower() != "s3object":
            raise SQLError("FROM must reference S3Object")
        path = []
        while self.accept("op", "."):
            path.append(self.expect("ident").value)
        if self.accept("kw", "as"):
            self.alias = self.expect("ident").value.lower()
        elif self.peek().kind == "ident":
            self.alias = self.next().value.lower()
        return tuple(path)

    def _parse_projections(self) -> list[Projection] | None:
        if self.accept("op", "*"):
            return None
        projs = []
        while True:
            e = self._expr()
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect("ident").value
            elif self.peek().kind == "ident":
                alias = self.next().value
            projs.append(Projection(e, alias))
            if not self.accept("op", ","):
                break
        return projs

    def _expr(self) -> Node:
        return self._or()

    def _or(self) -> Node:
        left = self._and()
        while self.accept("kw", "or"):
            left = BoolOp("or", left, self._and())
        return left

    def _and(self) -> Node:
        left = self._not()
        while self.accept("kw", "and"):
            left = BoolOp("and", left, self._not())
        return left

    def _not(self) -> Node:
        if self.accept("kw", "not"):
            return Not(self._not())
        return self._predicate()

    def _predicate(self) -> Node:
        left = self._additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=",
                                          ">", ">="):
            self.next()
            return Cmp(t.value, left, self._additive())
        negate = False
        if (t.kind == "kw" and t.value == "not"
                and self.toks[self.i + 1].kind == "kw"
                and self.toks[self.i + 1].value in ("between", "like",
                                                    "in")):
            self.next()
            negate = True
            t = self.peek()
        if t.kind == "kw" and t.value == "between":
            self.next()
            lo = self._additive()
            self.expect("kw", "and")
            return Between(left, lo, self._additive(), negate)
        if t.kind == "kw" and t.value == "like":
            self.next()
            pattern = self._additive()
            esc = None
            if self.accept("kw", "escape"):
                esc = str(self.expect("string").value)
            return Like(left, pattern, esc, negate)
        if t.kind == "kw" and t.value == "in":
            self.next()
            self.expect("op", "(")
            opts = [self._expr()]
            while self.accept("op", ","):
                opts.append(self._expr())
            self.expect("op", ")")
            return In(left, opts, negate)
        if t.kind == "kw" and t.value == "is":
            self.next()
            neg = bool(self.accept("kw", "not"))
            if self.accept("kw", "missing"):
                return IsNull(left, neg, missing=True)
            self.expect("kw", "null")
            return IsNull(left, neg, missing=False)
        return left

    def _additive(self) -> Node:
        left = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = Arith(t.value, left, self._multiplicative())
            else:
                return left

    def _multiplicative(self) -> Node:
        left = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = Arith(t.value, left, self._unary())
            else:
                return left

    def _unary(self) -> Node:
        if self.accept("op", "-"):
            return Neg(self._unary())
        if self.accept("op", "+"):
            return self._unary()
        return self._primary()

    def _primary(self) -> Node:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.value)
            return Lit(int(v) if v.is_integer() and "." not in t.value
                       and "e" not in t.value.lower() else v)
        if t.kind == "string":
            self.next()
            return Lit(t.value)
        if t.kind == "kw" and t.value in ("true", "false"):
            self.next()
            return Lit(t.value == "true")
        if t.kind == "kw" and t.value == "null":
            self.next()
            return Lit(None)
        if t.kind == "kw" and t.value == "cast":
            self.next()
            self.expect("op", "(")
            inner = self._expr()
            self.expect("kw", "as")
            typ = self.expect("ident").value
            self.expect("op", ")")
            return Func("cast", [inner, Lit(typ)])
        if t.kind == "op" and t.value == "(":
            self.next()
            e = self._expr()
            self.expect("op", ")")
            return e
        if t.kind == "ident":
            # function call?
            if self.toks[self.i + 1].kind == "op" and \
                    self.toks[self.i + 1].value == "(":
                name = self.next().value.lower()
                self.next()  # (
                if name in AGG_FUNCS:
                    return self._aggregate(name)
                args = []
                if not self.accept("op", ")"):
                    args.append(self._expr())
                    while self.accept("op", ","):
                        args.append(self._expr())
                    self.expect("op", ")")
                return Func(name, args)
            return self._column_ref()
        raise SQLError(f"unexpected token {t.value!r}")

    def _aggregate(self, name: str) -> Node:
        if name == "count" and self.accept("op", "*"):
            self.expect("op", ")")
            agg = Agg(name, None, len(self.aggregates))
        else:
            arg = self._expr()
            self.expect("op", ")")
            agg = Agg(name, arg, len(self.aggregates))
        self.aggregates.append(agg)
        return agg

    def _column_ref(self) -> Node:
        first = self.expect("ident").value
        path: list = []
        if first.lower() not in (self.alias, "s3object"):
            path.append(first)
        while True:
            if self.accept("op", "."):
                path.append(self.expect("ident").value)
            elif self.accept("op", "["):
                idx = self._int_token("array index")
                self.expect("op", "]")
                path.append(idx)
            else:
                break
        if not path:
            return Star()
        return Col(tuple(path))


def parse(sql: str) -> Query:
    return Parser(tokenize(sql)).parse()


# -- execution -------------------------------------------------------------

class _AggState:
    __slots__ = ("name", "count", "total", "minv", "maxv")

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.minv = None
        self.maxv = None

    def update(self, v):
        if self.name == "count":
            if not _is_null(v):  # COUNT(expr) skips NULL/MISSING
                self.count += 1
            return
        n = _num(v)
        if n is None:
            return
        self.count += 1
        self.total += n
        self.minv = n if self.minv is None else min(self.minv, n)
        self.maxv = n if self.maxv is None else max(self.maxv, n)

    def result(self):
        if self.name == "count":
            return self.count
        if self.name == "sum":
            return self.total if self.count else None
        if self.name == "avg":
            return self.total / self.count if self.count else None
        if self.name == "min":
            return self.minv
        return self.maxv


class _AggValue(Node):
    def __init__(self, value):
        self.value = value

    def eval(self, rec):
        return self.value


def execute(query: Query, records) -> list:
    """Run the query over an iterable of dict records. Returns a list of
    output records: dicts (projected) or the raw record for SELECT *."""
    out = []
    limit = query.limit

    def project(rec) -> dict:
        if query.projections is None:
            return rec
        row = {}
        for i, p in enumerate(query.projections):
            v = p.expr.eval(rec)
            if v is MISSING:
                v = None
            name = p.alias or _projection_name(p.expr, i)
            row[name] = v
        return row

    if query.aggregates:
        states = [_AggState(a.name) for a in query.aggregates]
        n = 0
        for rec in records:
            rec = _descend(rec, query.table_path)
            if rec is None:
                continue
            if query.where is not None and \
                    query.where.eval(rec) is not True:
                continue
            n += 1
            for a, st in zip(query.aggregates, states):
                st.update(a.arg.eval(rec) if a.arg is not None else 1)
        # swap Agg nodes for computed values, then project once
        for a, st in zip(query.aggregates, states):
            a.eval = _AggValue(st.result()).eval  # type: ignore
        return [project({})]

    for rec in records:
        rec = _descend(rec, query.table_path)
        if rec is None:
            continue
        if query.where is not None and query.where.eval(rec) is not True:
            continue
        out.append(project(rec))
        if limit is not None and len(out) >= limit:
            break
    return out


def _descend(rec, path: tuple):
    for p in path:
        if isinstance(rec, dict) and p in rec:
            rec = rec[p]
        else:
            return None
    return rec


def _projection_name(expr: Node, i: int) -> str:
    if isinstance(expr, Col) and expr.path and \
            isinstance(expr.path[-1], str):
        return expr.path[-1]
    return f"_{i + 1}"
