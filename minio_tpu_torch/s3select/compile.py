"""AST -> vectorized-plan compiler for the columnar scan engine.

Lowers the row engine's predicate/projection AST (sql.py Cmp / Arith /
Between / In / IsNull / BoolOp / Not / Neg / Like / Col / Lit) to a
tree of vectorized ops over ColumnBatch columns.  Everything the
lowering cannot decide EXACTLY lands in one of two escapes:

- ``CompileError`` at compile time (unsupported node — functions,
  nested paths, LIKE over non-string values): the engine runs the
  whole query on the row oracle instead;
- the per-row **fallback mask** at eval time (division by zero where
  the row engine raises, intish intermediates past float64's 2^53
  exact-integer range, complex-LIKE prefilter survivors): those rows
  re-evaluate on the row engine (s3select/fallback.py), so the
  vectorized path never has to approximate.

Values flow as ``VV`` triples-of-masks (SQL three-valued logic):
``valid`` is False where the value is NULL/MISSING, ``miss`` marks
MISSING specifically (``IS MISSING``), ``fb`` is the accumulated
fallback mask.  Numeric math runs in float64 with an ``intish`` flag:
results that stay within 2^53 are bit-exact against the row engine's
python-int arithmetic, results beyond it fall back.

Plans whose ops are all comparisons/boolean logic over float32/int32/
bool columns with float32-exact literals are additionally **kernel
eligible** (``Plan.jit_ok``, the reference's name): ops/select_kernels.py
lowers the node tree to a postfix program that the predicate-scan
kernel (csrc/select_scan.cu) or its plain PyTorch version runs in
float32, because every represented value is exact in float32 there too.

The port's own copy of ``minio_tpu/s3select/compile.py``. The
reference also evaluates this node tree under ``jax.numpy`` (its jit
lanes, through ``Ctx.arrays``); the port runs such plans as programs
instead, so its ``Ctx`` is the host (numpy) context only.
"""

from __future__ import annotations

import numpy as np

from . import sql
from .columnar import INT_EXACT, ColumnBatch

# int32 cells past float32's exact-integer range (2^24) fall back when
# a plan runs on the float32 predicate kernel.
F32_EXACT = float(1 << 24)


class CompileError(Exception):
    """This query (or node) has no exact vectorized lowering; the row
    engine serves it."""


class VV:
    """One vectorized value: kind "num" | "str" | "bool" | "null".

    val:   ndarray or python scalar (literals stay scalar and
           broadcast); for kind "str" a Column object or a python str.
    valid: bool ndarray or True — False = SQL NULL/MISSING.
    miss:  bool ndarray or False — MISSING specifically.
    fb:    bool ndarray or None — rows needing the row-engine fallback.
    intish: numeric value lives in the exact-integer domain (guards
           apply to intermediates).
    """

    __slots__ = ("kind", "val", "valid", "miss", "fb", "intish")

    def __init__(self, kind, val, valid=True, miss=False, fb=None,
                 intish=False):
        self.kind = kind
        self.val = val
        self.valid = valid
        self.miss = miss
        self.fb = fb
        self.intish = intish


def _and(a, b):
    """Logical-and of masks where either side may be a python bool."""
    if a is True:
        return b
    if b is True:
        return a
    if a is False or b is False:
        return False
    return a & b


def _or(a, b):
    if a is True or b is True:
        return True
    if a is False:
        return b
    if b is False:
        return a
    return a | b


def _not(xp, a):
    if a is True:
        return False
    if a is False:
        return True
    return ~a


def _fb_union(*masks):
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out | m)
    return out


def _full(ctx, value: bool):
    return ctx.xp.full(ctx.n, value, dtype=bool)


def _asarray(ctx, mask):
    """Materialize a possibly-scalar mask to a full bool array."""
    if mask is True or mask is False:
        return _full(ctx, bool(mask))
    return mask


class Ctx:
    """Evaluation context: ``xp`` is numpy; the ColumnBatch serves
    column lookups and string ops."""

    def __init__(self, xp, n: int, batch: ColumnBatch | None = None):
        self.xp = xp
        self.n = n
        self.batch = batch


# -- nodes ------------------------------------------------------------------


class CNode:
    def run(self, ctx: Ctx) -> VV:  # pragma: no cover - interface
        raise NotImplementedError


class CLit(CNode):
    def __init__(self, value):
        self.value = value
        if value is None:
            self.kind = "null"
        elif isinstance(value, bool):
            self.kind = "bool"
        elif isinstance(value, (int, float)):
            if isinstance(value, int) and abs(value) > INT_EXACT:
                # A float64 image of this literal is lossy while the
                # row engine compares exact ints — no exact lowering.
                raise CompileError("integer literal past 2^53")
            self.kind = "num"
        elif isinstance(value, str):
            self.kind = "str"
        else:
            raise CompileError(f"literal {type(value).__name__}")

    def run(self, ctx: Ctx) -> VV:
        if self.kind == "null":
            return VV("null", None, valid=False)
        if self.kind == "num":
            return VV("num", float(self.value),
                      intish=isinstance(self.value, int))
        return VV(self.kind, self.value)


class CCol(CNode):
    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind   # schema kind from the first batch

    def run(self, ctx: Ctx) -> VV:
        col = ctx.batch.col(self.name)
        if col is None:
            absent = _full(ctx, True)
            return VV("null", None, valid=_full(ctx, False),
                      miss=absent)
        if col.kind != self.kind:
            raise CompileError(
                f"column {self.name} changed kind "
                f"({self.kind} -> {col.kind})")
        valid = ~col.null_mask()
        miss = col.miss_mask()
        if col.kind == "num":
            vals, fb = col.f64()
            return VV("num", vals, valid=valid, miss=miss, fb=fb,
                      intish=col.intish)
        if col.kind == "bool":
            return VV("bool", np.asarray(col.raw, dtype=bool),
                      valid=valid, miss=miss)
        return VV("str", col, valid=valid, miss=miss)


def _as_num(ctx, vv: VV):
    """The row engine's `_num` coercion, vectorized:
    (float64 vals, ok mask, fb, intish).  ok is False where coercion
    fails OR the value is NULL — a Cmp treats those differently from
    an Arith, so callers combine with vv.valid themselves."""
    if vv.kind == "num":
        return vv.val, vv.valid, vv.fb, vv.intish
    if vv.kind == "str":
        if isinstance(vv.val, str):
            n = sql._num(vv.val)
            if n is None:
                return 0.0, False, vv.fb, False
            return float(n), vv.valid, vv.fb, isinstance(n, int)
        vals, ok, fb = vv.val.strnum()
        return vals, _and(vv.valid, ok), _fb_union(vv.fb, fb), True
    # bool / null: _num() answers None
    return 0.0, False, vv.fb, False


def _str_apply(ctx, col_or_str, fn):
    """Apply a vectorized string predicate.  Dictionary-backed columns
    evaluate once per DISTINCT value and gather through the codes —
    the dictionary trick that makes string predicates O(cardinality)
    instead of O(rows)."""
    if isinstance(col_or_str, str):
        u = np.asarray([col_or_str], dtype=np.str_)
        return bool(np.asarray(fn(u))[0])
    rep = col_or_str.str_rep()
    if rep is None:
        raise CompileError("string column too wide to vectorize")
    if rep[0] == "dict":
        _, dict_u, codes = rep
        small = np.asarray(fn(dict_u), dtype=bool)
        return small[np.clip(codes, 0, None)]
    return np.asarray(fn(rep[1]), dtype=bool)


def _str_u(col_or_str):
    """Full U-array for a string VV payload (col-vs-col compares)."""
    if isinstance(col_or_str, str):
        return col_or_str
    rep = col_or_str.str_rep()
    if rep is None:
        raise CompileError("string column too wide to vectorize")
    if rep[0] == "dict":
        _, dict_u, codes = rep
        return dict_u[np.clip(codes, 0, None)]
    return rep[1]


_CMP_FNS = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class CCmp(CNode):
    def __init__(self, op: str, left: CNode, right: CNode):
        if op not in _CMP_FNS:
            raise CompileError(f"comparison {op}")
        self.op = op
        self.left = left
        self.right = right

    def run(self, ctx: Ctx) -> VV:
        lv = self.left.run(ctx)
        rv = self.right.run(ctx)
        fn = _CMP_FNS[self.op]
        valid = _and(lv.valid, rv.valid)   # NULL operand -> NULL
        fb = _fb_union(lv.fb, rv.fb)
        kinds = (lv.kind, rv.kind)
        if "bool" in kinds:
            if kinds == ("bool", "bool"):
                val = fn(lv.val, rv.val)
            else:
                val = False   # bool vs non-bool coerces to no-match
            return VV("bool", val, valid=valid, fb=fb)
        if "num" in kinds:
            la, lok, lfb, _ = _as_num(ctx, lv)
            ra, rok, rfb, _ = _as_num(ctx, rv)
            ok = _and(lok, rok)
            with np.errstate(invalid="ignore"):
                cmp = fn(la, ra)
            # coercion failure -> False (not NULL), like _coerced_pair
            val = _and(cmp, ok)
            return VV("bool", val, valid=valid,
                      fb=_fb_union(fb, lfb, rfb))
        if kinds == ("str", "str"):
            lu, ru = _str_u(lv.val), _str_u(rv.val)
            if isinstance(lu, str) and isinstance(ru, str):
                val = fn(lu, ru)
            elif isinstance(ru, str):
                val = _str_apply(ctx, lv.val, lambda u: fn(u, ru))
            elif isinstance(lu, str):
                val = _str_apply(ctx, rv.val, lambda u: fn(lu, u))
            else:
                val = fn(lu, ru)
            return VV("bool", val, valid=valid, fb=fb)
        # null literal somewhere, or unpairable kinds -> False under
        # a defined pair, NULL otherwise (valid already covers it).
        return VV("bool", False, valid=valid, fb=fb)


_ARITH_OPS = ("+", "-", "*", "/", "%")


class CArith(CNode):
    def __init__(self, op: str, left: CNode, right: CNode):
        if op not in _ARITH_OPS:
            raise CompileError(f"arith {op}")
        self.op = op
        self.left = left
        self.right = right

    def run(self, ctx: Ctx) -> VV:
        lv = self.left.run(ctx)
        rv = self.right.run(ctx)
        la, lok, lfb, li = _as_num(ctx, lv)
        ra, rok, rfb, ri = _as_num(ctx, rv)
        # _num failure on either side -> NULL result
        ok = _and(_and(lok, lv.valid), _and(rok, rv.valid))
        fb = _fb_union(lv.fb, rv.fb, lfb, rfb)
        with np.errstate(all="ignore"):
            if self.op == "+":
                val = la + ra
            elif self.op == "-":
                val = la - ra
            elif self.op == "*":
                val = la * ra
            elif self.op == "/":
                div0 = _and(ok, ra == 0)
                val = np.divide(la, np.where(ra == 0, 1.0, ra))
                # the row engine RAISES on division by zero: those
                # rows must re-evaluate there, in row order
                fb = _fb_union(fb, _asarray(ctx, div0)
                               if div0 is not False else None)
            else:  # %
                div0 = _and(ok, ra == 0)
                val = np.mod(la, np.where(ra == 0, 1.0, ra))
                fb = _fb_union(fb, _asarray(ctx, div0)
                               if div0 is not False else None)
        intish = li and ri and self.op != "/"
        if intish:
            with np.errstate(invalid="ignore"):
                big = _and(ok, np.abs(val) >= INT_EXACT)
            if big is not False:
                fb = _fb_union(fb, _asarray(ctx, big))
        return VV("num", val, valid=ok, fb=fb, intish=intish)


class CNeg(CNode):
    def __init__(self, inner: CNode):
        self.inner = inner

    def run(self, ctx: Ctx) -> VV:
        vv = self.inner.run(ctx)
        a, ok, fb, intish = _as_num(ctx, vv)
        return VV("num", -a if ok is not False else 0.0,
                  valid=_and(ok, vv.valid),
                  fb=_fb_union(vv.fb, fb), intish=intish)


class CBetween(CNode):
    def __init__(self, value: CNode, lo: CNode, hi: CNode,
                 negate: bool):
        self.lo_cmp = CCmp(">=", value, lo)
        self.hi_cmp = CCmp("<=", value, hi)
        self.negate = negate

    def run(self, ctx: Ctx) -> VV:
        lo = self.lo_cmp.run(ctx)
        hi = self.hi_cmp.run(ctx)
        # Between NULL-propagates when EITHER bound compare is NULL,
        # even if the other is already False (unlike AND).
        valid = _and(lo.valid, hi.valid)
        val = _and(lo.val, hi.val)
        if self.negate:
            val = _not(ctx.xp, val)
        return VV("bool", val, valid=valid,
                  fb=_fb_union(lo.fb, hi.fb))


class CIn(CNode):
    def __init__(self, value: CNode, options: list[CNode],
                 negate: bool):
        self.value = value
        self.cmps = [CCmp("=", value, o) for o in options]
        self.negate = negate

    def run(self, ctx: Ctx) -> VV:
        vv = self.value.run(ctx)
        hit = False
        fb = vv.fb
        for c in self.cmps:
            cv = c.run(ctx)
            hit = _or(hit, _and(cv.val, cv.valid))
            fb = _fb_union(fb, cv.fb)
        val = _not(ctx.xp, hit) if self.negate else hit
        return VV("bool", val, valid=vv.valid, fb=fb)


class CIsNull(CNode):
    def __init__(self, value: CNode, negate: bool, missing: bool):
        self.value = value
        self.negate = negate
        self.missing = missing

    def run(self, ctx: Ctx) -> VV:
        vv = self.value.run(ctx)
        val = vv.miss if self.missing else _not(ctx.xp, vv.valid)
        if self.negate:
            val = _not(ctx.xp, val)
        return VV("bool", val, fb=vv.fb)


def _truthy(ctx, vv: VV):
    """python bool(value), vectorized — BoolOp applies it to raw
    operand values (a non-empty string is truthy, 0 is not)."""
    if vv.kind == "bool":
        return vv.val
    if vv.kind == "num":
        with np.errstate(invalid="ignore"):
            return vv.val != 0
    if vv.kind == "str":
        if isinstance(vv.val, str):
            return bool(vv.val)
        return _str_apply(ctx, vv.val,
                          lambda u: np.char.str_len(u) > 0)
    return False   # null literal (valid=False masks it anyway)


def _bool_operand(ctx, vv: VV):
    """(truth, defined) of one BoolOp/Not operand.  The row engine
    applies ``bool(value)`` to the RAW operand — and MISSING is a bare
    ``object()``, so ``bool(MISSING)`` is TRUE and defined, unlike
    NULL (None), which is undefined.  Only a literal None is NULL
    here; a missing field participates as truthy."""
    defined = _or(vv.valid, vv.miss)
    truth = _or(_and(_truthy(ctx, vv), vv.valid), vv.miss)
    return truth, defined


class CBool(CNode):
    def __init__(self, op: str, left: CNode, right: CNode):
        self.op = op
        self.left = left
        self.right = right

    def run(self, ctx: Ctx) -> VV:
        lv = self.left.run(ctx)
        rv = self.right.run(ctx)
        ta, va = _bool_operand(ctx, lv)
        tb, vb = _bool_operand(ctx, rv)
        fb = _fb_union(lv.fb, rv.fb)
        both = _and(va, vb)
        if self.op == "and":
            fa = _and(va, _not(ctx.xp, ta))
            fbse = _and(vb, _not(ctx.xp, tb))
            decided_false = _or(fa, fbse)
            valid = _or(decided_false, both)
            val = _and(ta, tb)
            return VV("bool", val, valid=valid, fb=fb)
        decided_true = _or(ta, tb)
        valid = _or(decided_true, both)
        return VV("bool", decided_true, valid=valid, fb=fb)


class CNot(CNode):
    def __init__(self, inner: CNode):
        self.inner = inner

    def run(self, ctx: Ctx) -> VV:
        vv = self.inner.run(ctx)
        t, defined = _bool_operand(ctx, vv)
        return VV("bool", _and(_not(ctx.xp, t), defined),
                  valid=defined, fb=vv.fb)


class CLike(CNode):
    """[NOT] LIKE with a literal pattern.  Patterns without ``_``
    lower EXACTLY (prefix/suffix/ordered-segment containment via
    np.char); patterns with ``_`` vectorize a necessary-condition
    prefilter (longest literal run containment) and hand survivors to
    the per-row fallback."""

    def __init__(self, value: CNode, pattern: str,
                 escape: str | None, negate: bool):
        self.value = value
        self.negate = negate
        self.lead, self.trail, self.runs, self.exact = \
            _like_parse(pattern, escape)

    def run(self, ctx: Ctx) -> VV:
        vv = self.value.run(ctx)
        if vv.kind == "null":   # LIKE over NULL/MISSING -> NULL
            return VV("bool", False, valid=vv.valid, fb=vv.fb)
        if vv.kind != "str":
            raise CompileError("LIKE over a non-string value")
        if self.exact:
            val = _str_apply(
                ctx, vv.val,
                lambda u: _like_vec(u, self.runs, self.lead,
                                    self.trail))
            if self.negate:
                val = _not(ctx.xp, val)
            return VV("bool", val, valid=vv.valid, fb=vv.fb)
        # Complex pattern (`_` present): vectorized prefilter, row
        # fallback for candidates.  Rows failing the prefilter are
        # DEFINITELY non-matching (negate -> definitely matching).
        longest = max(self.runs, key=len, default="")
        if longest:
            cand = _str_apply(
                ctx, vv.val,
                lambda u: np.char.find(u, longest) >= 0)
        else:
            cand = True
        cand = _and(cand, vv.valid)
        val = _full(ctx, self.negate)
        fb = _fb_union(vv.fb, _asarray(ctx, cand))
        return VV("bool", val, valid=vv.valid, fb=fb)


def _like_parse(pattern: str, escape: str | None):
    """Tokenize a LIKE pattern (mirroring sql.like_to_re's escape
    handling) -> (leading %, trailing %, literal runs, exact?)."""
    toks: list[tuple] = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            toks.append(("lit", pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            toks.append(("%",))
        elif ch == "_":
            toks.append(("_",))
        else:
            toks.append(("lit", ch))
        i += 1
    exact = all(t[0] != "_" for t in toks)
    runs: list[str] = []
    cur: list[str] = []
    for t in toks:
        if t[0] == "lit":
            cur.append(t[1])
        else:
            if cur:
                runs.append("".join(cur))
                cur = []
    if cur:
        runs.append("".join(cur))
    lead = bool(toks) and toks[0][0] != "lit"
    trail = bool(toks) and toks[-1][0] != "lit"
    if not toks:
        lead = trail = False
    return lead, trail, runs, exact


def _like_vec(u, runs: list[str], lead: bool, trail: bool):
    """Exact `%`-only LIKE over a U array: greedy leftmost segment
    matching (correct for the *-only glob class)."""
    n = len(u)
    if not runs:
        # only wildcards ("%", "%%", ...) or the empty pattern
        return (np.ones(n, dtype=bool) if lead or trail
                else u == "")
    if not lead and not trail and len(runs) == 1:
        return u == runs[0]
    lens = np.char.str_len(u)
    ok = np.ones(n, dtype=bool)
    pos = np.zeros(n, dtype=np.int64)
    rem = list(runs)
    if not lead:
        s0 = rem.pop(0)
        ok &= np.char.startswith(u, s0)
        pos[:] = len(s0)
    last = rem.pop() if (not trail and rem) else None
    for m in rem:
        idx = np.char.find(u, m, pos)
        ok &= idx >= 0
        pos = np.where(idx >= 0, idx + len(m), pos)
    if last is not None:
        ok &= np.char.endswith(u, last)
        ok &= (lens - len(last)) >= pos
    return ok


# -- lowering ---------------------------------------------------------------


def lower(node: sql.Node, batch: ColumnBatch) -> CNode:
    """One sql.py AST node -> vectorized node, typed against the
    schema of the first batch.  Raises CompileError for anything
    without an exact lowering."""
    if isinstance(node, sql.Lit):
        return CLit(node.value)
    if isinstance(node, sql.Col):
        if len(node.path) != 1 or not isinstance(node.path[0], str):
            raise CompileError("nested column path")
        name = node.path[0]
        col = batch.col(name)
        kind = col.kind if col is not None else "null"
        return CCol(name, kind)
    if isinstance(node, sql.Cmp):
        return CCmp(node.op, lower(node.left, batch),
                    lower(node.right, batch))
    if isinstance(node, sql.Arith):
        return CArith(node.op, lower(node.left, batch),
                      lower(node.right, batch))
    if isinstance(node, sql.Neg):
        return CNeg(lower(node.inner, batch))
    if isinstance(node, sql.Between):
        return CBetween(lower(node.value, batch),
                        lower(node.lo, batch),
                        lower(node.hi, batch), node.negate)
    if isinstance(node, sql.In):
        return CIn(lower(node.value, batch),
                   [lower(o, batch) for o in node.options],
                   node.negate)
    if isinstance(node, sql.IsNull):
        return CIsNull(lower(node.value, batch), node.negate,
                       node.missing)
    if isinstance(node, sql.BoolOp):
        return CBool(node.op, lower(node.left, batch),
                     lower(node.right, batch))
    if isinstance(node, sql.Not):
        return CNot(lower(node.inner, batch))
    if isinstance(node, sql.Like):
        if not isinstance(node.pattern, sql.Lit) or \
                not isinstance(node.pattern.value, str):
            raise CompileError("non-literal LIKE pattern")
        vc = lower(node.value, batch)
        if isinstance(vc, CCol) and vc.kind in ("num", "bool"):
            # str(numeric) formatting has no exact vectorized twin
            raise CompileError("LIKE over a non-string column")
        if isinstance(vc, CLit) and vc.kind not in ("str", "null"):
            raise CompileError("LIKE over a non-string literal")
        return CLike(vc, node.pattern.value, node.escape, node.negate)
    raise CompileError(f"no lowering for {type(node).__name__}")


class Plan:
    """A lowered predicate/expression plus its dispatch metadata."""

    def __init__(self, root: CNode):
        self.root = root
        self.cols: list[str] = []
        self.col_kinds: dict[str, str] = {}
        self.has_str = False
        self.has_arith = False
        self.f32_safe = True
        # A non-bool root (WHERE age) never passes — passing_mask
        # handles it on the host; the kernel's program would hand back
        # a value that is no row mask.
        self.root_bool = isinstance(
            root, (CCmp, CBool, CNot, CBetween, CIn, CIsNull, CLike))
        self._walk(root)
        self._program = None   # ops/select_kernels.py's lowering, cached

    def _walk(self, node: CNode) -> None:
        if isinstance(node, CCol):
            if node.name not in self.col_kinds:
                self.cols.append(node.name)
                self.col_kinds[node.name] = node.kind
            if node.kind == "str":
                self.has_str = True
        elif isinstance(node, CLit):
            if node.kind == "str":
                self.has_str = True
            elif node.kind == "num":
                v = node.value
                if not (abs(v) <= F32_EXACT
                        and float(np.float32(v)) == float(v)):
                    self.f32_safe = False
        elif isinstance(node, (CArith, CNeg)):
            self.has_arith = True
        elif isinstance(node, CLike):
            self.has_str = True
        for attr in ("left", "right", "inner", "value", "lo_cmp",
                     "hi_cmp"):
            child = getattr(node, attr, None)
            if isinstance(child, CNode):
                self._walk(child)
        for child in getattr(node, "cmps", ()):
            self._walk(child)

    @property
    def jit_ok(self) -> bool:
        """Kernel eligible — exact under float32: comparisons/boolean
        logic only over a bool-producing root, no string ops, f32-exact
        literals — int64/float64 columns are excluded at bind (their
        f32 image is lossy)."""
        return (self.root_bool and not self.has_str
                and not self.has_arith and self.f32_safe)

    def eval_host(self, batch: ColumnBatch) -> VV:
        return self.root.run(Ctx(np, batch.nrows, batch=batch))


def passing_mask(vv: VV, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(pass, fb) row masks from a root predicate VV: a row passes
    iff the value `is True` — a non-bool result (WHERE age) never
    passes, NULL never passes.  fb rows are undecided and excluded
    from pass."""
    fb = (np.zeros(n, dtype=bool) if vv.fb is None
          else np.broadcast_to(np.asarray(vv.fb), (n,)))
    if vv.kind != "bool":
        return np.zeros(n, dtype=bool), fb
    val = np.broadcast_to(np.asarray(vv.val), (n,))
    valid = np.broadcast_to(np.asarray(vv.valid), (n,))
    return val & valid & ~fb, fb
