"""Columnar S3 Select in the port, held to the JAX package.

- The predicate program (ops/select_kernels.py: ``lower_program`` +
  ``bind_columns`` + ``eval_program_plain``, the plain version of the
  predicate-scan kernel) against the JAX package's own ``_bind_jit`` +
  ``_run_jit`` on the CPU, (pass, fallback) mask for mask, over
  randomised jit-eligible predicates on nullable FLOAT / INT32 / BOOLEAN
  columns with NaNs, MISSING cells and absent columns, over computed
  operands, and over every dtype the bind takes (int edges at 2^24,
  uint32 past 2^31). A numpy model of the kernel's scheme (eight rows a
  thread, 8-bit masks, the bit stacks) is held to the JAX package too.
- Whole ``run_select(..., device="cpu")`` response bodies against the
  JAX package's ``run_select``, byte for byte, for CSV (ragged, quoted)
  and Parquet (none / snappy / gzip pages), on the columnar engine and on
  the row oracle.
- The device-free copies (request parsing, event-stream framing, snappy,
  the Parquet writer and reader) byte for byte.

Inputs are made from seeds with numpy / random. The kernel itself runs
only on a CUDA card: its test is ``gpu``-marked and skips here.
"""

from __future__ import annotations

import ast
import gzip
import random
import re
from pathlib import Path
from xml.sax.saxutils import escape

import numpy as np
import pytest
import torch

from minio_tpu.ops import select_kernels as ref_sk
from minio_tpu.s3select import columnar as ref_col
from minio_tpu.s3select import compile as ref_comp
from minio_tpu.s3select import message as ref_msg
from minio_tpu.s3select import parquet as ref_pq
from minio_tpu.s3select import select as ref_sel
from minio_tpu.s3select import sql as ref_sql
from minio_tpu.utils import snappy as ref_snappy
from minio_tpu_torch.ops import select_kernels as sk
from minio_tpu_torch.s3select import columnar as pcol
from minio_tpu_torch.s3select import compile as pcomp
from minio_tpu_torch.s3select import message as pmsg
from minio_tpu_torch.s3select import parquet as ppq
from minio_tpu_torch.s3select import select as psel
from minio_tpu_torch.s3select import sql as psql
from minio_tpu_torch.utils import snappy as psnappy

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _req_xml(expr: str, input_xml: str, output_xml: str = "<JSON/>",
             extra: str = "") -> bytes:
    return ("<SelectObjectContentRequest><Expression>" + escape(expr)
            + "</Expression><ExpressionType>SQL</ExpressionType>"
            "<InputSerialization>" + input_xml + "</InputSerialization>"
            "<OutputSerialization>" + output_xml + "</OutputSerialization>"
            + extra + "</SelectObjectContentRequest>").encode()


# ---------------------------------------------------------------------------
# the predicate program against the JAX jit image
# ---------------------------------------------------------------------------

# Literals that are exact in float32 (Plan.jit_ok admits them; a minus
# sign parses as negation, which is arithmetic and is not admitted).
_EXACT_NUMS = ["0", "1", "3", "7", "12", "40", "0.5", "0.25", "2.125",
               "1.75", "3.5", "16777216", "0.0009765625"]


def _mask_batches(seed: int, n: int):
    """The same seeded columns as a ColumnBatch of each package:
    f FLOAT (NULLs, MISSING, NaNs), i INT32 (NULLs, cells past 2^24),
    b BOOLEAN (NULLs, MISSING); z is absent."""
    rng = np.random.default_rng(seed)
    f = (np.round(rng.uniform(-4, 4, n) * 4) / 4).astype(np.float32)
    f[rng.random(n) < 0.08] = np.nan
    whole = rng.random(n) < 0.1
    f[whole] = rng.integers(-12, 41, whole.sum())
    f_null = rng.random(n) < 0.15
    f_miss = rng.random(n) < 0.08
    i = rng.integers(-12, 41, n).astype(np.int32)
    big = rng.random(n) < 0.02
    i[big] = rng.choice([1 << 25, -(1 << 25) - 3, (1 << 24) + 1], big.sum())
    i_null = rng.random(n) < 0.15
    b = rng.random(n) < 0.5
    b_null = rng.random(n) < 0.15
    b_miss = rng.random(n) < 0.05

    def make(mod):
        return mod.ColumnBatch(["f", "i", "b"], {
            "f": mod.Column("f", "num", raw=f, null=f_null, miss=f_miss),
            "i": mod.Column("i", "num", raw=i, null=i_null, intish=True),
            "b": mod.Column("b", "bool", raw=b, null=b_null, miss=b_miss),
        }, n, n * 9)

    return make(ref_col), make(pcol)


def _operand(rng: random.Random, kind: str) -> str:
    roll = rng.random()
    if kind == "bool":
        return rng.choice(["b", "TRUE", "FALSE", "b", "z", "NULL"])
    if roll < 0.55:
        return rng.choice(["f", "i", "f", "i", "z"])
    if roll < 0.95:
        return rng.choice(_EXACT_NUMS)
    return rng.choice(["NULL", "b", "TRUE"])


def _gen_eligible_pred(rng: random.Random, depth: int,
                       bare: bool = False) -> str:
    """cmp / BETWEEN / IN / IS [NOT] NULL / IS [NOT] MISSING / AND / OR /
    NOT over f, i, b, z and exact literals (the manner of
    tests/test_select_columnar.py::_gen_pred, without arithmetic,
    strings or inexact literals). ``bare`` admits a lone operand, which
    only a boolean operator may take (a lone operand at the root is no
    predicate)."""
    roll = rng.random()
    if depth <= 0 or roll < 0.3:
        kind = "bool" if rng.random() < 0.2 else "num"
        op = rng.choice(["=", "!=", "<>", "<", "<=", ">", ">="])
        return f"{_operand(rng, kind)} {op} {_operand(rng, kind)}"
    if roll < 0.42:
        neg = rng.choice(["", "NOT "])
        lo, hi = sorted(rng.sample(_EXACT_NUMS[:10], 2), key=float)
        if rng.random() < 0.1:
            lo = "NULL"
        return f"{_operand(rng, 'num')} {neg}BETWEEN {lo} AND {hi}"
    if roll < 0.54:
        neg = rng.choice(["", "NOT "])
        opts = [rng.choice(_EXACT_NUMS + ["NULL", "TRUE"])
                for _ in range(rng.randint(1, 4))]
        value = "b" if rng.random() < 0.15 else _operand(rng, "num")
        return f"{value} {neg}IN ({', '.join(opts)})"
    if roll < 0.66:
        mode = rng.choice(["NULL", "NOT NULL", "MISSING", "NOT MISSING"])
        value = rng.choice(["f", "i", "b", "z", "NULL", "3"])
        return f"{value} IS {mode}"
    if roll < 0.74 and bare:
        # A bare operand under a boolean operator: _truthy / MISSING.
        return rng.choice(["f", "i", "b", "z"])
    if roll < 0.84:
        return f"NOT ({_gen_eligible_pred(rng, depth - 1, True)})"
    op = rng.choice(["AND", "OR"])
    return (f"({_gen_eligible_pred(rng, depth - 1, True)}) {op} "
            f"({_gen_eligible_pred(rng, depth - 1, True)})")


def _plans(src: str, ref_batch, port_batch):
    rq = ref_sql.parse(f"SELECT * FROM S3Object WHERE {src}")
    pq_ = psql.parse(f"SELECT * FROM S3Object WHERE {src}")
    return (ref_comp.Plan(ref_comp.lower(rq.where, ref_batch)),
            pcomp.Plan(pcomp.lower(pq_.where, port_batch)))


def _port_masks(plan, batch):
    """(pass, fallback) of the port's plain version: lower_program +
    bind_columns + place_columns + eval_program_plain."""
    program = sk.lower_program(plan)
    assert program is not None
    bound = sk.bind_columns(plan, batch)
    assert bound is not None
    ok, fb = sk.eval_program_plain(program, sk.place_columns(bound, CPU),
                                   batch.nrows, CPU)
    return ok.numpy(), fb.numpy()


def _ref_masks(rp, rb, n: int):
    """(pass, fallback) of the JAX package's jit lane: _bind_jit +
    _run_jit and ``val & valid & ~fb``. The JAX jit image needs a column
    to size its masks (the reference fails over to the host lane), so a
    column-free plan is held to the host evaluation instead."""
    if not rp.cols:
        return ref_comp.passing_mask(rp.eval_host(rb), n)[0], \
            np.zeros(n, dtype=bool)
    arrs, ref_fb = ref_sk._bind_jit(rp, rb)
    val, valid = ref_sk._run_jit(rp, arrs, n)
    return np.asarray(val) & np.asarray(valid) & ~ref_fb, ref_fb


def _assert_same(got, want, src):
    assert np.array_equal(want[0], got[0]), src
    assert np.array_equal(want[1], got[1]), src


# The opcodes _gen_eligible_pred's plans emit (the stack forms and
# OP_TOUCH come from _EVERY_OPCODE and _gen_computed_pred).
_GENERATED_OPS = {sk.OP_CMP, sk.OP_BETWEEN, sk.OP_IN, sk.OP_PUSH, sk.OP_AND,
                  sk.OP_OR, sk.OP_NOT}


@pytest.mark.parametrize("seed", range(16))
def test_program_equals_jax_jit(seed):
    """lower_program + bind_columns + eval_program_plain == the JAX
    _bind_jit + _run_jit (pass = val & valid & ~fb, and fb), on every
    predicate: at least 10 plans over columns, and on until they have
    emitted every opcode the generator reaches."""
    rng = random.Random(seed)
    n = [1, 33, 257, 600][seed % 4]
    rb, pb = _mask_batches(seed, n)
    seen_ops = set()
    checked = 0
    while checked < 40 and (checked < 10 or not _GENERATED_OPS <= seen_ops):
        src = _gen_eligible_pred(rng, rng.randint(1, 3))
        rp, pp = _plans(src, rb, pb)
        assert rp.jit_ok and pp.jit_ok, src
        _assert_same(_port_masks(pp, pb), _ref_masks(rp, rb, n), src)
        if rp.cols:        # column-free plans are held to the host lane
            seen_ops |= sk.lower_program(pp).opcodes()
            checked += 1
    assert _GENERATED_OPS <= seen_ops, seen_ops


_EVERY_OPCODE = [
    "f < 0.5", "b = TRUE", "b < f", "f BETWEEN 1 AND 2.125",
    "i NOT IN (3, 7, NULL)", "z IS MISSING", "f IS NOT NULL",
    "f AND b", "NULL OR b", "NOT z", "NOT NULL", "i != i",
    "(f > 1 OR b) AND NOT (i BETWEEN NULL AND 7)", "b IN (TRUE, 3)",
    "f <> f", "NULL = f", "3 >= 3", "TRUE AND z",
    # A comparison, BETWEEN, IN or IS NULL over a computed value runs on
    # the stack (OP_*_STACK, OP_IN_END).
    "(f < 1) = b", "(f < 1) BETWEEN FALSE AND TRUE",
    "(f < 1) IN (TRUE, b, f < 2)", "(i = 3) IS NOT MISSING",
    "(f BETWEEN 1 AND 2) >= (b IS NULL)", "NOT ((b IN (TRUE)) <= z)",
    "b IN (i, TRUE)", "b IN (i, f) AND i IS NULL",
    "f = 0 OR (f = 1 OR (f = 2 OR (f = 3 OR (f = 4 OR b))))",
]


@pytest.mark.parametrize("src", _EVERY_OPCODE)
def test_program_equals_jax_jit_fixed(src):
    """Hand-picked predicates that between them emit every opcode."""
    rb, pb = _mask_batches(99, 300)
    rp, pp = _plans(src, rb, pb)
    _assert_same(_port_masks(pp, pb), _ref_masks(rp, rb, 300), src)


def test_fixed_predicates_cover_every_opcode():
    _, pb = _mask_batches(99, 8)
    ops = set()
    for src in _EVERY_OPCODE:
        q = psql.parse(f"SELECT * FROM S3Object WHERE {src}")
        ops |= sk.lower_program(pcomp.Plan(pcomp.lower(q.where, pb))
                                ).opcodes()
    assert ops == set(range(sk.N_OPS))
    # b IN (i, f): neither option compares with a bool, so no instruction
    # reads i and f but OP_TOUCH (for i's fallback rows).
    assert sk.OP_TOUCH in sk.lower_program(pcomp.Plan(pcomp.lower(
        psql.parse("SELECT * FROM S3Object WHERE b IN (i, f)").where, pb))
    ).opcodes()


def _gen_computed_pred(rng: random.Random, depth: int) -> str:
    """An eligible predicate whose comparisons, BETWEEN, IN and IS NULL
    also take computed (bool) operands, which the program keeps on the
    stack."""
    if depth <= 0:
        return _gen_eligible_pred(rng, 1)

    def sub():
        return f"({_gen_computed_pred(rng, depth - 1)})"

    def bool_operand():
        return rng.choice([sub(), "b", "TRUE", "FALSE", "NULL", "z", "f"])

    roll = rng.random()
    if roll < 0.3:
        op = rng.choice(["=", "!=", "<", "<=", ">", ">="])
        return f"{sub()} {op} {bool_operand()}"
    if roll < 0.45:
        neg = rng.choice(["", "NOT "])
        return f"{sub()} {neg}BETWEEN {bool_operand()} AND {bool_operand()}"
    if roll < 0.6:
        neg = rng.choice(["", "NOT "])
        opts = ", ".join(bool_operand() for _ in range(rng.randint(1, 3)))
        value = sub() if rng.random() < 0.7 else rng.choice(["b", "f"])
        return f"{value} {neg}IN ({opts})"
    if roll < 0.7:
        return f"{sub()} IS {rng.choice(['NULL', 'NOT NULL', 'MISSING'])}"
    if roll < 0.8:
        return f"NOT {sub()}"
    return f"{sub()} {rng.choice(['AND', 'OR'])} {sub()}"


@pytest.mark.parametrize("seed", range(8))
def test_program_on_the_stack_equals_jax_jit(seed):
    """Plans whose operands are computed values (the OP_*_STACK forms),
    against the JAX jit image."""
    rng = random.Random(500 + seed)
    n = [7, 64, 301][seed % 3]
    rb, pb = _mask_batches(500 + seed, n)
    for _ in range(8):
        src = _gen_computed_pred(rng, rng.randint(1, 3))
        rp, pp = _plans(src, rb, pb)
        assert rp.jit_ok and pp.jit_ok, src
        _assert_same(_port_masks(pp, pb), _ref_masks(rp, rb, n), src)


# Each bound dtype (bind_columns), with values at the edges of float32's
# exact-integer range: the reference's fallback rows are |v| > 2^24.
_EDGE_INTS = [0, 1, -1, 7, 40, 1 << 24, -(1 << 24), (1 << 24) + 1,
              -(1 << 24) - 1, -(1 << 31), (1 << 31) - 1]
_DTYPES = ["float16", "float32", "int8", "int16", "int32", "uint8",
           "uint16", "uint32", "bool"]
_DTYPE_PREDICATES = [
    "x < 7", "x = 16777216", "x >= 0 AND x <= 40", "x BETWEEN 1 AND 40",
    "x IN (0, 1, 7, 16777216)", "NOT x", "x OR z", "x IS NULL",
    "x IS MISSING", "x != x", "x > 0.5 OR x = 3", "(x < 1) = (z < 1)",
]


def _dtype_values(dtype: str, n: int, rng) -> np.ndarray:
    if dtype == "bool":
        return rng.random(n) < 0.5
    dt = np.dtype(dtype)
    if dt.kind == "f":
        vals = rng.choice(np.array([0, 1, -1, 0.5, 7, 40, np.nan, 3.5,
                                    16777216, 2.125]), n)
        with np.errstate(over="ignore"):    # float16: 2^24 -> inf
            return vals.astype(dt)
    info = np.iinfo(dt)
    base = rng.integers(max(info.min, -12), min(info.max, 41) + 1, n)
    edges = np.array([v for v in _EDGE_INTS
                      if info.min <= v <= info.max] + [info.min, info.max])
    pick = rng.random(n) < 0.3
    base[pick] = rng.choice(edges, pick.sum())
    if dtype == "uint32":   # cells past 2^31 must not read as negatives
        big = rng.random(n) < 0.15
        base[big] = rng.choice([2 ** 32 - 1, 2 ** 31, 2 ** 31 + 9,
                                (1 << 24) + 1], big.sum())
    return base.astype(dt)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_bound_dtypes_equal_jax_jit(dtype):
    """Every dtype the reference's _bind_jit takes gives its (pass,
    fallback) masks: ints at +-2^24, +-(2^24 + 1) and INT32_MIN, uint32
    past 2^31, NaN, REQUIRED and OPTIONAL (NULL, MISSING) columns and an
    absent one."""
    n = 131
    rng = np.random.default_rng(len(dtype))
    vals = _dtype_values(dtype, n, rng)
    null = rng.random(n) < 0.2
    miss = rng.random(n) < 0.1
    kind = "bool" if dtype == "bool" else "num"
    intish = np.dtype(dtype).kind in "iu"
    for masks in ({}, {"null": null}, {"null": null, "miss": miss}):
        def batch(mod):
            return mod.ColumnBatch(["x"], {"x": mod.Column(
                "x", kind, raw=vals, intish=intish, **masks)}, n, 4 * n)

        rb, pb = batch(ref_col), batch(pcol)
        for src in _DTYPE_PREDICATES:
            rp, pp = _plans(src, rb, pb)
            assert sk.bind_columns(pp, pb) is not None, (dtype, src)
            _assert_same(_port_masks(pp, pb), _ref_masks(rp, rb, n),
                         (dtype, masks.keys(), src))


# -- a numpy model of the kernel's scheme ---------------------------------------

_M32 = np.uint64(0xFFFFFFFF)
# Rows a thread: the kernel's own kRows, read from its source.
_R = int(re.search(r"constexpr int kRows = (\d+);",
                   (Path(sk.__file__).resolve().parent.parent / "csrc" /
                    "select_scan.cu").read_text())[1])


def _stack_words(depth: int) -> int:
    """The kernel's select_scan_stack_words: 32-bit words of a stack of
    ``depth`` R-bit entries, 1, 2 or enough for MAX_STACK."""
    bits = depth * _R
    return 1 if bits <= 32 else 2 if bits <= 64 else sk.MAX_STACK * _R // 32


def _group_words(arr: np.ndarray, n: int) -> np.ndarray:
    """(G, R) uint32: the 4-byte words of each thread's R rows (the
    kernel's 16-byte loads), zero past n."""
    g = -(-n // _R)
    w = np.zeros(_R * g, dtype=np.uint32)
    w[:n] = arr.view(np.uint32)
    return w.reshape(g, _R)


def _group_mask(arr, n: int) -> np.ndarray:
    """(G,) uint64: the kernel's R-bit mask of nonzero bytes (a 4-byte
    load per four rows, __vcmpne4, the 0x01020408 multiply)."""
    g = -(-n // _R)
    m = np.zeros(g, dtype=np.uint64)
    if arr is None:
        return m
    b = np.zeros(_R * g, dtype=np.uint8)
    b[:n] = np.asarray(arr).view(np.uint8)
    words = b.view("<u4").astype(np.uint64).reshape(g, _R // 4)
    for k in range(_R // 4):
        ones = np.zeros(g, dtype=np.uint64)
        for r in range(4):
            byte = (words[:, k] >> np.uint64(8 * r)) & np.uint64(0xFF)
            ones |= (byte != 0).astype(np.uint64) << np.uint64(8 * r)
        nib = (((ones * np.uint64(0x01020408)) & _M32) >> np.uint64(24)) \
            & np.uint64(0xF)
        m |= nib << np.uint64(4 * k)
    return m


def _pack(rows: np.ndarray) -> np.ndarray:
    """(G, R) bool -> (G,) uint64 R-bit masks (bit r = row r)."""
    return (rows.astype(np.uint64) << np.arange(_R, dtype=np.uint64)).sum(
        axis=1, dtype=np.uint64)


class _ModelStack:
    """The kernel's BitStack<NW>: R-bit entries in NW 32-bit words,
    shifted by funnel shifts on push and pop."""

    def __init__(self, nw: int, g: int):
        self.w = [np.zeros(g, dtype=np.uint64) for _ in range(nw)]

    def push(self, e):
        w, r = self.w, np.uint64(_R)
        for i in range(len(w) - 1, 0, -1):
            w[i] = ((w[i] << r) | (w[i - 1] >> (np.uint64(32) - r))) & _M32
        w[0] = ((w[0] << r) | e) & _M32

    def pop(self):
        w, r = self.w, np.uint64(_R)
        e = w[0] & np.uint64((1 << _R) - 1)
        for i in range(len(w) - 1):
            w[i] = (w[i] >> r) | ((w[i + 1] << (np.uint64(32) - r)) & _M32)
        w[-1] = w[-1] >> r
        return e


def _kernel_model(program, bound: list, n: int):
    """numpy model of csrc/select_scan.cu over bind_columns output:
    R rows a thread with every flag an R-bit mask, fallback rows found
    where an int column is read (the unsigned 2^24 test), fused leaf
    comparisons, the two bit stacks, and the 0x00204081 byte expansion of
    the stores. Returns (pass, fb) bytes."""
    g = -(-n // _R)
    full = np.uint64((1 << _R) - 1)
    zero = np.zeros(g, np.uint64)
    cols = []
    for vals, code, null, miss in bound:
        if code == sk.DT_ABSENT:
            cols.append((np.zeros((g, _R), np.float32), zero, np.full(g, full),
                         zero))
            continue
        mi = _group_mask(miss, n)
        valid = ~(_group_mask(null, n) | mi) & full
        big = zero
        if code == sk.DT_BOOL:
            bits = _group_mask(vals, n)
            image = ((bits[:, None] >> np.arange(_R, dtype=np.uint64)) & 1
                     ).astype(np.float32)
        else:
            w = _group_words(vals, n)
            if code == sk.DT_F32:
                image = w.view(np.float32)
            elif code == sk.DT_I32:
                big = _pack(((w.astype(np.uint64) + (1 << 24)) & _M32)
                            > (2 << 24))
                image = w.view(np.int32).astype(np.float32)
            else:
                big = _pack(w > (1 << 24))
                image = w.astype(np.float32)
        cols.append((image, valid, mi, big & valid))
    fb = zero.copy()

    def leaf(ref):
        nonlocal fb
        if ref >= 0:
            image, valid, mi, big = cols[ref]
            fb = fb | big
            return image, valid, mi
        value, valid = program.pool[~ref]
        return (np.full((g, _R), value, np.float32),
                np.full(g, full if valid else 0, np.uint64), zero)

    st = _ModelStack(_stack_words(program.depth), g)
    sv = _ModelStack(_stack_words(program.depth), g)
    cmp_bits = [lambda a, b: ~(a ^ b), lambda a, b: a ^ b,
                lambda a, b: ~a & b, lambda a, b: ~a | b,
                lambda a, b: a & ~b, lambda a, b: a | ~b]
    for word, a, b, c in program.ops.tolist():
        op, code = word & 0xFF, (word >> sk.F_CMP_SHIFT) & 7
        neg = full if word & sk.F_NEG else np.uint64(0)
        cmp = [np.equal, np.not_equal, np.less, np.less_equal, np.greater,
               np.greater_equal][code]
        with np.errstate(invalid="ignore"):
            if op == sk.OP_CMP:
                x, y = leaf(a), leaf(b)
                v = x[1] & y[1]
                st.push(_pack(cmp(x[0], y[0])) & v
                        if word & sk.F_COMPARES else zero)
                sv.push(v)
            elif op == sk.OP_BETWEEN:
                x, lo, hi = leaf(a), leaf(b), leaf(c)
                vlo, vhi = x[1] & lo[1], x[1] & hi[1]
                tlo = _pack(x[0] >= lo[0]) & vlo \
                    if word & sk.F_COMPARES else zero
                thi = _pack(x[0] <= hi[0]) & vhi \
                    if word & sk.F_COMPARES_HI else zero
                st.push(((tlo & thi) ^ neg) & vlo & vhi)
                sv.push(vlo & vhi)
            elif op == sk.OP_IN:
                x = leaf(a)
                hit = zero
                for ref in program.args[b:b + c].tolist():
                    o = leaf(ref)
                    hit = hit | (_pack(x[0] == o[0]) & o[1])
                st.push((hit ^ neg) & x[1])
                sv.push(x[1])
            elif op == sk.OP_PUSH:
                x = leaf(a)
                mode = (word >> sk.F_MODE_SHIFT) & 3
                if mode in (sk.MODE_ISNULL, sk.MODE_ISMISSING):
                    t = ~x[1] if mode == sk.MODE_ISNULL else x[2]
                    st.push((t ^ neg) & full)
                    sv.push(np.full(g, full))
                    continue
                truthy = zero if word & sk.F_NULL_KIND else _pack(x[0] != 0)
                t = truthy & x[1]
                if mode == sk.MODE_VALUE:
                    st.push(t)
                    sv.push(x[1])
                else:
                    st.push(t | x[2])
                    sv.push(x[1] | x[2])
            elif op in (sk.OP_CMP_STACK, sk.OP_BETWEEN_STACK, sk.OP_AND,
                        sk.OP_OR):
                tb, vb, ta, va = st.pop(), sv.pop(), st.pop(), sv.pop()
                if op == sk.OP_CMP_STACK:
                    v = va & vb
                    t = cmp_bits[code](ta, tb) & v \
                        if word & sk.F_COMPARES else zero
                elif op == sk.OP_BETWEEN_STACK:
                    v = va & vb
                    t = ((ta & tb) ^ neg) & v
                elif op == sk.OP_AND:
                    t = ta & tb
                    v = (va & ~ta) | (vb & ~tb) | (va & vb)
                else:
                    t = ta | tb
                    v = t | (va & vb)
                st.push(t & full)
                sv.push(v & full)
            elif op == sk.OP_IN_END:
                hit, _, _, v = st.pop(), sv.pop(), st.pop(), sv.pop()
                st.push((hit ^ neg) & v)
                sv.push(v)
            elif op == sk.OP_ISNULL_STACK:
                st.pop()
                v = sv.pop()
                t = zero if word & sk.F_MISSING else ~v
                st.push((t ^ neg) & full)
                sv.push(np.full(g, full))
            elif op == sk.OP_NOT:
                t, v = st.pop(), sv.pop()
                st.push(~t & v & full)
                sv.push(v)
            elif op == sk.OP_TOUCH:
                leaf(a)
            else:
                raise AssertionError(f"opcode {op}")
    fb = fb & _pack(np.arange(_R * g).reshape(g, _R) < n)
    ok = st.pop() & ~fb & full

    def bytes_of(m):
        w = np.stack([((m >> np.uint64(4 * k)) & np.uint64(0xF))
                      * np.uint64(0x00204081) & np.uint64(0x01010101)
                      for k in range(_R // 4)], axis=1).astype("<u4")
        return w.view(np.uint8).reshape(-1)[:n].view(bool)

    return bytes_of(ok), bytes_of(fb)


def _deep_pred(k: int) -> str:
    src = "f = 0"
    for j in range(1, k):
        src = f"f = {j % 9} OR (i IN (1, {j}) AND ({src}))"
    return src


@pytest.mark.parametrize("seed", range(16))
def test_kernel_model_equals_jax_jit(seed):
    """The numpy model of the kernel's scheme gives the JAX package's
    (pass, fallback) masks at test_program_equals_jax_jit's seeds, on
    its predicates, on stack forms, and on a plan deep enough for the
    widest stack."""
    rng = random.Random(seed)
    n = [1, 33, 257, 600][seed % 4]
    rb, pb = _mask_batches(seed, n)
    srcs = [_gen_eligible_pred(rng, rng.randint(1, 3)) for _ in range(10)]
    srcs += [_gen_computed_pred(rng, 2) for _ in range(3)]
    srcs += [_EVERY_OPCODE[seed % len(_EVERY_OPCODE)], _deep_pred(6)]
    words = set()
    for src in srcs:
        rp, pp = _plans(src, rb, pb)
        program = sk.lower_program(pp)
        words.add(_stack_words(program.depth))
        got = _kernel_model(program, sk.bind_columns(pp, pb), n)
        _assert_same(got, _ref_masks(rp, rb, n), src)
    assert 1 in words and sk.MAX_STACK * _R // 32 in words, words


@pytest.mark.parametrize("dtype", ["int32", "uint32", "bool", "float32"])
def test_kernel_model_dtypes_equal_jax_jit(dtype):
    """The model's dtype paths (the unsigned 2^24 test, uint32 past 2^31,
    bool bytes) against the JAX package."""
    n = 97
    rng = np.random.default_rng(7)
    vals = _dtype_values(dtype, n, rng)
    null = rng.random(n) < 0.2
    kind = "bool" if dtype == "bool" else "num"

    def batch(mod):
        return mod.ColumnBatch(["x"], {"x": mod.Column(
            "x", kind, raw=vals, null=null, intish=dtype != "float32")},
            n, 4 * n)

    rb, pb = batch(ref_col), batch(pcol)
    for src in _DTYPE_PREDICATES:
        rp, pp = _plans(src, rb, pb)
        got = _kernel_model(sk.lower_program(pp), sk.bind_columns(pp, pb), n)
        _assert_same(got, _ref_masks(rp, rb, n), (dtype, src))


def _reference_lane(rp, rb, n):
    """The reference's eval_predicate answer on the lane the port takes
    for this plan: its jit lane (select_kernels.py:85-97) for a bound
    eligible plan, its host lane (:102-107) otherwise."""
    bound = ref_sk._bind_jit(rp, rb) if rp.jit_ok and rp.cols else None
    if bound is None:
        return ref_comp.passing_mask(rp.eval_host(rb), n)
    arrs, base_fb = bound
    val, valid = ref_sk._run_jit(rp, arrs, n)
    return np.asarray(val) & np.asarray(valid) & ~base_fb, base_fb


@pytest.mark.parametrize("seed", range(6))
def test_eval_predicate_equals_reference(seed):
    """eval_predicate(device="cpu") gives the reference's (pass,
    fallback) masks, on eligible and on host-lane plans alike."""
    rng = random.Random(100 + seed)
    rb, pb = _mask_batches(100 + seed, 200)
    for _ in range(6):
        src = _gen_eligible_pred(rng, 2)
        if rng.random() < 0.3:
            src = f"({src}) OR f + 1 > 2"      # arithmetic: host lane
        rp, pp = _plans(src, rb, pb)
        want_ok, want_fb = _reference_lane(rp, rb, 200)
        ok, fb = sk.eval_predicate(pp, pb, device="cpu")
        assert np.array_equal(want_ok, ok), src
        assert np.array_equal(want_fb, fb), src


def test_deep_plan_runs_on_the_host_lane():
    """A program deeper than the kernel's stack is not lowered; the
    host lane still gives the reference's answer."""
    rb, pb = _mask_batches(7, 64)
    src = "f = 0"
    for k in range(1, sk.MAX_STACK + 2):
        src = f"f = {k % 9} OR ({src})"
    rp, pp = _plans(src, rb, pb)
    assert pp.jit_ok and sk.lower_program(pp) is None
    want_ok, want_fb = ref_comp.passing_mask(rp.eval_host(rb), 64)
    ok, fb = sk.eval_predicate(pp, pb, device="cpu")
    assert np.array_equal(want_ok, ok) and np.array_equal(want_fb, fb)


# Mirrors tests/test_select_columnar.py::test_jit_plan_eligibility_rules:
# (predicate, Plan.jit_ok, binds).
_ELIGIBILITY = [
    ("x < 3", True, True),
    ("x + 1 > 3", False, False),        # arithmetic
    ("x < 0.1", False, False),          # literal not exact in float32
    ("x", False, False),                # non-bool root
    ("y < 3", True, False),             # plan ok, bind refuses int64
    ("d < 3", True, False),             # ... and float64
    ("x < 16777216", True, True),       # 2^24 is exact
    ("x < 16777217", False, False),     # 2^24 + 1 is not
    ("s = 'a'", False, False),          # strings
    ("w BETWEEN 1 AND 2 AND b", True, True),   # int32 and bool bind
    ("x IS NULL OR q IS MISSING", True, True),  # absent column binds
]


@pytest.mark.parametrize("src,jit_ok,binds", _ELIGIBILITY)
def test_eligibility_equals_reference(src, jit_ok, binds):
    def batch(mod):
        return mod.ColumnBatch(["x", "y", "d", "s", "w", "b"], {
            "x": mod.Column("x", "num", raw=np.arange(8, dtype=np.float32)),
            "y": mod.Column("y", "num", raw=np.arange(8, dtype=np.int64),
                            intish=True),
            "d": mod.Column("d", "num", raw=np.arange(8, dtype=np.float64)),
            "s": mod.Column("s", "str", raw=np.array(list("abcdefgh"))),
            "w": mod.Column("w", "num", raw=np.arange(8, dtype=np.int32),
                            intish=True),
            "b": mod.Column("b", "bool", raw=np.arange(8) % 2 == 0),
        }, 8, 64)

    rb, pb = batch(ref_col), batch(pcol)
    rp, pp = _plans(src, rb, pb)
    assert rp.jit_ok == pp.jit_ok == jit_ok
    assert (sk.lower_program(pp) is not None) == jit_ok
    if jit_ok:
        assert (ref_sk._bind_jit(rp, rb) is not None) == binds
        assert (sk.bind_columns(pp, pb) is not None) == binds


def test_dispatch_rides_background_lane(monkeypatch):
    from minio_tpu_torch.qos import scheduler as qos_sched
    seen = []
    orig = qos_sched.GATE.dispatch

    def dispatch(lane):
        seen.append(lane)
        return orig(lane)

    monkeypatch.setattr(qos_sched.GATE, "dispatch", dispatch)
    _, pb = _mask_batches(3, 32)
    q = psql.parse("SELECT * FROM S3Object WHERE f > 3")
    sk.eval_predicate(pcomp.Plan(pcomp.lower(q.where, pb)), pb,
                      device="cpu")
    assert seen == [qos_sched.BACKGROUND]


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, pb = _mask_batches(3, 32)
    q = psql.parse("SELECT * FROM S3Object WHERE f > 3")
    plan = pcomp.Plan(pcomp.lower(q.where, pb))
    before = sk.select_scan_cuda.launches
    with pytest.raises(RuntimeError):
        sk.eval_predicate(plan, pb)
    req = psel.parse_request(_req_xml("SELECT * FROM S3Object",
                                      "<CSV/>"))
    with pytest.raises(RuntimeError):
        psel.run_select(req, b"1,2\n")
    assert sk.select_scan_cuda.launches == before


def _chip_parquet(mod, n: int, seed: int) -> bytes:
    """The chip run's object shape (c0, c1 FLOAT; i0, i1 INT32, all
    REQUIRED) at a small row count."""
    rng = np.random.default_rng(seed)
    cols = [mod.Column("c0", mod.FLOAT, optional=False),
            mod.Column("c1", mod.FLOAT, optional=False),
            mod.Column("i0", mod.INT32, optional=False),
            mod.Column("i1", mod.INT32, optional=False)]
    data = {"c0": rng.random(n, dtype=np.float32),
            "c1": rng.random(n, dtype=np.float32),
            "i0": rng.integers(0, 100_000, n).astype(np.int32),
            "i1": rng.integers(0, 16, n).astype(np.int32)}
    return mod.write_parquet_columns(cols, data, n)


CHIP_QUERIES = [
    "SELECT c1 FROM S3Object WHERE c0 < 0.0009765625",
    "SELECT COUNT(*) FROM S3Object WHERE c0 >= 0.25 AND i0 BETWEEN 1000 "
    "AND 50000 AND i1 IN (3, 5, 7)",
]


@pytest.mark.parametrize("query", CHIP_QUERIES)
def test_chip_queries_reach_the_program(query, monkeypatch):
    """The queries the chip run drives lower to a program and bind, so on
    the card they launch the kernel; their CPU-lane bodies equal the JAX
    package's and the row oracle's Records."""
    data = _chip_parquet(ppq, 4096, 5)
    assert data == _chip_parquet(ref_pq, 4096, 5)
    batch = next(iter(pcol.parquet_column_batches(data)))
    plan = pcomp.Plan(pcomp.lower(psql.parse(query).where, batch))
    assert sk.lower_program(plan) is not None
    bound = sk.bind_columns(plan, batch)
    assert bound is not None
    # REQUIRED columns: the kernel reads their raw values and no mask.
    assert all(null is None and miss is None for _, _, null, miss in bound)
    xml = _req_xml(query, "<Parquet/>")
    monkeypatch.setenv("MINIO_SELECT_ENGINE", "")
    body = psel.run_select(psel.parse_request(xml), data, device="cpu")
    assert body == ref_sel.run_select(ref_sel.parse_request(xml), data)
    monkeypatch.setenv("MINIO_SELECT_ENGINE", "row")
    row = psel.run_select(psel.parse_request(xml), data, device="cpu")
    assert _records(body) == _records(row) != b""


# ---------------------------------------------------------------------------
# run_select end to end against the JAX package
# ---------------------------------------------------------------------------


def _records(body: bytes) -> bytes:
    return b"".join(m["payload"] for m in pmsg.decode_messages(body)
                    if m["headers"].get(":event-type") == "Records")


def _rand_csv(rng: random.Random, rows: int) -> bytes:
    """Typed, ragged (MISSING) and quoted CSV with a header row."""
    words = ["paris", "abc", "a,b", 'say "hi"', "", "x y", "5"]
    lines = [b"c1,c2,c3,c4"]
    for _ in range(rows):
        c1 = rng.choice(["", str(rng.randint(-50, 50)),
                         str(rng.choice([0.5, -2.25, 1.75, 3.125])),
                         str(round(rng.uniform(-5, 5), 3))])
        c2 = rng.choice([str(rng.randint(0, 9)), "abc", "", "1e2", "0.5",
                         "nan", "  7"])
        c3 = rng.choice(words)
        if "," in c3 or '"' in c3 or rng.random() < 0.1:
            c3 = '"' + c3.replace('"', '""') + '"'
        fields = [c1, c2, c3, str(rng.randint(0, 3))]
        if rng.random() < 0.1:
            fields = fields[:rng.randint(1, 3)]      # ragged -> MISSING
        lines.append(",".join(fields).encode())
    return b"\n".join(lines) + b"\n"


def _rand_parquet(mod, rng: random.Random, rows: int, codec) -> bytes:
    cols = [mod.Column("c1", mod.INT64),
            mod.Column("c2", mod.DOUBLE),
            mod.Column("c3", mod.BYTE_ARRAY, is_string=True),
            mod.Column("c4", mod.BOOLEAN),
            mod.Column("c5", mod.INT32, optional=False),
            mod.Column("f", mod.FLOAT),
            mod.Column("i", mod.INT32)]
    words = ["alpha", "beta", "gamma", "", "d_lta", "a%b"]
    recs = []
    for _ in range(rows):
        recs.append({
            "c1": None if rng.random() < 0.3 else rng.randint(-1000, 1000),
            "c2": (None if rng.random() < 0.2
                   else round(rng.uniform(-100, 100), 4)),
            "c3": None if rng.random() < 0.2 else rng.choice(words),
            "c4": None if rng.random() < 0.2 else rng.random() < 0.5,
            "c5": rng.randint(0, 10),
            "f": (None if rng.random() < 0.2
                  else rng.choice([0.5, -1.25, 3.0, float("nan"), 7.75,
                                   rng.randint(-8, 8)])),
            "i": None if rng.random() < 0.2 else rng.randint(-9, 9),
        })
    return mod.write_parquet(cols, recs, codec=codec)


def _same_parquet(a: bytes, b: bytes) -> bool:
    """Byte equality of two Parquet files, except for the time stamp that
    gzip.compress writes into each gzip page (bytes 4-7 of a member)."""
    if len(a) != len(b):
        return False
    a, b = bytearray(a), bytearray(b)
    pos = a.find(b"\x1f\x8b\x08")
    while pos >= 0:
        a[pos + 4:pos + 8] = b[pos + 4:pos + 8] = bytes(4)
        pos = a.find(b"\x1f\x8b\x08", pos + 1)
    return a == b


def _value(rng: random.Random, cols: list, depth: int) -> str:
    roll = rng.random()
    if depth <= 0 or roll < 0.5:
        return rng.choice(cols)
    if roll < 0.78:
        return rng.choice(_EXACT_NUMS[:11] + ["2.3", "-7.1", "-3"])
    if roll < 0.86:
        return f"'{rng.choice(['paris', 'abc', '5', '', 'alpha'])}'"
    op = rng.choice(["+", "-", "*", "/", "%"])
    return (f"({_value(rng, cols, depth - 1)} {op} "
            f"{_value(rng, cols, depth - 1)})")


def _pred(rng: random.Random, cols: list, strcols: list, depth: int) -> str:
    roll = rng.random()
    if depth <= 0 or roll < 0.35:
        op = rng.choice(["=", "!=", "<>", "<", "<=", ">", ">="])
        return (f"{_value(rng, cols, depth - 1)} {op} "
                f"{_value(rng, cols, depth - 1)}")
    if roll < 0.45:
        neg = rng.choice(["", "NOT "])
        lo, hi = sorted([rng.randint(-30, 30), rng.randint(-30, 30)])
        return f"{_value(rng, cols, 0)} {neg}BETWEEN {lo} AND {hi}"
    if roll < 0.55:
        neg = rng.choice(["", "NOT "])
        opts = ", ".join(str(rng.randint(-10, 10))
                         for _ in range(rng.randint(1, 4)))
        return f"{_value(rng, cols, 0)} {neg}IN ({opts})"
    if roll < 0.62 and strcols:
        neg = rng.choice(["", "NOT "])
        pat = "".join(rng.choice(["a", "b", "l", "%", "_", "5"])
                      for _ in range(rng.randint(1, 4)))
        return f"{rng.choice(strcols)} {neg}LIKE '{pat}'"
    if roll < 0.72:
        mode = rng.choice(["NULL", "NOT NULL", "MISSING"])
        return f"{_value(rng, cols, 0)} IS {mode}"
    if roll < 0.82:
        return f"NOT ({_pred(rng, cols, strcols, depth - 1)})"
    op = rng.choice(["AND", "OR"])
    return (f"({_pred(rng, cols, strcols, depth - 1)}) {op} "
            f"({_pred(rng, cols, strcols, depth - 1)})")


def _query(rng: random.Random, cols: list, strcols: list) -> str:
    pred = _pred(rng, cols, strcols, rng.randint(1, 3))
    if rng.random() < 0.25:
        aggs = []
        for _ in range(rng.randint(1, 3)):
            fn = rng.choice(["COUNT", "SUM", "AVG", "MIN", "MAX"])
            arg = "*" if fn == "COUNT" and rng.random() < 0.4 \
                else rng.choice(cols)
            aggs.append(f"{fn}({arg}) AS a{len(aggs)}")
        return f"SELECT {', '.join(aggs)} FROM S3Object WHERE {pred}"
    proj = rng.choice(
        ["*", ", ".join(rng.sample(cols, rng.randint(1, len(cols))))])
    q = f"SELECT {proj} FROM S3Object WHERE {pred}"
    if rng.random() < 0.3:
        q += f" LIMIT {rng.randint(1, 20)}"
    return q


def _same_bodies(monkeypatch, engine: str, queries, data: bytes,
                 input_xml: str, rng: random.Random) -> None:
    monkeypatch.setenv("MINIO_SELECT_ENGINE", engine)
    for q in queries:
        out = rng.choice(["<JSON/>", "<CSV/>"])
        xml = _req_xml(q, input_xml, out)
        want = ref_sel.run_select(ref_sel.parse_request(xml), data)
        got = psel.run_select(psel.parse_request(xml), data, device="cpu")
        assert got == want, q


@pytest.mark.parametrize("engine", ["", "row"])
@pytest.mark.parametrize("seed", range(12))
def test_run_select_csv_equals_reference(monkeypatch, seed, engine):
    rng = random.Random(seed)
    data = _rand_csv(rng, 90)
    queries = [_query(rng, ["c1", "c2", "c3", "c4"], ["c2", "c3"])
               for _ in range(8)]
    csv_in = "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"
    _same_bodies(monkeypatch, engine, queries, data, csv_in, rng)


@pytest.mark.parametrize("engine", ["", "row"])
@pytest.mark.parametrize("seed", range(12))
def test_run_select_parquet_equals_reference(monkeypatch, seed, engine):
    codec = [None, "snappy", "gzip"][seed % 3]
    data = _rand_parquet(ppq, random.Random(seed), 120, codec)
    assert _same_parquet(
        data, _rand_parquet(ref_pq, random.Random(seed), 120, codec))
    rng = random.Random(1000 + seed)
    cols = ["c1", "c2", "c3", "c4", "c5", "f", "i"]
    queries = [_query(rng, cols, ["c3"]) for _ in range(6)]
    queries += [f"SELECT * FROM S3Object WHERE {_gen_eligible_pred(rng, 2)}"
                .replace("b", "c4").replace("z", "zz")
                for _ in range(3)]
    _same_bodies(monkeypatch, engine, queries, data, "<Parquet/>", rng)


def test_run_select_compressed_csv_and_errors(monkeypatch):
    """GZIP input, progress events and the error frames (bad SQL, bad
    data source) are the reference's bytes."""
    monkeypatch.setenv("MINIO_SELECT_ENGINE", "")
    data = _rand_csv(random.Random(3), 40)
    cases = [
        (_req_xml("SELECT c1 FROM S3Object WHERE c4 > 1",
                  "<CompressionType>GZIP</CompressionType><CSV>"
                  "<FileHeaderInfo>USE</FileHeaderInfo></CSV>", "<CSV/>",
                  "<RequestProgress><Enabled>true</Enabled>"
                  "</RequestProgress>"), gzip.compress(data, mtime=0)),
        (_req_xml("SELECT FROM WHERE", "<CSV/>"), data),
        (_req_xml("SELECT * FROM S3Object", "<Parquet/>"), b"not parquet"),
    ]
    for xml, body in cases:
        want = ref_sel.run_select(ref_sel.parse_request(xml), body)
        assert psel.run_select(psel.parse_request(xml), body,
                               device="cpu") == want


# ---------------------------------------------------------------------------
# the device-free copies, byte for byte
# ---------------------------------------------------------------------------

_REQUESTS = [
    _req_xml("SELECT * FROM S3Object", "<CSV/>"),
    _req_xml("SELECT s._1 FROM S3Object s", "<CSV><FileHeaderInfo>IGNORE"
             "</FileHeaderInfo><FieldDelimiter>;</FieldDelimiter>"
             "<QuoteCharacter>'</QuoteCharacter><Comments>#</Comments>"
             "</CSV>", "<CSV><FieldDelimiter>|</FieldDelimiter></CSV>"),
    _req_xml("SELECT * FROM S3Object", "<CompressionType>BZIP2"
             "</CompressionType><JSON><Type>DOCUMENT</Type></JSON>"),
    _req_xml("SELECT c0 FROM S3Object WHERE c0 < 1", "<Parquet/>",
             "<JSON><RecordDelimiter>;</RecordDelimiter></JSON>",
             "<RequestProgress><Enabled>TRUE</Enabled></RequestProgress>"),
    b'<SelectObjectContentRequest xmlns="http://s3.amazonaws.com/doc/'
    b'2006-03-01/"><Expression>SELECT 1</Expression><InputSerialization>'
    b'<JSON/></InputSerialization><OutputSerialization><CSV/>'
    b'</OutputSerialization></SelectObjectContentRequest>',
]
_BAD_REQUESTS = [
    b"<not xml",
    b"<Other/>",
    _req_xml("x", "<CSV/>").replace(b"<ExpressionType>SQL",
                                    b"<ExpressionType>XPATH"),
    _req_xml("x", "<CompressionType>GZIP</CompressionType><Parquet/>"),
    _req_xml("x", "<Avro/>"),
    _req_xml("x", "<CSV/>", "<Avro/>"),
]


@pytest.mark.parametrize("xml", _REQUESTS)
def test_parse_request_equals_reference(xml):
    assert psel.parse_request(xml) == ref_sel.parse_request(xml)


@pytest.mark.parametrize("xml", _BAD_REQUESTS)
def test_parse_request_errors_equal_reference(xml):
    with pytest.raises(ref_sel.S3SelectError) as want:
        ref_sel.parse_request(xml)
    with pytest.raises(psel.S3SelectError) as got:
        psel.parse_request(xml)
    assert (got.value.code, got.value.description) == \
        (want.value.code, want.value.description)


@pytest.mark.parametrize("name,args", [
    ("records_message", (b'{"a":1}\n' * 3,)),
    ("continuation_message", ()),
    ("progress_message", (10, 7, 3)),
    ("stats_message", (1 << 33, 12345, 0)),
    ("end_message", ()),
    ("error_message", ("InvalidQuery", "bad <SQL> & more")),
])
def test_message_framing_equals_reference(name, args):
    got = getattr(pmsg, name)(*args)
    assert got == getattr(ref_msg, name)(*args)
    assert pmsg.decode_messages(got) == ref_msg.decode_messages(got)


@pytest.mark.parametrize("size,alphabet", [
    (0, 256), (1, 256), (100, 4), (65536 + 7, 3), (200_000, 256),
    (70_000, 1)])
def test_snappy_round_trip_equals_reference(size, alphabet):
    rng = np.random.default_rng(size + alphabet)
    data = rng.integers(0, alphabet, size, dtype=np.uint8).tobytes()
    packed = psnappy.compress(data)
    assert packed == ref_snappy.compress(data)
    assert psnappy.decompress(packed) == data
    assert ref_snappy.decompress(packed) == data


@pytest.mark.parametrize("codec", [None, "snappy", "gzip"])
def test_parquet_writer_and_reader_equal_reference(codec):
    data = _rand_parquet(ppq, random.Random(7), 300, codec)
    assert _same_parquet(
        data, _rand_parquet(ref_pq, random.Random(7), 300, codec))
    p_schema, p_rows = ppq.read_parquet(data)
    r_schema, r_rows = ref_pq.read_parquet(data)
    assert [(c.name, c.ptype, c.optional) for c in p_schema] == \
        [(c.name, c.ptype, c.optional) for c in r_schema]
    assert repr(p_rows) == repr(r_rows)
    for pb, rb in zip(pcol.parquet_column_batches(data),
                      ref_col.parquet_column_batches(data)):
        assert pb.names == rb.names and pb.nrows == rb.nrows
        for name in pb.names:
            pc, rc = pb.cols[name], rb.cols[name]
            assert pc.kind == rc.kind
            assert np.array_equal(pc.null_mask(), rc.null_mask())
            if pc.kind != "str":
                assert np.array_equal(np.asarray(pc.raw),
                                      np.asarray(rc.raw), equal_nan=True)


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

_SLICE_FILES = sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "minio_tpu_torch").glob("s3select/*.py"),
     *(ROOT / "minio_tpu_torch").glob("obs/*.py"),
     *(ROOT / "minio_tpu_torch").glob("qos/*.py"),
     ROOT / "minio_tpu_torch/utils/snappy.py",
     ROOT / "minio_tpu_torch/ops/select_kernels.py",
     ROOT / "minio_tpu_torch/ops/_cuda.py",
     ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("rel", _SLICE_FILES)
def test_slice_module_imports_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "minio_tpu"), (rel, name)


# ---------------------------------------------------------------------------
# the kernel (needs a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 32, 33, 65537])
def test_kernel_equals_plain(cuda_device, n):
    rng = random.Random(n)
    _, pb = _mask_batches(n, n)
    srcs = [_gen_eligible_pred(rng, 3) for _ in range(12)]
    srcs += [_gen_computed_pred(rng, 2) for _ in range(4)] + [_deep_pred(6)]
    for src in srcs:
        q = psql.parse(f"SELECT * FROM S3Object WHERE {src}")
        plan = pcomp.Plan(pcomp.lower(q.where, pb))
        program = sk.lower_program(plan)
        cols = sk.place_columns(sk.bind_columns(plan, pb), cuda_device)
        out = torch.empty((2, n), dtype=torch.bool, device=cuda_device)
        flag = torch.empty(1, dtype=torch.int32, device=cuda_device)
        before = sk.select_scan_cuda.launches
        sk.select_scan_cuda(program, cols, n, out[0], out[1], flag)
        assert sk.select_scan_cuda.launches == before + 1
        ok, fb = sk.eval_program_plain(program, cols, n, cuda_device)
        assert torch.equal(out[0], ok), src
        assert torch.equal(out[1], fb), src
        assert bool(flag.item()) == bool(fb.any().item()), src
        got = sk.run_program(program, cols, n, cuda_device)
        assert np.array_equal(got[0], ok.cpu().numpy()), src
        assert np.array_equal(got[1], fb.cpu().numpy()), src
