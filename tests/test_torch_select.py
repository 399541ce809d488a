"""Columnar S3 Select in the port, held to the JAX package.

- The predicate program (ops/select_kernels.py: ``lower_program`` +
  ``bind_plan`` + ``eval_program_plain``, the plain version of the
  predicate-scan kernel) against the JAX package's own ``_bind_jit`` +
  ``_run_jit`` on the CPU, mask for mask, over randomised jit-eligible
  predicates on nullable FLOAT / INT32 / BOOLEAN columns with NaNs,
  MISSING cells and absent columns.
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
    program = sk.lower_program(plan)
    assert program is not None
    bound = sk.bind_plan(plan, batch)
    assert bound is not None
    cols, fb = bound
    val, valid = sk.eval_program_plain(
        program, sk.place_columns(cols, batch.nrows, CPU), batch.nrows, CPU)
    return val.numpy(), valid.numpy(), fb


@pytest.mark.parametrize("seed", range(16))
def test_program_equals_jax_jit(seed):
    """lower_program + eval_program_plain == the JAX _bind_jit + _run_jit
    masks (val, valid) and base fallback mask, on every predicate."""
    rng = random.Random(seed)
    n = [1, 33, 257, 600][seed % 4]
    rb, pb = _mask_batches(seed, n)
    seen_ops = set()
    checked = 0
    while checked < 10:
        src = _gen_eligible_pred(rng, rng.randint(1, 3))
        rp, pp = _plans(src, rb, pb)
        assert rp.jit_ok and pp.jit_ok, src
        val, valid, fb = _port_masks(pp, pb)
        if not rp.cols:
            # The JAX jit image needs a column to size its masks (the
            # reference fails over to the host lane); hold the program
            # to the host evaluation instead.
            want, _ = ref_comp.passing_mask(rp.eval_host(rb), n)
            assert np.array_equal(want, val & valid & ~fb), src
            continue
        arrs, ref_fb = ref_sk._bind_jit(rp, rb)
        ref_val, ref_valid = ref_sk._run_jit(rp, arrs, n)
        assert np.array_equal(np.asarray(ref_val), val), src
        assert np.array_equal(np.asarray(ref_valid), valid), src
        assert np.array_equal(ref_fb, fb), src
        seen_ops |= set(sk.lower_program(pp).ops[:, 0].tolist())
        checked += 1
    assert len(seen_ops) >= 6, seen_ops


_EVERY_OPCODE = [
    "f < 0.5", "b = TRUE", "b < f", "f BETWEEN 1 AND 2.125",
    "i NOT IN (3, 7, NULL)", "z IS MISSING", "f IS NOT NULL",
    "f AND b", "NULL OR b", "NOT z", "NOT NULL", "i != i",
    "(f > 1 OR b) AND NOT (i BETWEEN NULL AND 7)", "b IN (TRUE, 3)",
    "f <> f", "NULL = f", "3 >= 3", "TRUE AND z",
]


@pytest.mark.parametrize("src", _EVERY_OPCODE)
def test_program_equals_jax_jit_fixed(src):
    """Hand-picked predicates that between them emit every opcode."""
    rb, pb = _mask_batches(99, 300)
    rp, pp = _plans(src, rb, pb)
    val, valid, fb = _port_masks(pp, pb)
    if not rp.cols:
        want, _ = ref_comp.passing_mask(rp.eval_host(rb), 300)
        assert np.array_equal(want, val & valid & ~fb)
        return
    arrs, ref_fb = ref_sk._bind_jit(rp, rb)
    ref_val, ref_valid = ref_sk._run_jit(rp, arrs, 300)
    assert np.array_equal(np.asarray(ref_val), val)
    assert np.array_equal(np.asarray(ref_valid), valid)
    assert np.array_equal(ref_fb, fb)


def test_fixed_predicates_cover_every_opcode():
    _, pb = _mask_batches(99, 8)
    ops = set()
    for src in _EVERY_OPCODE:
        q = psql.parse(f"SELECT * FROM S3Object WHERE {src}")
        ops |= set(sk.lower_program(pcomp.Plan(pcomp.lower(q.where, pb)))
                   .ops[:, 0].tolist())
    assert ops == set(range(sk.OP_NOT + 1))


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
        assert (sk.bind_plan(pp, pb) is not None) == binds


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
    assert sk.bind_plan(plan, batch) is not None
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
    for _ in range(12):
        src = _gen_eligible_pred(rng, 3)
        q = psql.parse(f"SELECT * FROM S3Object WHERE {src}")
        plan = pcomp.Plan(pcomp.lower(q.where, pb))
        program = sk.lower_program(plan)
        cols, _ = sk.bind_plan(plan, pb)
        dev_cols = sk.place_columns(cols, n, cuda_device)
        before = sk.select_scan_cuda.launches
        val, valid = sk.run_program(program, dev_cols, n, cuda_device)
        assert sk.select_scan_cuda.launches == before + 1
        pval, pvalid = sk.eval_program_plain(program, dev_cols, n,
                                               cuda_device)
        assert torch.equal(val, pval), src
        assert torch.equal(valid, pvalid), src
