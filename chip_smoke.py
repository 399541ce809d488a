#!/usr/bin/env python3
"""Drive the minio_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from minio_tpu_torch/csrc (one nvcc process
per source, started together), holds each kernel byte-exact against its
plain PyTorch version and the golden pins, then drives each main path
through the port's entry points at deployment size:

- the erasure data plane: the flagship ``full_step`` (8+4, 32 blocks of
  10 MiB) and a PUT -> degraded GET -> heal of a 259 MiB object on a 12+4
  set with 10 MiB blocks;
- S3 Select: ``run_select`` (SelectObjectContent) over a 256 MiB Parquet
  object, its response bodies byte-identical to the CPU lane's, and at
  65,536 rows to the row oracle's Records;
- the dispatch plane (phases 11-16): the native C++ lane against the
  numpy oracle and K2, the autotuner's probe ladder on the card, the
  encode coalescer merging 16 concurrent 10 MiB PUTs into one K1 launch,
  the 259 MiB object again through ``Erasure(backend="auto")``, the
  REGEN class (12+4) on the same object through K1 at its (114 -> 240)
  and (114 -> 114) shapes, and ``full_step`` through the port's
  placement; kernprof must end with no dispatch failure and every lane
  up;
- the storage layer (phase 17): ``format.json`` over 16 drives of one
  set, the 259 MiB object committed to them (``create_file`` +
  ``rename_data``, each ``part.1`` checked against the native lane's
  digests), the deep bitrot scan (``XLStorage.verify_file``) of all 16
  on the card through K2, a rotted frame caught on its drive alone, a
  fault plan's drive error recorded by the drive monitor and its
  corruption caught by the scan, and the LZ block codec of transparent
  compression against a pin computed from the JAX package;
- the erasure engine (phase 18): the server's stack (ErasureServerPools
  over ErasureSets, 16 drives at 12+4, 10 MiB blocks, on the card) takes
  the 259 MiB object through PUT (each part.1 equal to phase 17's by
  erasure index), GET, a ranged GET and the listing, a degraded GET with
  two drives lost and a rotted frame, heal and the MRF queue, a
  three-part multipart upload, the boot recovery sweep and shutdown, with
  the K1 and K2 launches of each step;
- the S3 front door (phase 19): a port ``S3Server`` (the async front
  door) over the same stack answers SigV4 requests over loopback HTTP --
  MakeBucket, PUT, GET, a ranged GET, ListObjectsV2, HEAD, a degraded
  GET, a three-part multipart upload, a REGEN PUT and GET, Select on the
  256 MiB Parquet object, the metrics and admin endpoints, DeleteObject
  -- every body byte-exact, K1, K2 and X2 launched by its requests, and
  no thread of the server left after ``stop()``.

Every phase asserts; any failure exits non-zero. Prints the card, the
kernels' times beside their bounds, and as its last line
``{"ok": true, "device": {...}}``. Needs one card; exits non-zero without
one, or without the rest of the repository beside it. It runs itself once
more as ``chip_smoke.py --select-trace`` (phase 9's queries under
torch.profiler, in a process of their own) and waits for it, and once
as ``chip_smoke.py --storage-trace DIR`` (phase 17's deep scan of the
drives under DIR, traced the same way), and once as ``chip_smoke.py
--engine-trace DIR`` (phase 18's PUT and degraded GET over a fresh stack
under DIR, traced the same way).
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Golden pins (tests/test_golden.py): parity of pattern(65536) and the
# streaming-bitrot files of shard 0 / shard 8 of its (8,4) encode at
# shard_size 4096.
PARITY_PINS = {
    (8, 4): ("349e8c4a461aecda6c983f13d6f0b3876c453a7ed72ed630d6e28d67d01daa37",
             "9c48c8a6f7566e2b9c5d12613df1b137"),
    (12, 4): ("5c7a06df5c73f68cf4a968e93b8609f0fcc0b09b950cc2f8f443acadf506dada",
              "eca6e1f7a622ee2ddde01b6822a2be3c"),
    (16, 4): ("63bd6b9f75a714259b8e17e560c7c3eeb5b6f3965e2143f65312bad614f6510a",
              "185d9b544ca58a06effd9176c41df84e"),
}
FRAMED_LEN = 8256
FRAMED_DATA_SHA = \
    "fc894d69ec51feea973395d8b96f7be5cf7293f5cf0e9ebf7008157d3fc9fbb5"
FRAMED_DATA_FIRST_HASH = \
    "b2edb37d72d0a2d671c97136f0d594f5c9e68c6f6306ea8d4a8cd4fbffccb7d0"
FRAMED_PARITY_SHA = \
    "af6ef90e7d207f11e86d5f98bd73364dd2fbfaa3dc6bebdea0235e5e350d0fc9"

# sha256 of utils/compress.compress_stream over compressible_block(10 MiB),
# computed from the JAX package (tests/test_torch_storage_utils.py).
COMPRESS_PIN = \
    "571e3fc66ab4f20851d0cff4cefb389ef16fbdcb6c1ad8f1ae9a71882605d572"
STORAGE_DRIVES = 16

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 tensor-core
# operations/s, and the scalar 32-bit rate outside the tensor cores.
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
SCALAR_OPS = 67e12
# 32-bit integer operations of one HighwayHash packet update in
# csrc/hh256.cu (208 u64 operations, two 32-bit ones each).
HH_OPS_PER_UPDATE = 416

MIB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def pattern(np, n: int):
    i = np.arange(n, dtype=np.uint64)
    return ((i * 131 + 17) % 251).astype(np.uint8)


def compressible_block(np, n: int):
    """n bytes of text-like data made without an RNG: 8-byte words of 26
    kinds, each picked by a multiplicative hash of the word's index."""
    j = np.arange(-(-n // 8), dtype=np.uint64)
    wid = ((j * np.uint64(2654435761)) % np.uint64(1 << 32)) \
        >> np.uint64(26)
    k = np.arange(8, dtype=np.uint64)
    words = np.uint64(97) + (wid[:, None] * np.uint64(7)
                             + k[None, :] * np.uint64(3)) % np.uint64(26)
    return words.astype(np.uint8).reshape(-1)[:n]


def events_ms(torch, fn, runs: int = 20, warmup: int = 3) -> float:
    """Median per-run device time of fn() over `runs` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def queued_events_ms(torch, fn, runs: int = 20, per: int = 10) -> float:
    """Median over `runs` CUDA-event windows of the per-launch device time
    of `per` back-to-back fn() launches: for a kernel of ~0.1 ms, the host's
    submission of one launch would otherwise sit between the events."""
    fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(per):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per)
    return statistics.median(times)


def wall_ms(torch, fn, runs: int = 1) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_err(torch, a, b) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def device_us(prof) -> dict:
    """Self device time in µs per event name of a torch.profiler run."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        out[ev.key] = us
    return out


def gf_layout_checks(np, torch, dev, rng) -> int:
    """K1 against its plain version where the layout picks the path: S not
    a multiple of 16 inside 16-byte aligned rows (the vector path's ragged
    edge), row views at byte offsets (the byte path), k = 40, both output
    layouts, a decode matrix and a random 0/1 matrix with r = 12 (two
    passes of output rows)."""
    from minio_tpu_torch.ops import rs_gpu

    worst = 0
    for k, m in [(8, 4), (12, 4), (40, 5)]:
        bm = rs_gpu.placed_parity(k, m, dev)
        wide = torch.from_numpy(rng.integers(0, 256, (3, k, 8192 + 16),
                                             dtype=np.uint8)).to(dev)
        for off, S in [(0, 8192), (0, 8100), (0, 8191), (1, 8192),
                       (4, 8000), (8, 8192), (15, 4097)]:
            x = wide[:, :, off:off + S]
            plain = rs_gpu.gf_apply_plain(bm.dense, x)
            full = rs_gpu.encode_blocks(bm, x)
            e = max(max_err(torch, rs_gpu.gf_apply(bm, x), plain),
                    max_err(torch, full[:, k:], plain),
                    max_err(torch, full[:, :k], x),
                    max_err(torch, rs_gpu.encode_blocks_shardmajor(bm, x),
                            full.transpose(0, 1)))
            missing = (0, 3, k + 1)
            avail = tuple(i for i in range(k + m) if i not in missing)
            dm, used = rs_gpu.placed_any_decode(k, m, avail, missing, dev)
            surv = torch.empty((3, k, S + 16), dtype=torch.uint8,
                               device=dev)[:, :, off:off + S]
            surv.copy_(full[:, list(used)])
            got = rs_gpu.gf_apply(dm, surv)
            e = max(e, max_err(torch, got, rs_gpu.gf_apply_plain(dm.dense,
                                                                 surv)),
                    max_err(torch, got, full[:, list(missing)]))
            check(e == 0, f"gf_apply k={k} off={off} S={S}: kernel != plain")
            worst = max(worst, e)
    big = rs_gpu.as_bitmatrix(rng.integers(0, 2, (8 * 12, 8 * 5)).astype(
        np.float32), dev)
    for off in (0, 3):
        y = wide[:, :5, off:off + 4096]
        e = max_err(torch, rs_gpu.gf_apply(big, y),
                    rs_gpu.gf_apply_plain(big.dense, y))
        check(e == 0, f"gf_apply r=12 off={off}: kernel != plain")
        worst = max(worst, e)
    return worst


def hh_layout_checks(np, torch, dev, rng) -> int:
    """K2 against its plain version at every L % 32 (lengths that cross a
    ring window), with row starts at every offset mod 16, and batches that
    are not a multiple of the 16 chains of a block."""
    from minio_tpu_torch.ops import hh256_gpu

    worst = 0
    for rem in range(32):
        L = 32 * 17 + rem
        c = torch.from_numpy(rng.integers(0, 256, (37, L + 3),
                                          dtype=np.uint8)).to(dev)
        for rows in (c[:, :L].contiguous(), c[:, 1:L + 1]):
            e = max_err(torch, hh256_gpu.hash_chunks(rows),
                        hh256_gpu.hash_chunks_plain(rows))
            check(e == 0, f"hh256 L={L}: kernel != plain")
            worst = max(worst, e)
    L = 32 * 40 + 13
    for B in (1, 17, 33):
        wide = torch.from_numpy(rng.integers(0, 256, (B, L + 16),
                                             dtype=np.uint8)).to(dev)
        for off in range(16):
            rows = wide[:, off:off + L]
            e = max_err(torch, hh256_gpu.hash_chunks(rows),
                        hh256_gpu.hash_chunks_plain(rows))
            check(e == 0, f"hh256 B={B} offset {off}: kernel != plain")
            worst = max(worst, e)
    return worst


# -- S3 Select (kernel X2) ---------------------------------------------------

# Literals exact in float32 (a plan with any other literal is not kernel
# eligible; a minus sign parses as arithmetic).
EXACT_NUMS = ("0", "1", "3", "7", "12", "40", "0.5", "0.25", "2.125",
              "1.75", "3.5", "16777216", "0.0009765625")
# Predicates that between them emit every opcode of the program (`b IN
# (i, u, TRUE)` reads i and u only through OP_TOUCH), every stack width
# (the last two need 2 and 16 words), and the dtype edges.
EVERY_OPCODE = (
    "f < 0.5", "b = TRUE", "b < f", "f BETWEEN 1 AND 2.125",
    "i NOT IN (3, 7, NULL)", "z IS MISSING", "f IS NOT NULL", "f AND b",
    "NULL OR b", "NOT z", "NOT NULL", "i != i", "f <> f", "NULL = f",
    "(f > 1 OR b) AND NOT (i BETWEEN NULL AND 7)", "b IN (TRUE, 3)",
    "(f < 1) = b", "(f < 1) BETWEEN FALSE AND TRUE",
    "(f < 1) IN (TRUE, b, f < 2)", "(i = 3) IS NOT MISSING",
    "u >= 16777216 OR i < 16777216", "r IN (1, 2, 7) AND u BETWEEN 1 AND 40",
    "b IN (i, u, TRUE) OR r = 3",
    "f = 0 OR (f = 1 OR (f = 2 OR (f = 3 OR (f = 4 OR b))))",
    "f = 0 OR (f = 1 OR (f = 2 OR (f = 3 OR (f = 4 OR (f = 5 OR (f = 6 OR "
    "(f = 7 OR (f = 8 OR (i = 9 OR b)))))))))")
# int32 cells at the edges of float32's exact-integer range, and uint32
# cells past 2^31 (which must not read as negative int32).
I32_EDGES = (1 << 24, -(1 << 24), (1 << 24) + 1, -(1 << 24) - 1, -(1 << 31),
             (1 << 31) - 1)
U32_EDGES = ((1 << 32) - 1, 1 << 31, (1 << 31) + 7, (1 << 24) + 1, 1 << 24)
SELECT_ROWS = 16_777_216        # 4 REQUIRED 4-byte columns: 256 MiB
SELECT_ORACLE_ROWS = 65_536
SELECT_QUERIES = (
    "SELECT c1 FROM S3Object WHERE c0 < 0.0009765625",
    "SELECT COUNT(*) FROM S3Object WHERE c0 >= 0.25 AND i0 BETWEEN 1000 "
    "AND 50000 AND i1 IN (3, 5, 7)")


def gen_pred(rng, depth: int, bare: bool = False) -> str:
    """A random kernel-eligible predicate over f (FLOAT), i (INT32), b
    (BOOLEAN), u (UINT32), r (REQUIRED FLOAT) and the absent column z."""
    def operand(kind):
        if kind == "bool":
            return rng.choice(["b", "TRUE", "FALSE", "b", "z", "NULL"])
        r = rng.random()
        if r < 0.55:
            return rng.choice(["f", "i", "u", "r", "f", "i", "z"])
        return rng.choice(EXACT_NUMS) if r < 0.95 else \
            rng.choice(["NULL", "b", "TRUE"])

    roll = rng.random()
    if depth <= 0 or roll < 0.3:
        kind = "bool" if rng.random() < 0.2 else "num"
        op = rng.choice(["=", "!=", "<>", "<", "<=", ">", ">="])
        return f"{operand(kind)} {op} {operand(kind)}"
    if roll < 0.42:
        lo, hi = sorted(rng.sample(EXACT_NUMS[:10], 2), key=float)
        neg = rng.choice(["", "NOT "])
        return f"{operand('num')} {neg}BETWEEN {lo} AND {hi}"
    if roll < 0.54:
        opts = ", ".join(rng.choice(EXACT_NUMS + ("NULL", "TRUE"))
                         for _ in range(rng.randint(1, 4)))
        neg = rng.choice(["", "NOT "])
        return f"{operand('num')} {neg}IN ({opts})"
    if roll < 0.62:
        mode = rng.choice(["NULL", "NOT NULL", "MISSING", "NOT MISSING"])
        return f"{rng.choice(['f', 'i', 'b', 'u', 'z', 'NULL'])} IS {mode}"
    if roll < 0.68:      # a comparison of computed values: the stack forms
        op = rng.choice(["=", "<", ">="])
        return (f"({gen_pred(rng, depth - 1)}) {op} "
                f"({rng.choice(['b', 'TRUE', gen_pred(rng, depth - 1)])})")
    if roll < 0.74 and bare:
        return rng.choice(["f", "i", "b", "u", "z"])
    if roll < 0.84:
        return f"NOT ({gen_pred(rng, depth - 1, True)})"
    return (f"({gen_pred(rng, depth - 1, True)}) "
            f"{rng.choice(['AND', 'OR'])} ({gen_pred(rng, depth - 1, True)})")


def select_batch(np, n: int):
    """Phase 8's columns: f FLOAT (NULL, MISSING, NaN), i INT32 (NULL, the
    I32_EDGES), b BOOLEAN (NULL, MISSING), u UINT32 (REQUIRED, the
    U32_EDGES), r FLOAT (REQUIRED); z is absent."""
    from minio_tpu_torch.s3select import columnar
    rng = np.random.default_rng(n)
    f = (np.round(rng.uniform(-4, 4, n) * 4) / 4).astype(np.float32)
    f[rng.random(n) < 0.08] = np.nan
    i = rng.integers(-12, 41, n).astype(np.int32)
    edge = rng.random(n) < 0.04
    i[edge] = rng.choice(np.array(I32_EDGES), edge.sum())
    u = rng.integers(0, 41, n).astype(np.uint32)
    edge = rng.random(n) < 0.04
    u[edge] = rng.choice(np.array(U32_EDGES, dtype=np.uint64), edge.sum())
    cols = {
        "f": columnar.Column("f", "num", raw=f, null=rng.random(n) < 0.15,
                             miss=rng.random(n) < 0.08),
        "i": columnar.Column("i", "num", raw=i, null=rng.random(n) < 0.15,
                             intish=True),
        "b": columnar.Column("b", "bool", raw=rng.random(n) < 0.5,
                             null=rng.random(n) < 0.15,
                             miss=rng.random(n) < 0.05),
        "u": columnar.Column("u", "num", raw=u, intish=True),
        "r": columnar.Column("r", "num",
                             raw=rng.integers(0, 8, n).astype(np.float32)),
    }
    return columnar.ColumnBatch(list(cols), cols, n, 18 * n)


def at_offset(torch, t, off: int):
    """A copy of tensor t whose data starts ``off`` bytes past a 16-byte
    boundary."""
    if t is None:
        return None
    nbytes = t.numel() * t.element_size()
    buf = torch.empty(nbytes + 32, dtype=torch.uint8, device=t.device)
    start = (-buf.data_ptr()) % 16 + off
    view = buf[start:start + nbytes].view(t.dtype)
    view.copy_(t)
    return view


def select_kernel_checks(np, torch, dev) -> int:
    """8. X2 against its plain version on the card, byte for byte (pass,
    fallback and the any-fallback flag), over random eligible plans and
    EVERY_OPCODE, on REQUIRED and OPTIONAL (NULL, MISSING) columns, an
    absent one, NaN, the int32 and uint32 edges, with every column copied
    to byte offsets 4, 8 and 12 from a 16-byte boundary (1 and 3 for the
    byte arrays), and through run_program's copy back to the host."""
    import random

    from minio_tpu_torch.ops import _cuda
    from minio_tpu_torch.ops import select_kernels as sk
    from minio_tpu_torch.s3select import compile as comp, sql

    stack_words = _cuda.build().select_scan_stack_words
    t0 = time.perf_counter()
    worst, plans, launches, opcodes, words = 0, 0, 0, set(), set()
    for n in (1, 31, 32, 33, 65_537, SELECT_ROWS):
        batch = select_batch(np, n)
        prng = random.Random(n)
        count = 12 if n == SELECT_ROWS else 40
        srcs = list(EVERY_OPCODE) + [gen_pred(prng, prng.randint(1, 3))
                                     for _ in range(count)]
        out = torch.empty((2, n), dtype=torch.bool, device=dev)
        flag = torch.empty(1, dtype=torch.int32, device=dev)
        for k, src in enumerate(srcs):
            q = sql.parse(f"SELECT * FROM S3Object WHERE {src}")
            plan = comp.Plan(comp.lower(q.where, batch))
            program = sk.lower_program(plan)
            check(program is not None, f"X2: {src!r} is not eligible")
            placed = sk.place_columns(sk.bind_columns(plan, batch), dev)
            ok, fb = sk.eval_program_plain(program, placed, n, dev)
            layouts = [(0, 0)]
            if n < SELECT_ROWS or k % 6 == 0:
                layouts += [(4, 4), (8, 8), (12, 12), (0, 1), (0, 3)]
            for voff, boff in layouts:
                cols = [(at_offset(torch, v, voff if code != sk.DT_BOOL
                                   else boff), code,
                         at_offset(torch, nu, boff), at_offset(torch, mi, boff))
                        for v, code, nu, mi in placed]
                out.fill_(True)
                sk.select_scan_cuda(program, cols, n, out[0], out[1], flag)
                launches += 1
                e = max(max_err(torch, out[0], ok), max_err(torch, out[1], fb))
                check(e == 0 and bool(flag.item()) == bool(fb.any().item()),
                      f"X2 n={n} offsets {voff}/{boff} {src!r}: kernel != "
                      f"plain")
                worst = max(worst, e)
            host_ok, host_fb = sk.run_program(program, placed, n, dev)
            check(np.array_equal(host_ok, ok.cpu().numpy()) and
                  np.array_equal(host_fb, fb.cpu().numpy()),
                  f"X2 n={n} {src!r}: run_program's host masks != plain")
            opcodes |= program.opcodes()
            words.add(stack_words(program.depth))
            plans += 1
        del batch, out
    check(opcodes == set(range(sk.N_OPS)),
          f"X2 checks missed opcodes {set(range(sk.N_OPS)) - opcodes}")
    widths = {stack_words(d) for d in range(1, sk.MAX_STACK + 1)}
    check(words == widths, f"X2 checks ran stack widths {words}, want "
          f"{widths}")
    log(f"[kernels] select_scan == plain for {plans} plans ({launches} "
        f"launches: every opcode, every stack width, column starts at "
        f"offsets 4/8/12, byte arrays at 1/3) at n in 1..{SELECT_ROWS} "
        f"({time.perf_counter() - t0:.1f} s)")
    return worst


def select_object(np, n: int) -> bytes:
    """The seeded Parquet object: c0, c1 FLOAT in [0, 1), i0 INT32 in
    [0, 100000), i1 INT32 in [0, 16), all REQUIRED, one row group."""
    from minio_tpu_torch.s3select import parquet as pq
    rng = np.random.default_rng(14)
    cols = [pq.Column("c0", pq.FLOAT, optional=False),
            pq.Column("c1", pq.FLOAT, optional=False),
            pq.Column("i0", pq.INT32, optional=False),
            pq.Column("i1", pq.INT32, optional=False)]
    data = {"c0": rng.random(n, dtype=np.float32),
            "c1": rng.random(n, dtype=np.float32),
            "i0": rng.integers(0, 100_000, n).astype(np.int32),
            "i1": rng.integers(0, 16, n).astype(np.int32)}
    return pq.write_parquet_columns(cols, data, n)


def select_request(expr: str) -> dict:
    from xml.sax.saxutils import escape

    from minio_tpu_torch.s3select.select import parse_request
    return parse_request(
        ("<SelectObjectContentRequest><Expression>" + escape(expr)
         + "</Expression><ExpressionType>SQL</ExpressionType>"
         "<InputSerialization><Parquet/></InputSerialization>"
         "<OutputSerialization><JSON/></OutputSerialization>"
         "</SelectObjectContentRequest>").encode())


def records_of(body: bytes) -> bytes:
    from minio_tpu_torch.s3select.message import decode_messages
    msgs = decode_messages(body)
    check(bool(msgs) and msgs[0]["headers"].get(":message-type")
          != "error", f"select answered an error: {msgs[:1]}")
    return b"".join(m["payload"] for m in msgs
                    if m["headers"].get(":event-type") == "Records")


def select_path(np, torch, dev):
    """9. SelectObjectContent through run_select on a 256 MiB Parquet
    object, the card against the CPU lane; at 65,536 rows also against
    the row oracle. Returns (select_scan launches of the main path, the
    object's decoded batch and query 2's plan, for the times, and the
    sha256 of each query's body, for phase 19)."""
    import os

    from minio_tpu_torch.ops import hh256_gpu, rs_gpu
    from minio_tpu_torch.ops import select_kernels as sk
    from minio_tpu_torch.s3select import columnar, compile as comp, sql
    from minio_tpu_torch.s3select.select import run_select

    small = select_object(np, SELECT_ORACLE_ROWS)
    for q in SELECT_QUERIES:
        req = select_request(q)
        got = run_select(req, small, device=dev)
        check(got == run_select(req, small, device="cpu"),
              f"65,536 rows {q!r}: card body != CPU body")
        os.environ["MINIO_SELECT_ENGINE"] = "row"
        try:
            want = records_of(run_select(req, small, device=dev))
        finally:
            os.environ.pop("MINIO_SELECT_ENGINE", None)
        check(records_of(got) == want and want,
              f"65,536 rows {q!r}: Records != the row oracle's")
    log("[select] 65,536 rows: card bodies == CPU bodies, Records == row "
        "oracle's, both queries")

    t0 = time.perf_counter()
    data = select_object(np, SELECT_ROWS)
    log(f"[select] object {len(data)} B, {SELECT_ROWS} rows x 4 REQUIRED "
        f"FLOAT/INT32 columns, written in {time.perf_counter() - t0:.2f} s")
    reqs = [select_request(q) for q in SELECT_QUERIES]
    run_select(reqs[1], small, device=dev)      # warm the CUDA context

    # The main path, with every launch count zeroed just before.
    rs_gpu.gf_apply_cuda.launches = 0
    hh256_gpu.hash_chunks_cuda.launches = 0
    sk.select_scan_cuda.launches = 0
    torch.cuda.synchronize()
    bodies, walls = [], []
    for req in reqs:
        t0 = time.perf_counter()
        bodies.append(run_select(req, data, device=dev))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = sk.select_scan_cuda.launches
    others = rs_gpu.gf_apply_cuda.launches + \
        hh256_gpu.hash_chunks_cuda.launches
    log(f"[select] main path: launches select_scan {launches}, others "
        f"{others}")
    check(launches > 0, "select_scan never launched on the select path")

    rows = [records_of(b) for b in bodies]
    check(rows[0].count(b"\n") > 1000, "query 1 returned too few rows")
    check(rows[1].startswith(b'{"_1":'), f"query 2 answered {rows[1]!r}")
    cpu_walls = []
    for req, body in zip(reqs, bodies):
        t0 = time.perf_counter()
        check(run_select(req, data, device="cpu") == body,
              "256 MiB: card body != CPU body")
        cpu_walls.append((time.perf_counter() - t0) * 1e3)

    trace = traced_select()
    check(trace["sha256"] == [hashlib.sha256(b).hexdigest() for b in bodies],
          "the traced queries' bodies != the main path's")
    us, tw = trace["device_us"], sum(trace["walls"])
    k_us = sum(v for n, v in us.items() if "select_scan_kernel" in n)
    cp_us = sum(v for n, v in us.items() if "memcpy" in n.lower())
    all_us = sum(us.values())
    t0 = time.perf_counter()
    decoded = [list(columnar.parquet_column_batches(data, {"c0", "c1"})),
               list(columnar.parquet_column_batches(data,
                                                    {"c0", "i0", "i1"}))]
    parse_ms = (time.perf_counter() - t0) * 1e3
    nrows1 = rows[0].count(b"\n")
    log(f"[select] 256 MiB, card: query 1 ({nrows1} rows) "
        f"{walls[0]} ms, query 2 (COUNT {rows[1].strip().decode()}) "
        f"{walls[1]} ms wall; CPU lane {cpu_walls[0]} ms, {cpu_walls[1]} "
        f"ms; bodies byte-identical")
    if all_us:
        log(f"[select] device time (torch.profiler, both queries once more "
            f"in a process of their own, walls there {trace['walls']} ms): "
            f"select_scan kernel {k_us / 1e3} ms, host<->device copies "
            f"{cp_us / 1e3} ms, all device work {all_us / 1e3} ms of {tw} "
            f"ms wall (device idle share {1 - all_us / 1e3 / tw}); host "
            f"Parquet decode of the referenced columns alone {parse_ms} ms; "
            f"the rest of the wall is host copies, masks and output "
            f"formatting")
    else:
        log("[select] device time (torch.profiler): not measured (the "
            "traced process's profiler reported no device time)")
    for q, req in zip(SELECT_QUERIES, reqs):
        parts = host_breakdown(lambda: run_select(req, data, device=dev))
        log(f"[select] where the wall goes (cProfile, one more run of "
            f"{q[:40]!r}...): " + ", ".join(f"{k} {v} ms"
                                            for k, v in parts.items()))
    h2d = []
    for q, batches in zip(SELECT_QUERIES, decoded):
        qplan = comp.Plan(comp.lower(sql.parse(q).where, batches[0]))
        h2d.append(sum(bound_bytes(sk.bind_columns(qplan, b))
                       for b in batches))
    log(f"[select] host->device bytes of the bound columns: query 1 "
        f"{h2d[0]}, query 2 {h2d[1]}; device->host per query: the "
        f"{SELECT_ROWS}-byte pass mask (+16), the fallback mask only when "
        f"the kernel flagged a row")
    batch = decoded[1][0]
    plan = comp.Plan(comp.lower(sql.parse(SELECT_QUERIES[1]).where, batch))
    return launches, batch, plan, [hashlib.sha256(b).hexdigest()
                                   for b in bodies]


def traced_select() -> dict:
    """Phase 9's two 256 MiB queries run once more by ``chip_smoke.py
    --select-trace`` in a process of its own, whose torch.profiler session
    is the first of that process (a second session in this one has read no
    device time). Returns its walls, bodies' sha256 and device µs by
    event."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--select-trace"], capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"chip_smoke.py --select-trace exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def select_trace_main() -> None:
    """``--select-trace``: the queries of phase 9 over its 256 MiB object,
    after the same warm-up, under one torch.profiler session; prints one
    JSON object {"walls": ms, "sha256": of each body, "device_us": by
    event name}."""
    np, torch = setup()
    from torch.profiler import ProfilerActivity, profile

    from minio_tpu_torch.s3select.select import run_select

    dev = torch.device("cuda", 0)
    small = select_object(np, SELECT_ORACLE_ROWS)
    data = select_object(np, SELECT_ROWS)
    reqs = [select_request(q) for q in SELECT_QUERIES]
    run_select(reqs[1], small, device=dev)      # warm the CUDA context
    torch.cuda.synchronize()
    bodies, walls = [], []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for req in reqs:
            t0 = time.perf_counter()
            bodies.append(run_select(req, data, device=dev))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"walls": walls,
                      "sha256": [hashlib.sha256(b).hexdigest()
                                 for b in bodies],
                      "device_us": device_us(prof)}), flush=True)


# Functions of the select path, by (file suffix, name), whose cumulative
# time host_breakdown reports.
SELECT_STAGES = {
    "run_select": ("s3select/select.py", "run_select"),
    "parquet decode": ("s3select/columnar.py", "parquet_column_batches"),
    "plan": ("s3select/engine.py", "__init__"),
    "eval_predicate": ("ops/select_kernels.py", "eval_predicate"),
    "bind": ("ops/select_kernels.py", "bind_columns"),
    "host->device": ("ops/select_kernels.py", "place_columns"),
    "kernel + masks back": ("ops/select_kernels.py", "run_program"),
    "aggregate": ("s3select/engine.py", "_agg_batch"),
    "project": ("s3select/engine.py", "_emit_batch"),
    "format": ("s3select/readers.py", "format_json"),
}


def host_breakdown(fn) -> dict:
    """Cumulative ms of the SELECT_STAGES functions in one fn() run,
    under cProfile (whose overhead is in these numbers)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(fn)
    stats = pstats.Stats(prof).stats
    out = {}
    for label, (suffix, func) in SELECT_STAGES.items():
        ms = sum(v[3] for (path, _, name), v in stats.items()
                 if name == func and path.endswith(suffix)) * 1e3
        if ms:
            out[label] = ms
    return out


def ptxas_report(log_text: str, name: str) -> list:
    """Registers, stack frame and spill bytes of every compiled entry
    function whose name holds ``name``, from the ptxas -v log."""
    import re

    out, cur = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            cur = {"function": line.split("'")[1]} if name in line else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
    return out


def bound_bytes(bound: list) -> int:
    """Bytes of the host arrays bind_columns hands the kernel."""
    return sum(a.nbytes for v, _, nu, mi in bound for a in (v, nu, mi)
               if a is not None)


def select_times(np, torch, dev, batch, plan, ptxas_log: str) -> dict:
    """10. X2 at the main path's shape (query 2 over 16,777,216 rows):
    CUDA events, median of 20 windows of 10 queued launches (with the
    any-fallback word's memset), beside its byte bound (the raw
    columns, their masks and the two output masks), the old 6c + 2 bytes
    a row formula, the plain version on the card and the ptxas report."""
    from minio_tpu_torch.ops import select_kernels as sk

    n = batch.nrows
    program = sk.lower_program(plan)
    bound = sk.bind_columns(plan, batch)
    placed = sk.place_columns(bound, dev)
    out = torch.empty((2, n), dtype=torch.bool, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    args = sk.select_scan_args(program, placed, n, out[0], out[1], flag)
    ms = queued_events_ms(torch, lambda: sk.launch_select_scan(args))
    plain_ms = events_ms(torch, lambda: sk.eval_program_plain(
        program, placed, n, dev), runs=5, warmup=1)
    ok, fb = sk.eval_program_plain(program, placed, n, dev)
    check(torch.equal(out[0], ok) and torch.equal(out[1], fb),
          "X2 at the main-path shape: kernel != plain")
    nbytes = bound_bytes(bound) + 2 * n
    old_nbytes = len(placed) * n * (4 + 1 + 1) + 2 * n
    # Row operations: a comparison per leaf pair (2 for BETWEEN, one per
    # IN option), one per logic instruction, one 2^24 test per int column.
    ops = n * (sum({sk.OP_BETWEEN: 2, sk.OP_IN: max(c, 1)}.get(w & 0xFF, 1)
                   for w, _, _, c in program.ops.tolist())
               + sum(code in (sk.DT_I32, sk.DT_U32) for _, code, _, _ in bound))
    bound_ms = max(nbytes / HBM_BPS, ops / SCALAR_OPS) * 1e3
    by = "bytes" if nbytes / HBM_BPS >= ops / SCALAR_OPS else "operations"
    old_bound_ms = old_nbytes / HBM_BPS * 1e3
    report = ptxas_report(ptxas_log, "select_scan_kernel")
    check(len(report) == 3, f"ptxas report of select_scan_kernel: {report}")
    for fn in report:
        check(fn.get("stack_frame") == 0 and fn.get("spill_stores") == 0 and
              fn.get("spill_loads") == 0,
              f"select_scan_kernel uses local memory: {fn}")
    shape = (f"{len(program.ops)}-instruction program (stack depth "
             f"{program.depth}) over {len(placed)} columns x {n} rows -> "
             f"(pass, fallback) 2 x ({n},) bool")
    log(f"[times] select_scan ({shape}): {ms} ms, bound {bound_ms} ms ({by}: "
        f"{nbytes} B = raw columns + masks + 2 B a row out), old 6c+2 B a "
        f"row bound {old_bound_ms} ms, plain {plain_ms} ms")
    log("[times] select_scan ptxas: " + "; ".join(
        f"{fn['function'][-40:]}: {fn.get('registers')} registers, "
        f"{fn.get('stack_frame')} B stack frame, {fn.get('spill_stores')} B "
        f"spill stores, {fn.get('spill_loads')} B spill loads"
        for fn in report))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bound_old_formula_ms": old_bound_ms,
            "shape": shape, "ptxas": report}


def data_plane(np, torch, codec, bdev, payload, want_sha: str,
               traced: bool = False) -> dict:
    """6. / 14. PUT -> degraded GET -> heal of ``payload`` through
    ``codec`` with the engine's own recipe, bitrot framing on ``bdev``:
    data shards 0 and 5 lost and one byte rotted in frame 3 of shard 7.
    The GET must be sha-exact and the heal byte-identical. Returns the
    walls (ms), the tail block, and the device µs by event of a
    torch.profiler session around it when ``traced``."""
    from minio_tpu_torch.erasure import bitrot

    k, m, bs = codec.data_blocks, codec.parity_blocks, codec.block_size
    S = codec.shard_size()
    size = payload.size
    torch.cuda.synchronize()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    nfull = size // bs
    full = np.zeros((nfull, k * S), dtype=np.uint8)
    full[:, :bs] = payload[:nfull * bs].reshape(nfull, bs)
    full_sm = codec.encode_blocks_batch_shardmajor(full.reshape(nfull, k, S))
    tail = codec.encode_data(payload[nfull * bs:])
    frames = bitrot.encode_stream_arrays(list(full_sm), device=bdev)
    tail_frames = bitrot.encode_streams(
        [tail[j].tobytes() for j in range(k + m)], S, device=bdev)
    files = [np.concatenate([f, np.frombuffer(t, np.uint8)])
             for f, t in zip(frames, tail_frames)]
    t_put = time.perf_counter() - t0
    check(len(files[0]) == bitrot.bitrot_shard_file_size(
        codec.shard_file_size(size), S, bitrot.DEFAULT_ALGORITHM),
        "shard file size")

    # Lose data shards 0 and 5; rot one byte in frame 3 of shard 7.
    originals = {j: (full_sm[j].copy(), tail[j].copy()) for j in (0, 5, 7)}
    files[0] = files[5] = None
    files[7] = files[7].copy()
    files[7][3 * (32 + S) + 32 + 1000] ^= 0x5A
    t0 = time.perf_counter()
    hsz = 32
    blocks, keys, datas, wants = [], [], [], []
    for b in range(nfull + 1):
        chunk = S if b < nfull else tail.shape[1]
        row = [None] * (k + m)
        for j, f in enumerate(files):
            if f is None:
                continue
            base = b * (hsz + S)
            row[j] = f[base + hsz:base + hsz + chunk]
            datas.append(row[j])
            wants.append(f[base:base + hsz].tobytes())
            keys.append((b, j))
        blocks.append(row)
    oks = bitrot.verify_frames(datas, wants, device=bdev)
    bad = [key for key, ok in zip(keys, oks) if not ok]
    check(bad == [(3, 7)], f"verify_frames flagged {bad}, want [(3, 7)]")
    for row in blocks:          # a rotten frame distrusts its whole shard
        row[7] = None
    rebuilt = codec.decode_data_blocks_batch(blocks)
    got = hashlib.sha256()
    for b, row in enumerate(rebuilt):
        blk = b"".join(row[j].tobytes() for j in range(k))
        got.update(blk[:bs] if b < nfull else blk[:size - nfull * bs])
    t_get = time.perf_counter() - t0
    check(got.hexdigest() == want_sha, "degraded GET sha256 != input's")
    t0 = time.perf_counter()
    healed = codec.decode_all_blocks_batch(blocks)
    t_heal = time.perf_counter() - t0
    for j, (orig_full, orig_tail) in originals.items():
        for b in range(nfull):
            check(np.array_equal(healed[b][j], orig_full[b]),
                  f"heal shard {j} block {b}")
        check(np.array_equal(healed[nfull][j], orig_tail),
              f"heal shard {j} tail")
    torch.cuda.synchronize()
    dev_us = {}
    if prof is not None:
        prof.__exit__(None, None, None)
        dev_us = device_us(prof)
    return {"put_ms": t_put * 1e3, "get_ms": t_get * 1e3,
            "heal_ms": t_heal * 1e3, "tail": tail, "nfull": nfull,
            "dev_us": dev_us}


# -- the dispatch plane and the REGEN class (phases 11-16) --------------------


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from minio_tpu_torch.ops import hh256_gpu, rs_gpu
    from minio_tpu_torch.ops import select_kernels as sk
    rs_gpu.gf_apply_cuda.launches = 0
    hh256_gpu.hash_chunks_cuda.launches = 0
    sk.select_scan_cuda.launches = 0


def read_launches() -> dict:
    from minio_tpu_torch.ops import hh256_gpu, rs_gpu
    from minio_tpu_torch.ops import select_kernels as sk
    return {"gf_apply": rs_gpu.gf_apply_cuda.launches,
            "hh256": hh256_gpu.hash_chunks_cuda.launches,
            "select_scan": sk.select_scan_cuda.launches}


def gibs(nbytes: int, seconds: float) -> float:
    return nbytes / max(seconds, 1e-12) / (1 << 30)


def native_lane(np, torch, dev, payload) -> None:
    """11. The native lane: g++ build + known-answer probe, then the C++
    GF apply on one 12+4 10 MiB block against the numpy table-gather,
    and the C++ HighwayHash of its 16 shards against K2's digests."""
    from minio_tpu_torch import native
    from minio_tpu_torch.ops import hh256_gpu
    from minio_tpu_torch.ops.gf256 import gf_mat_vec_apply
    from minio_tpu_torch.ops.hh256 import MAGIC_KEY
    from minio_tpu_torch.ops.rs_matrix import parity_matrix

    t0 = time.perf_counter()
    check(native.probe(), "native.probe() failed its known-answer check")
    build_s = time.perf_counter() - t0
    k, m = 12, 4
    S = -(-10 * MIB // k)
    block = np.zeros((k, S), dtype=np.uint8)
    block.reshape(-1)[:10 * MIB] = payload[:10 * MIB]
    pm = parity_matrix(k, m)
    native.rs_apply_native(pm, block)             # warm
    t0 = time.perf_counter()
    parity = native.rs_apply_native(pm, block)
    rs_s = time.perf_counter() - t0
    check(np.array_equal(parity, gf_mat_vec_apply(pm, block)),
          "native rs_apply != gf_mat_vec_apply on a 12+4 10 MiB block")
    shards = np.ascontiguousarray(np.concatenate([block, parity]))
    t0 = time.perf_counter()
    digs = native.hh256_rows_native(shards, MAGIC_KEY)
    hh_s = time.perf_counter() - t0
    k2 = hh256_gpu.hash_chunks(torch.from_numpy(shards).to(dev),
                               MAGIC_KEY).cpu().numpy()
    check(np.array_equal(digs, k2), "native hh256 != K2 on the 16 shards")
    log(f"[native] g++ build + probe {build_s:.2f} s; rs_apply (12 -> 4) "
        f"over a 10 MiB block {gibs(block.nbytes, rs_s)} GiB/s "
        f"== gf_mat_vec_apply; hh256 over its 16 shards of {S} B "
        f"{gibs(shards.nbytes, hh_s)} GiB/s == K2")


def ladder_phase() -> dict:
    """12. The autotuner's probe ladder in the foreground on the card:
    every probed lane passes its known-answer check at every rung, and
    K1 (RS, REGEN rungs) and X2 (Select rungs) launch during it."""
    from minio_tpu_torch.obs.kernprof import DEVICE, HOST, NATIVE
    from minio_tpu_torch.ops.autotune import AUTOTUNE

    zero_launches()
    t0 = time.perf_counter()
    res = AUTOTUNE.probe_ladder()
    ladder_s = time.perf_counter() - t0
    lz = read_launches()
    snap = AUTOTUNE.snapshot()
    tables = {"rs": res, "select": snap["lastSelectProbe"],
              "regen": snap["lastRegenProbe"]}
    for what, table in tables.items():
        log(f"[ladder] {what} probes, GiB/s per rung: {json.dumps(table)}")
        for lane, per in table.items():
            check(per and all(v for v in per.values()),
                  f"ladder: {what} probe of {lane} failed: {per}")
    check(set(res) == {DEVICE, NATIVE, HOST},
          f"ladder probed {set(res)}, want device/native/host")
    check(DEVICE in tables["select"] and DEVICE in tables["regen"],
          "ladder: the select / regen probes skipped the card")
    check(lz["gf_apply"] > 0 and lz["select_scan"] > 0,
          f"ladder launched K1/X2 {lz}")
    plan = AUTOTUNE.plan_compact()
    log(f"[ladder] {ladder_s:.2f} s, launches {lz}; plan {json.dumps(plan)}")
    return {"seconds": ladder_s, "launches": lz, "plan": plan}


def coalescer_phase(np, torch, dev) -> dict:
    """13. Sixteen threads each prepare one 12+4 10 MiB block, meet at a
    barrier and submit to an EncodeCoalescer whose policy sends them to
    the card: one window, ONE K1 launch, every result == the native host
    encode, no request declined. The window is a test window, long
    enough for sixteen submissions; its queue wait measures that window,
    not a deployment's. The K1 time is the window's own launch, bracketed
    by CUDA events in the dispatcher thread."""
    import inspect
    import threading

    from minio_tpu_torch.obs.kernprof import KERNPROF
    from minio_tpu_torch.ops import batching, rs_gpu

    k, m, n, window = 12, 4, 16, 0.1
    default_window = inspect.signature(
        batching.EncodeCoalescer).parameters["window_s"].default
    S = -(-10 * MIB // k)
    co = batching.EncodeCoalescer(lambda nbytes: True, window_s=window)
    waits = []
    record = KERNPROF.record_queue_wait
    KERNPROF.record_queue_wait = lambda kern, ms: (waits.append(ms),
                                                   record(kern, ms))
    outs = [None] * n
    barrier = threading.Barrier(n)
    encode_blocks, marks = rs_gpu.encode_blocks, []

    def timed_encode(bm, x):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = encode_blocks(bm, x)
        end.record()
        marks.append((start, end))
        return out

    def put(i):
        data = np.random.default_rng(100 + i).integers(
            0, 256, (1, k, S), dtype=np.uint8)
        barrier.wait()
        outs[i] = (data, co.encode(data, k, m))

    batching.STATS.reset()
    zero_launches()
    threads = [threading.Thread(target=put, args=(i,)) for i in range(n)]
    rs_gpu.encode_blocks = timed_encode
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        co.stop()
        del KERNPROF.record_queue_wait
        rs_gpu.encode_blocks = encode_blocks
    wall_ms_ = (time.perf_counter() - t0) * 1e3
    lz = read_launches()
    stats = batching.STATS.snapshot()
    check(not any(th.is_alive() for th in threads), "a coalescer PUT hung")
    check(stats["coalesced_requests"] == n,
          f"coalesced_requests {stats['coalesced_requests']}, want {n}")
    check(lz["gf_apply"] == 1, f"the window launched K1 {lz['gf_apply']} "
          f"times, want 1")
    # One dispatch in all: a declined request would host-encode on its
    # own and count one more.
    check(stats["cpu_dispatches"] + stats["tpu_dispatches"] == 1,
          f"the coalescer declined to the host: {stats}")
    for data, enc in outs:
        check(np.array_equal(enc, batching.host_encode(data, k, m)),
              "coalesced encode != native host encode")
    check(len(marks) == 1, f"the window called encode_blocks {len(marks)} "
          f"times, want 1")
    torch.cuda.synchronize(dev)
    k1_ms = marks[0][0].elapsed_time(marks[0][1])
    waits.sort()
    log(f"[coalescer] test window_s {window} (the default is "
        f"{default_window}): {n} requests of "
        f"(1, {k}, {S}) -> 1 dispatch (coalesced_requests "
        f"{stats['coalesced_requests']}, K1 launches {lz['gf_apply']}), "
        f"results == native host encode; queue wait at this window p50 "
        f"{statistics.median(waits)} ms, max {waits[-1]} ms, submission "
        f"spread {waits[-1] - waits[0]} ms; the window's own K1 launch "
        f"{k1_ms} ms (CUDA events) at ({n}, {k}, {S}); wall {wall_ms_} ms")
    return {"launches": lz, "k1_ms": k1_ms,
            "wait_p50_ms": statistics.median(waits),
            "wait_max_ms": waits[-1],
            "spread_ms": waits[-1] - waits[0]}


def auto_phase(np, torch, payload, want_sha, pinned: dict) -> dict:
    """14. Phase 6 again with Erasure(12, 4, backend="auto") after the
    ladder, bitrot on device="auto": sha-exact; K1 launches exactly when
    the plan sends an RS bucket of this object to the card."""
    from minio_tpu_torch.erasure.codec import Erasure
    from minio_tpu_torch.obs.kernprof import DEVICE, KERNPROF
    from minio_tpu_torch.ops import batching
    from minio_tpu_torch.ops.autotune import AUTOTUNE

    mix0 = KERNPROF.mix_snapshot()
    zero_launches()
    codec = Erasure(12, 4, block_size=10 * MIB, backend="auto")
    got = data_plane(np, torch, codec, "auto", payload, want_sha)
    if batching._global_coalescer is not None:
        batching._global_coalescer.stop()
    lz = read_launches()
    mix1 = KERNPROF.mix_snapshot()
    mix = {lane: {key: mix1[lane][key] - mix0[lane][key]
                  for key in ("dispatches", "bytes")} for lane in mix1}
    plan = AUTOTUNE.plan_compact()
    to_card = sorted(f"{kern}[{b}]" for kern in ("rs_encode", "rs_decode")
                     for b in ("4-16M", "16M+")
                     if plan.get(kern, {}).get(b) == DEVICE)
    check(lz["hh256"] > 0, f"auto: K2 never launched ({lz})")
    check((lz["gf_apply"] > 0) == bool(to_card),
          f"auto: K1 launches {lz['gf_apply']} but the plan sends "
          f"{to_card or 'no RS bucket'} to the card")
    log(f"[auto] Erasure(12, 4, backend='auto') + bitrot device='auto': "
        f"PUT {got['put_ms']} ms, degraded GET {got['get_ms']} ms, heal "
        f"{got['heal_ms']} ms (pinned 'gpu' in this call: "
        f"{pinned['put_ms']} / {pinned['get_ms']} / {pinned['heal_ms']} "
        f"ms); GET sha256 == input; launches {lz}; RS buckets on the "
        f"card {to_card}; lane mix {json.dumps(mix)}")
    return {"launches": lz, "mix": mix, "walls": [got["put_ms"],
                                                  got["get_ms"],
                                                  got["heal_ms"]]}


def regen_phase(np, torch, dev, payload, want_sha) -> dict:
    """15. The REGEN class, 12+4, on the same 259 MiB object with
    RegenErasure(backend="gpu"): the 25 full blocks encoded in one batch
    and the tail alone; 4 nodes dropped and every block decoded
    sha-exact; one lost node re-encoded and rebuilt by transfer from its
    d helpers, byte-exact; a column subsample of the encode against
    gf_mat_vec_apply; K1 against its plain version at the REGEN shapes
    and timed at the full encode and decode shapes."""
    from minio_tpu_torch.erasure.regen import RegenErasure
    from minio_tpu_torch.ops import rs_gpu, rs_regen
    from minio_tpu_torch.ops.gf256 import gf_mat_vec_apply

    k, m, bs = 12, 4, 10 * MIB
    codec = RegenErasure(k, m, block_size=bs, backend="gpu")
    g = codec.g
    n, d, B = g.n, g.d, g.B
    nfull = payload.size // bs
    full = payload[:nfull * bs].reshape(nfull, bs)
    tail = payload[nfull * bs:]
    nst = codec.stripe_count(bs)
    zero_launches()
    t0 = time.perf_counter()
    sm = codec.encode_blocks_batch_bytes(full)
    tail_chunks = codec.encode_data(tail)
    enc_ms = (time.perf_counter() - t0) * 1e3
    lost = (0, 5, 9, 14)
    rows = [[None if j in lost else sm[j, b] for j in range(n)]
            for b in range(nfull)]
    rows.append([None if j in lost else tail_chunks[j] for j in range(n)])
    lens = [bs] * nfull + [tail.size]
    t0 = time.perf_counter()
    blocks = codec.decode_blocks_batch(rows, lens)
    dec_ms = (time.perf_counter() - t0) * 1e3
    check(hashlib.sha256(b"".join(blocks)).hexdigest() == want_sha,
          "REGEN: decoded object sha256 != input's")
    f = lost[1]
    t0 = time.perf_counter()
    re = codec.reencode_missing_batch(rows, lens, [f])
    re_ms = (time.perf_counter() - t0) * 1e3
    lz = read_launches()
    check(all(re[b][f] == sm[f, b].tobytes() for b in range(nfull))
          and re[nfull][f] == tail_chunks[f].tobytes(),
          f"REGEN: re-encoded node {f} != its encoded chunks")
    # Repair by transfer: node f's chunk from one stored row per helper.
    plan = rs_regen.repair_rows(k, m, f)
    nst_t = codec.stripe_count(tail.size)
    for b in range(nfull):
        rebuilt = np.empty(d * nst, dtype=np.uint8)
        for helper, hr, dr in plan:
            rebuilt[dr * nst:(dr + 1) * nst] = \
                sm[helper, b, hr * nst:(hr + 1) * nst]
        check(np.array_equal(rebuilt, sm[f, b]),
              f"REGEN: repair_rows rebuild of node {f} block {b}")
    rebuilt = np.empty(d * nst_t, dtype=np.uint8)
    for helper, hr, dr in plan:
        rebuilt[dr * nst_t:(dr + 1) * nst_t] = \
            tail_chunks[helper][hr * nst_t:(hr + 1) * nst_t]
    check(np.array_equal(rebuilt, tail_chunks[f]),
          f"REGEN: repair_rows rebuild of node {f}, tail")
    # The first 65,536 stripes of block 0 against the host oracle.
    sub = min(65536, nst)
    W0 = rs_regen.pack_block(k, m, full[0])[:, :sub]
    want = gf_mat_vec_apply(rs_regen.encode_matrix_regen(k, m), W0)
    got = sm[:, 0].reshape(n, d, nst)[:, :, :sub].reshape(n * d, sub)
    check(np.array_equal(got, want),
          "REGEN: encode != gf_mat_vec_apply on block 0's first stripes")
    log(f"[regen] 12+4 (n={n}, d={d}, B={B}), {payload.size} B: encode "
        f"{nfull} blocks + tail {enc_ms} ms, decode with nodes {lost} lost "
        f"{dec_ms} ms (sha256 == input), re-encode of node {f} {re_ms} ms "
        f"== its chunks, repair by transfer from {d} helpers byte-exact, "
        f"first {sub} stripes == gf_mat_vec_apply; K1 launches {lz}")
    check(lz["gf_apply"] > 0, "REGEN path never launched K1")

    # K1 against its plain version at the REGEN matrices.
    bm_e = rs_regen.placed_encode_bitplane(k, m, dev)
    nodes = tuple(j for j in range(n) if j not in lost)[:k]
    bm_d = rs_regen.placed_decode_bitplane(k, m, nodes, dev)
    rng = np.random.default_rng(15)
    wide = torch.from_numpy(rng.integers(0, 256, (1, B, 65536 + 32),
                                         dtype=np.uint8)).to(dev)
    worst = 0
    for bm in (bm_e, bm_d):
        for S in (4096, 4099, 65536 + 3):
            for off in (0, 1):
                x = wide[:, :, off:off + S]
                e = max_err(torch, rs_gpu.gf_apply(bm, x),
                            rs_gpu.gf_apply_plain(bm.dense, x))
                check(e == 0, f"K1 (k={bm.k}, r={bm.r}) S={S} off={off}: "
                      f"kernel != plain")
                worst = max(worst, e)
    # Times at the full encode and decode shapes.
    S = nfull * nst
    cols = torch.from_numpy(rs_regen.pack_blocks_batch(k, m, full)).to(
        dev)[None]
    out_e = torch.empty((1, bm_e.r, S), dtype=torch.uint8, device=dev)
    enc_k = events_ms(torch, lambda: rs_gpu.gf_apply_cuda(
        bm_e, cols, out_e, bm_e.r * S, S, 0, False), runs=10, warmup=2)
    e = max_err(torch, out_e[:, :, :sub],
                rs_gpu.gf_apply_plain(bm_e.dense, cols[:, :, :sub]))
    check(e == 0, "K1 at the REGEN encode shape: kernel != plain")
    out_d = torch.empty((1, bm_d.r, S), dtype=torch.uint8, device=dev)
    dec_k = events_ms(torch, lambda: rs_gpu.gf_apply_cuda(
        bm_d, cols, out_d, bm_d.r * S, S, 0, False), runs=10, warmup=2)
    PS = 262144
    plain_ms = wall_ms(torch, lambda: rs_gpu.gf_apply_plain(
        bm_e.dense, cols[:, :, :PS]), runs=3)
    rec = {"launches": lz["gf_apply"], "max_abs_err": max(worst, e)}
    for name, kk, r, ms in (("encode", B, bm_e.r, enc_k),
                            ("decode", B, bm_d.r, dec_k)):
        nbytes = (kk + r) * S
        ops = 2 * (8 * r) * (8 * kk) * S
        bytes_ms, ops_ms = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
        rec[name] = {"shape": f"(1, {kk}, {S}) -> (1, {r}, {S})", "ms": ms,
                     "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations"}
        log(f"[times] gf_apply REGEN {name} (1, {kk}, {S}) -> (1, {r}, "
            f"{S}): {ms} ms, byte bound {bytes_ms} ms, op bound {ops_ms} "
            f"ms ({rec[name]['bound_by']})")
    rec["plain_ms"] = plain_ms
    rec["plain_shape"] = f"encode (1, {B}, {PS}) -> (1, {bm_e.r}, {PS})"
    log(f"[times] gf_apply REGEN plain version {plain_ms} ms at "
        f"{rec['plain_shape']}")
    return rec


def placement_phase(torch, devices, enc, dec, fdata, used) -> dict:
    """16. The device census, and full_step through the port's placement
    (models/ec_pipeline.full_step_sharded over every card of the census),
    against the one-device full_step on the same inputs."""
    from minio_tpu_torch.models import ec_pipeline

    count = len(devices)
    zero_launches()
    t0 = time.perf_counter()
    out = ec_pipeline.full_step_sharded(devices, enc, dec, fdata, used)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    lz = read_launches()
    one = ec_pipeline.full_step(enc, dec, fdata, used)
    check(int(out["mismatch"]) == 0, "full_step_sharded mismatch")
    check(torch.equal(out["shards"].to(one["shards"].device),
                      one["shards"]), "full_step_sharded shards != full_step")
    check(lz["gf_apply"] > 0, "full_step_sharded never launched K1")
    log(f"[placement] census {count} CUDA device(s); full_step_sharded "
        f"over {count}: mismatch 0, shards == full_step's, {step_ms} ms wall "
        f"incl. placement copies; launches {lz}")
    return {"devices": count, "launches": lz}


def final_health() -> None:
    """Kernprof recorded no dispatch failure and every lane ends UP."""
    from minio_tpu_torch.obs.kernprof import KERNPROF
    snap = KERNPROF.snapshot()["backends"]
    fails = {b: v["failures"] for b, v in snap.items() if v["failures"]}
    check(not fails, f"kernprof recorded dispatch failures {fails}")
    down = {b: v["state"] for b, v in snap.items() if v["state"] != "up"}
    check(not down, f"kernprof lanes not UP at the end: {down}")
    log("[health] kernprof: no dispatch failure, every lane up; lane mix "
        + json.dumps(KERNPROF.mix_snapshot()))


# -- the storage layer (phase 17) ----------------------------------------------


def storage_drives(root: str) -> list:
    """The 16 drives of phase 17 under ``root``, hashing on the card."""
    from minio_tpu_torch.storage.xl import XLStorage
    return [XLStorage(str(Path(root) / f"d{i:02d}"), device="cuda")
            for i in range(STORAGE_DRIVES)]


def deep_scan(drives, fis) -> list:
    """verify_file of the object on every drive: 'ok' or the class of
    what it raised, per drive."""
    out = []
    for d, fi in zip(drives, fis):
        try:
            d.verify_file("bucket", "obj", fi)
            out.append("ok")
        except Exception as exc:  # noqa: BLE001 - the class is the verdict
            out.append(type(exc).__name__)
    return out


def traced_storage_scan(root: str) -> dict:
    """Phase 17's deep scan once more by ``chip_smoke.py --storage-trace
    root`` in a process of its own (its torch.profiler session the first
    of that process). Returns its wall, verdicts, K2 launches and device
    µs by event."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--storage-trace", root], capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"chip_smoke.py --storage-trace exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def storage_trace_main(root: str) -> None:
    """``--storage-trace ROOT``: verify_file on the 16 drives of phase 17
    under ROOT, after one warm-up scan of drive 0, under one
    torch.profiler session; prints one JSON object {"wall_ms",
    "verdicts", "launches", "device_us": by event name}."""
    np, torch = setup()
    from torch.profiler import ProfilerActivity, profile

    from minio_tpu_torch.ops import hh256_gpu

    drives = storage_drives(root)
    fis = [d.read_version("bucket", "obj") for d in drives]
    check(deep_scan(drives[:1], fis[:1]) == ["ok"], "warm-up scan")
    torch.cuda.synchronize()
    hh256_gpu.hash_chunks_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        verdicts = deep_scan(drives, fis)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"wall_ms": wall, "verdicts": verdicts,
                      "launches": hh256_gpu.hash_chunks_cuda.launches,
                      "device_us": device_us(prof)}), flush=True)


def storage_phase(np, torch, payload) -> dict:
    """17. The storage layer on the card, at the 12+4, 10 MiB-block
    deployment of phase 6 with its 259 MiB object, over 16 drive
    directories in one temporary directory: format, PUT commit, deep
    scan (and its traced rerun), a rotted frame, drive faults, and the
    compression codec. Returns the walls, the scan's K2 launches and its
    trace."""
    import os
    import shutil
    import struct
    import tempfile

    from minio_tpu_torch.erasure import bitrot
    from minio_tpu_torch.erasure.codec import Erasure
    from minio_tpu_torch.faultinject import FAULTS
    from minio_tpu_torch.native import hh256_native, hh256_rows_native
    from minio_tpu_torch.obs.drivemon import (DRIVEMON, op_class,
                                              redacted_endpoint)
    from minio_tpu_torch.obs.metrics2 import METRICS2
    from minio_tpu_torch.ops.hh256 import MAGIC_KEY
    from minio_tpu_torch.storage import errors as serr
    from minio_tpu_torch.storage.format import (init_or_load_formats,
                                                load_format)
    from minio_tpu_torch.storage.metadata import (ErasureInfo, FileInfo,
                                                  ObjectPartInfo,
                                                  new_data_dir)
    from minio_tpu_torch.storage.xl import MINIO_META_BUCKET, TMP_PATH
    from minio_tpu_torch.utils import compress

    k, m, bs = 12, 4, 10 * MIB
    size = payload.size
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_storage_")
    try:
        drives = storage_drives(root)

        # 1. Format: one set of 16; every format.json parses back, and a
        #    restart re-reads the same topology.
        t0 = time.perf_counter()
        fmt, ordered, fresh = init_or_load_formats(drives)
        format_ms = (time.perf_counter() - t0) * 1e3
        check(len(fmt.sets) == 1 and len(fmt.sets[0]) == STORAGE_DRIVES
              and fresh == [], f"format: sets {fmt.sets}, fresh {fresh}")
        for i, d in enumerate(drives):
            f = load_format(d)
            check(f is not None and f.this == fmt.sets[0][i]
                  and f.deployment_id == fmt.deployment_id
                  and f.sets == fmt.sets, f"drive {i}: format.json")
        again = init_or_load_formats(drives)
        check(again[0].sets == fmt.sets and again[1] == drives
              and again[2] == [], "format: the restart re-read differs")

        # 2. PUT commit: K1 shards, K2 frames, then create_file under
        #    .minio.sys/tmp and rename_data on each drive.
        zero_launches()
        codec = Erasure(k, m, block_size=bs, backend="gpu")
        S = codec.shard_size()
        nfull = size // bs
        t0 = time.perf_counter()
        full = np.zeros((nfull, k * S), dtype=np.uint8)
        full[:, :bs] = payload[:nfull * bs].reshape(nfull, bs)
        full_sm = codec.encode_blocks_batch_shardmajor(
            full.reshape(nfull, k, S))
        tail = codec.encode_data(payload[nfull * bs:])
        frames = bitrot.encode_stream_arrays(list(full_sm), device="cuda")
        tail_frames = bitrot.encode_streams(
            [tail[j].tobytes() for j in range(k + m)], S, device="cuda")
        put_ms = (time.perf_counter() - t0) * 1e3
        put_launches = read_launches()
        dd = new_data_dir()
        algo = bitrot.HIGHWAYHASH256S
        t0 = time.perf_counter()
        for i, d in enumerate(drives):
            d.make_volume("bucket")
            stage = f"{TMP_PATH}/put"
            d.create_file(MINIO_META_BUCKET, f"{stage}/{dd}/part.1",
                          frames[i].tobytes() + tail_frames[i])
            d.rename_data(MINIO_META_BUCKET, stage, FileInfo(
                volume="bucket", name="obj", data_dir=dd, size=size,
                mod_time=time.time(),
                parts=[ObjectPartInfo(1, size, size)],
                erasure=ErasureInfo(
                    data_blocks=k, parity_blocks=m, block_size=bs,
                    index=i + 1, distribution=list(range(1, k + m + 1)),
                    checksums=[{"part": 1, "algorithm": algo,
                                "hash": ""}])), "bucket", "obj")
        commit_ms = (time.perf_counter() - t0) * 1e3
        want_len = bitrot.bitrot_shard_file_size(codec.shard_file_size(size),
                                                 S, algo)
        fis, part_sha = [], {}
        for i, d in enumerate(drives):
            fi = d.read_version("bucket", "obj")
            check(fi.data_dir == dd and fi.size == size
                  and fi.erasure.index == i + 1
                  and (fi.erasure.data_blocks, fi.erasure.parity_blocks,
                       fi.erasure.block_size) == (k, m, bs)
                  and [(p.number, p.size) for p in fi.parts] == [(1, size)]
                  and fi.erasure.checksums[0]["algorithm"] == algo,
                  f"drive {i}: xl.meta read back as {fi}")
            fis.append(fi)
            raw = np.frombuffer(d.read_all("bucket", f"obj/{dd}/part.1"),
                                np.uint8)
            part_sha[fi.erasure.index] = hashlib.sha256(raw).hexdigest()
            check(raw.size == want_len, f"drive {i}: part.1 is {raw.size} "
                  f"B, want {want_len}")
            body = raw[:nfull * (32 + S)].reshape(nfull, 32 + S)
            last = raw[nfull * (32 + S):]
            check(np.array_equal(hh256_rows_native(body[:, 32:], MAGIC_KEY),
                                 body[:, :32])
                  and hh256_native(last[32:].tobytes(), MAGIC_KEY)
                  == last[:32].tobytes(),
                  f"drive {i}: a frame's hash != the native lane's hh256")
            check(np.array_equal(body[:, 32:], full_sm[i])
                  and np.array_equal(last[32:], tail[i]),
                  f"drive {i}: part.1 does not hold the encoded shard")
        del frames, tail_frames, full, full_sm

        # 3. The deep scan of every drive on the card (K2 through
        #    verify_file), its traced rerun in a process of its own, then
        #    one byte rotted in frame 3 of drive 7.
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdicts = deep_scan(drives, fis)
        torch.cuda.synchronize()
        scan_ms = (time.perf_counter() - t0) * 1e3
        scan_launches = read_launches()
        check(verdicts == ["ok"] * STORAGE_DRIVES,
              f"deep scan of the clean drives: {verdicts}")
        check(scan_launches["hh256"] > 0 and scan_launches["gf_apply"] == 0
              and scan_launches["select_scan"] == 0,
              f"deep scan launches {scan_launches}")
        trace = traced_storage_scan(root)
        check(trace["verdicts"] == verdicts
              and trace["launches"] == scan_launches["hh256"],
              f"traced scan {trace['verdicts']}, {trace['launches']} K2 "
              f"launches; this process {scan_launches['hh256']}")
        path = os.path.join(drives[7].root, "bucket", "obj", dd, "part.1")
        with open(path, "r+b") as f:
            f.seek(3 * (32 + S) + 32 + 1000)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x5A]))
        rotted = deep_scan(drives, fis)
        check(rotted == ["FileCorrupt" if i == 7 else "ok"
                         for i in range(STORAGE_DRIVES)],
              f"deep scan after rotting drive 7: {rotted}")

        # 4. Drive faults: read_all on drive 3 fails (FaultyDisk, recorded
        #    by the drive monitor under read_all's class in the reference,
        #    "read"), then corrupted reads on drive 5 are caught by the
        #    scan; the plan is cleared after each.
        check(op_class("read_all") == "read", "op_class(read_all)")

        def errors_of(endpoint: str) -> float:
            series = METRICS2.snapshot()[
                "minio_tpu_v2_drive_op_errors_total"]["series"]
            return sum(x["value"] for x in series if x["labels"] == {
                "disk": redacted_endpoint(endpoint), "op_class": "read"})

        def row_of(endpoint: str) -> dict:
            return next((r for r in DRIVEMON.snapshot()["drives"]
                         if r["endpoint"] == endpoint), {"errsTotal": 0})

        ep3 = drives[3].root
        errs0, metric0 = row_of(ep3)["errsTotal"], errors_of(ep3)
        FAULTS.load_plan({"seed": 3, "rules": [
            {"kind": "error", "target": ep3, "op": "read_all"}]})
        try:
            drives[3].read_all("bucket", "obj/xl.meta")
            raised = None
        except serr.FaultyDisk as exc:
            raised = exc
        finally:
            FAULTS.clear()
        check(raised is not None, "the error plan did not fail read_all")
        check(row_of(ep3)["errsTotal"] == errs0 + 1
              and errors_of(ep3) == metric0 + 1,
              "DRIVEMON did not record the injected read_all fault as a "
              "'read' error")
        FAULTS.load_plan({"seed": 5, "rules": [
            {"kind": "corrupt", "target": drives[5].root,
             "op": "read_all"}]})
        try:
            corrupt = deep_scan(drives[5:6], fis[5:6])
        finally:
            FAULTS.clear()
        check(corrupt == ["FileCorrupt"], f"filter_read corruption: "
              f"verify_file gave {corrupt}")
        check(deep_scan(drives[5:6], fis[5:6]) == ["ok"],
              "drive 5 after the plan was cleared")

        # 5. Transparent compression: one 10 MiB block through the native
        #    LZ block lane (built by g++ here), against the JAX package's
        #    bytes (COMPRESS_PIN).
        block = compressible_block(np, 10 * MIB).tobytes()
        t0 = time.perf_counter()
        blob = compress.compress_stream(block)
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = compress.decompress_stream(blob)
        d_s = time.perf_counter() - t0
        flags, off = [], 4
        while off < len(blob):
            flag, _, csize = struct.unpack_from("<BII", blob, off)
            flags.append(flag)
            off += 9 + csize
        check(back == block, "decompress_stream(compress_stream(x)) != x")
        check(hashlib.sha256(blob).hexdigest() == COMPRESS_PIN,
              "compress_stream bytes != the JAX package's (COMPRESS_PIN)")
        check(set(flags) == {compress.F_LZB}, f"block flags {flags}: the "
              f"native LZ lane did not code every block")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    dev = trace["device_us"]
    hh_ms = sum(v for n, v in dev.items() if "hh256_kernel" in n) / 1e3
    cp_ms = sum(v for n, v in dev.items() if "memcpy" in n.lower()) / 1e3
    all_ms = sum(dev.values()) / 1e3
    idle = 1 - all_ms / trace["wall_ms"] if all_ms else None
    phase_s = time.perf_counter() - t_phase
    log(f"[storage] 16 drives, 12+4, 10 MiB blocks, {size} B object: format "
        f"{format_ms} ms; PUT encode + frame {put_ms} ms (launches "
        f"{put_launches}); commit (create_file + rename_data) of 16 drives "
        f"{commit_ms} ms; every part.1 == the native lane's hh256 and the "
        f"encoded shard; every xl.meta read back")
    log(f"[storage] deep scan (verify_file) of 16 drives on the card "
        f"{scan_ms} ms, K2 launches {scan_launches['hh256']}; traced rerun "
        f"in its own process: {trace['wall_ms']} ms wall, device time "
        + (f"hh256 kernel {hh_ms} ms, host<->device copies {cp_ms} ms, all "
           f"device work {all_ms} ms, device idle share {idle}"
           if all_ms else "not measured (the profiler reported none)"))
    log(f"[storage] rotted frame 3 of drive 7: FileCorrupt on drive 7 "
        f"alone; error plan on drive 3's read_all: FaultyDisk, recorded by "
        f"DRIVEMON as a 'read' error; corrupt plan on drive 5: FileCorrupt")
    log(f"[storage] compress_stream of a 10 MiB block: {len(blob)} B "
        f"({len(blob) / len(block)} of it), {gibs(len(block), c_s)} GiB/s, "
        f"decompress {gibs(len(block), d_s)} GiB/s; sha256 == COMPRESS_PIN")
    log(f"[storage] phase 17: {phase_s:.1f} s")
    return {"launches": scan_launches["hh256"], "format_ms": format_ms,
            "put_ms": put_ms, "commit_ms": commit_ms, "scan_ms": scan_ms,
            "trace_wall_ms": trace["wall_ms"], "hh256_device_ms": hh_ms,
            "copies_ms": cp_ms, "device_ms": all_ms, "idle_share": idle,
            "phase_s": phase_s, "part_sha": part_sha}


# -- the erasure engine (phase 18) ---------------------------------------------

# Phase 18's multipart upload: two parts of 64 MiB and a last one of 5 MiB + 3 B.
MPU_PARTS = (64 * MIB, 64 * MIB, 5 * MIB + 3)
# Erasure shards (0-based) whose drives lose the object in the degraded GET,
# as phase 6 loses data shards 0 and 5, and the shard whose drive gets one
# byte rotted in frame 3.
LOST_SHARDS = (0, 5)
ROT_SHARD = 7


def engine_stack(root: str, dev):
    """The server's stack over 16 fresh drives under ``root`` on the card:
    format.json by init_or_load_formats (one set of 16), ErasureSets at
    12+4 with 10 MiB blocks (MinIO's EC:4) in one ErasureServerPools.
    Returns (pools, the set's engine)."""
    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.storage.format import init_or_load_formats
    from minio_tpu_torch.storage.xl import XLStorage

    drives = [XLStorage(str(Path(root) / f"d{i:02d}"), device=dev)
              for i in range(STORAGE_DRIVES)]
    fmt, ordered, fresh = init_or_load_formats(drives)
    check(len(fmt.sets) == 1 and len(fmt.sets[0]) == STORAGE_DRIVES
          and fresh == [], f"engine format: sets {fmt.sets}, fresh {fresh}")
    sets = ErasureSets(ordered, [STORAGE_DRIVES], fmt.deployment_id, 12, 4,
                       backend="gpu", device=dev)
    check(sets.sets[0].block_size == 10 * MIB, "engine block size")
    return ErasureServerPools([sets]), sets.sets[0]


def engine_parts(eng, name: str) -> dict:
    """{erasure index: (drive position, sha256 of its part.1, its
    FileInfo)} of object ``name`` in "bucket" on every drive of ``eng``."""
    out = {}
    for i, d in enumerate(eng.disks):
        fi = d.read_version("bucket", name)
        raw = Path(d.root, "bucket", name, fi.data_dir, "part.1").read_bytes()
        out[fi.erasure.index] = (i, hashlib.sha256(raw).hexdigest(), fi)
    return out


def engine_degrade(eng, parts: dict, S: int) -> tuple:
    """Remove "obj" from the drives of LOST_SHARDS and rot one byte of
    frame 3 in the part.1 of ROT_SHARD's drive. Returns (lost drive
    positions, rotted drive position)."""
    import os
    import shutil

    lost = [parts[j + 1][0] for j in LOST_SHARDS]
    for i in lost:
        shutil.rmtree(Path(eng.disks[i].root, "bucket", "obj"))
    rot, _, fi = parts[ROT_SHARD + 1]
    path = Path(eng.disks[rot].root, "bucket", "obj", fi.data_dir, "part.1")
    with open(path, "r+b") as f:
        f.seek(3 * (32 + S) + 32 + 1000)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x5A]))
    return lost, rot


def window_device_ms(prof, names) -> dict:
    """Device time (ms) of a torch.profiler session inside each
    record_function window of ``names``: {name: {"device_ms", "gf_apply_ms",
    "hh256_ms", "copies_ms", "top": the six largest (event, ms)}}, or None
    for a window with no device event. The windows' own annotations, which
    the profiler also lays on the device timeline, are not device work."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    devs = [e for e in evs if e.device_type == DeviceType.CUDA
            and e.name not in names]
    out = {}
    for name in names:
        win = next((e.time_range for e in evs if e.name == name), None)
        inside = [e for e in devs if win is not None
                  and win.start <= e.time_range.start < win.end]
        if not inside:
            out[name] = None
            continue

        def ms(pred, inside=inside):
            return sum(e.time_range.end - e.time_range.start
                       for e in inside if pred(e.name)) / 1e3
        by_name = {}
        for e in inside:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        out[name] = {"device_ms": ms(lambda n: True),
                     "gf_apply_ms": ms(lambda n: "gf_apply_kernel" in n),
                     "hh256_ms": ms(lambda n: "hh256_kernel" in n),
                     "copies_ms": ms(lambda n: "memcpy" in n.lower()),
                     "top": sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:6]}
    return out


def traced_engine(root: str) -> dict:
    """Phase 18's PUT and degraded GET once more by ``chip_smoke.py
    --engine-trace root`` in a process of its own (its torch.profiler
    session the first of that process)."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--engine-trace", root], capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"chip_smoke.py --engine-trace exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def engine_trace_main(root: str) -> None:
    """``--engine-trace ROOT``: a fresh stack of phase 18 over 16 drives
    under ROOT; a warm-up PUT + GET of one block, then the 259 MiB PUT and,
    after the drives of shards 0 and 5 lose it and shard 7's drive rots
    frame 3, the degraded GET, both in one torch.profiler session with a
    record_function window each. Prints one JSON object {"put_wall_ms",
    "get_wall_ms", "put_sha_ok", "get_sha_ok", "windows": by window,
    "session_device_ms": all device time of the session}."""
    np, torch = setup()
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device("cuda", 0)
    data = np.random.default_rng(1).integers(
        0, 256, 256 * MIB + 3 * MIB, dtype=np.uint8).tobytes()
    want_sha = hashlib.sha256(data).hexdigest()
    pools, eng = engine_stack(root, dev)
    pools.make_bucket("bucket")
    pools.put_object("bucket", "warm", data[:10 * MIB + 1])
    check(pools.get_object("bucket", "warm")[0] == data[:10 * MIB + 1],
          "warm-up GET")
    eng.mrf.start = lambda: None    # as in phase 18: the queue waits
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("engine.put"):
                info = pools.put_object("bucket", "obj", data)
                torch.cuda.synchronize()
            put_ms = (time.perf_counter() - t0) * 1e3
            parts = engine_parts(eng, "obj")
            engine_degrade(eng, parts, eng.codec.shard_size())
            t0 = time.perf_counter()
            with record_function("engine.degraded_get"):
                got, _ = pools.get_object("bucket", "obj")
                torch.cuda.synchronize()
            get_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pools.shutdown()
    print(json.dumps({
        "put_wall_ms": put_ms, "get_wall_ms": get_ms,
        "put_sha_ok": info.etag == hashlib.md5(data).hexdigest(),
        "get_sha_ok": hashlib.sha256(got).hexdigest() == want_sha,
        "windows": window_device_ms(prof, ("engine.put",
                                           "engine.degraded_get")),
        "session_device_ms": sum(device_us(prof).values()) / 1e3}),
        flush=True)


def engine_phase(np, torch, dev, payload, want_sha: str,
                 part_sha: dict) -> dict:
    """18. The erasure engine on the card: the server's stack (16 drives,
    one set, 12+4, 10 MiB blocks) takes phase 6's 259 MiB object through
    PUT, GET (full and ranged) and listing, a degraded GET, heal and the
    MRF queue, a three-part multipart upload, the boot recovery sweep and
    shutdown, every step asserted; the PUT and degraded GET once more under
    torch.profiler (``--engine-trace``). Returns the walls and the K1 / K2
    launches of each step and the traced device times."""
    import os
    import shutil
    import tempfile
    import threading

    from minio_tpu_torch.storage.recovery import sweep_layer
    from minio_tpu_torch.storage.xl import TMP_DIR

    t_phase = time.perf_counter()
    before = set(threading.enumerate())
    walls, launches = {}, {}

    def step(name: str, fn):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        got = read_launches()
        launches[name] = {"gf_apply": got["gf_apply"], "hh256": got["hh256"]}
        check(got["select_scan"] == 0, f"engine {name} launched X2")
        return out

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    data = payload.tobytes()
    size, bs = len(data), 10 * MIB
    root = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    trace_root = tempfile.mkdtemp(prefix="chip_smoke_engine_trace_")
    try:
        pools, eng = engine_stack(root, dev)
        S = eng.codec.shard_size()
        pools.make_bucket("bucket")

        # 1. PUT: ETag = md5; each drive's part.1 == the framed shard that
        #    phase 17 committed for its erasure index.
        info = step("put", lambda: pools.put_object("bucket", "obj", data))
        check(info.size == size and info.etag == hashlib.md5(data).hexdigest(),
              f"PUT: size {info.size}, etag {info.etag}")
        parts = engine_parts(eng, "obj")
        check(sorted(parts) == list(range(1, STORAGE_DRIVES + 1)),
              f"PUT: erasure indices {sorted(parts)}")
        for idx, (i, h, _) in parts.items():
            check(h == part_sha[idx], f"PUT: drive {i}'s part.1 (index {idx}) "
                  f"!= phase 17's framed shard")

        # 2. GET: full, a 3 MiB range across blocks 6 and 7, the listing.
        got, _ = step("get", lambda: pools.get_object("bucket", "obj"))
        check(sha(got) == want_sha, "GET sha256 != the payload's")
        del got
        off, ln = 7 * bs - 3 * MIB // 2, 3 * MIB
        got, _ = step("ranged_get", lambda: pools.get_object(
            "bucket", "obj", offset=off, length=ln))
        check(got == data[off:off + ln], "ranged GET across blocks 6 and 7")
        names = [o.name for o in pools.list_objects("bucket")]
        check(names == ["obj"], f"list_objects: {names}")

        # 3. Degraded GET: shards 0 and 5 lost, frame 3 of shard 7 rotted.
        #    The MRF worker is held back, so the queue keeps what the GET
        #    adds until step 4 heals through the heal front and drains it.
        eng.mrf.start = lambda: None
        lost, rot = engine_degrade(eng, parts, S)
        got, _ = step("degraded_get",
                      lambda: pools.get_object("bucket", "obj"))
        check(sha(got) == want_sha, "degraded GET sha256 != the payload's")
        del got
        check(eng.mrf.depth() == 1 and ("bucket", "obj") in eng.mrf._queued,
              f"MRF after the degraded GET: depth {eng.mrf.depth()}")

        # 4. Heal through the pools' heal front, then drain the MRF queue:
        #    every drive's part.1 and xl.meta as after the PUT.
        res = step("heal", lambda: pools.healer.heal_object("bucket", "obj"))
        check(sorted(res.healed_disks) == sorted(lost + [rot])
              and res.after_ok == STORAGE_DRIVES and not res.dangling,
              f"heal: {res}")
        step("mrf_drain", eng.mrf.drain)
        del eng.mrf.start
        check(eng.mrf.depth() == 0 and not eng.mrf._queued, "MRF not drained")
        healed = engine_parts(eng, "obj")
        for idx, (i, h, fi) in parts.items():
            check(healed[idx][:2] == (i, h), f"heal: drive {i}'s part.1")
            check(healed[idx][2] == fi, f"heal: drive {i}'s xl.meta")

        # 5. Multipart: three parts, complete, GET.
        def multipart():
            mp = pools.multipart
            uid = mp.new_multipart_upload("bucket", "mpu")
            done, at = [], 0
            for n, psize in enumerate(MPU_PARTS, 1):
                p = mp.put_object_part("bucket", "mpu", uid, n,
                                       data[at:at + psize])
                done.append((n, p["etag"]))
                at += psize
            return mp.complete_multipart_upload("bucket", "mpu", uid, done)

        minfo = step("multipart", multipart)
        mlen = sum(MPU_PARTS)
        got, ginfo = step("multipart_get",
                          lambda: pools.get_object("bucket", "mpu"))
        check(sha(got) == sha(data[:mlen]) and len(got) == mlen,
              "multipart GET sha256 != the parts' concatenation")
        check(minfo.etag.endswith("-3") and ginfo.etag == minfo.etag
              and minfo.size == mlen, f"multipart etag {minfo.etag}, GET "
              f"{ginfo.etag}, size {minfo.size}")
        del got

        # 6. Recovery: orphaned staging dirs on two drives, an hour old.
        planted = []
        for i in (2, 9):
            stage = Path(eng.disks[i].root, TMP_DIR, f"orphan-{i}")
            (stage / "dd").mkdir(parents=True)
            (stage / "dd" / "part.1").write_bytes(b"x" * 4096)
            old = time.time() - 3600
            os.utime(stage, (old, old))
            planted.append(stage)
        reports = sweep_layer(pools, age_s=60)
        check(len(reports) == 1 and reports[0]["found"] == 2
              and reports[0]["cleaned"] == 2
              and not any(p.exists() for p in planted),
              f"recovery sweep: {reports}")

        # 7. Shutdown: no thread of the engine left running (the listing's
        #    write-behind persist joined first; quorum_* threads are the
        #    process-wide pool of parallel/quorum.py).
        pools.shutdown()
        if eng.metacache.last_persist is not None:
            eng.metacache.last_persist.join(timeout=30)
        left = [t.name for t in threading.enumerate()
                if t not in before and t.is_alive()
                and not t.name.startswith("quorum_")]
        check(not left, f"threads left after shutdown: {left}")

        trace = traced_engine(trace_root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(trace_root, ignore_errors=True)
    check(trace["put_sha_ok"] and trace["get_sha_ok"],
          f"traced engine run: {trace}")
    traced = {}
    for key, win, wall in (("put", "engine.put", "put_wall_ms"),
                           ("degraded_get", "engine.degraded_get",
                            "get_wall_ms")):
        w = dict(trace["windows"][win] or {})
        top = w.pop("top", [])
        traced[key] = {"wall_ms": trace[wall], **w,
                       "idle_share": (1 - w["device_ms"] / trace[wall])
                       if w else None}
        log(f"[engine] traced {key}: largest device events {top}")
    totals = {kern: sum(v[kern] for v in launches.values())
              for kern in ("gf_apply", "hh256")}
    phase_s = time.perf_counter() - t_phase
    log(f"[engine] 16 drives, one set, 12+4, 10 MiB blocks, {size} B object "
        f"through ErasureServerPools on the card: walls (ms) {walls}")
    log(f"[engine] K1 / K2 launches by step: {launches}; total {totals}")
    log(f"[engine] PUT part files == phase 17's by index; GET, ranged GET "
        f"and degraded GET == the payload; heal healed drives "
        f"{sorted(res.healed_disks)} (after_ok {res.after_ok}); multipart "
        f"etag {minfo.etag}; recovery swept {reports[0]['cleaned']} "
        f"orphaned staging dirs; no engine thread left after shutdown")
    for key, t in traced.items():
        log(f"[engine] traced {key} in its own process: {t['wall_ms']} ms "
            f"wall, " + (f"device {t['device_ms']} ms (gf_apply "
                         f"{t['gf_apply_ms']}, hh256 {t['hh256_ms']}, copies "
                         f"{t['copies_ms']}), device idle share "
                         f"{t['idle_share']}" if t["idle_share"] is not None
                         else "device time not measured (no device event in "
                         f"its window; the whole session "
                         f"{trace['session_device_ms']} ms)"))
    log(f"[engine] phase 18: {phase_s:.1f} s")
    return {"launches": totals, "by_step": launches, "walls_ms": walls,
            "traced": traced, "phase_s": phase_s}


# -- the S3 front door (phase 19) ----------------------------------------------

FRONT_ACCESS, FRONT_SECRET = "chipadmin", "chipadmin-secret"


def admin_json(client, route: str) -> dict:
    r = client.request("GET", f"/minio-tpu/admin/v1/{route}")
    check(r.status == 200, f"admin {route}: HTTP {r.status} {r.body[:300]!r}")
    return json.loads(r.body)


def front_door_phase(np, torch, dev, payload, want_sha: str, part_sha: dict,
                     select_sha: list, engine: dict) -> dict:
    """19. The S3 front door on the card: a port ``S3Server`` (the async
    front door, the codec probe ladder off) over phase 18's stack (16
    drives, one set, 12+4, 10 MiB blocks, pinned to the card), driven with
    the port's SigV4 ``S3Client`` over loopback: MakeBucket, PUT of the
    259 MiB object (each part.1 equal to phase 17's by erasure index), GET,
    a ranged GET over blocks 6-7, ListObjectsV2 and HEAD, a degraded GET
    (shards 0 and 5 lost, frame 3 of shard 7 rotted), a three-part
    multipart upload and its GET, a REGEN PUT and its GET, Select on phase
    9's 256 MiB Parquet object (bodies equal to phase 9's), the metrics and
    admin endpoints (whose dispatch counters must equal the launches
    counted), DeleteObject, ``stop()`` and a thread census. Returns the
    walls and the K1 / K2 / X2 launches of each step."""
    import os
    import shutil
    import tempfile
    import threading
    from xml.sax.saxutils import escape

    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.s3select.message import decode_messages
    from minio_tpu_torch.storage.metadata import REGEN_ALGORITHM

    t_phase = time.perf_counter()
    env_keys = ("MINIO_CODEC_PROBE_ON_BOOT", "MINIO_FRONT_DOOR")
    env_before = {k: os.environ.get(k) for k in env_keys}
    os.environ["MINIO_CODEC_PROBE_ON_BOOT"] = "off"
    os.environ.pop("MINIO_FRONT_DOOR", None)
    walls, launches = {}, {}

    def step(name: str, fn, status: int):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = read_launches()
        check(r.status == status, f"front door {name}: HTTP {r.status}, "
              f"want {status}: {r.body[:300]!r}")
        return r

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    data = payload.tobytes()
    size, bs = len(data), 10 * MIB
    md5 = hashlib.md5(data).hexdigest()
    root = tempfile.mkdtemp(prefix="chip_smoke_front_")
    before = set(threading.enumerate())
    srv = None
    try:
        pools, eng = engine_stack(root, dev)
        S = eng.codec.shard_size()
        srv = S3Server(pools, FRONT_ACCESS, FRONT_SECRET)
        check(srv.layer.device == eng.device
              and eng.device.type == torch.device(dev).type,
              f"the server's layer runs on {srv.layer.device}")
        port = srv.start()
        check(type(srv._front_door).__name__ == "AsyncFrontDoor",
              "the async front door is not the default")
        c = S3Client("127.0.0.1", port, FRONT_ACCESS, FRONT_SECRET)
        stats0 = admin_json(c, "info")["tpu"]

        step("make_bucket", lambda: c.make_bucket("bucket"), 200)
        # PUT: streamed into the block pipeline (>= the 8 MiB threshold).
        r = step("put", lambda: c.put_object("bucket", "obj", data), 200)
        check(r.headers["etag"] == f'"{md5}"', f"PUT etag {r.headers}")
        parts = engine_parts(eng, "obj")
        for idx, (i, h, _) in parts.items():
            check(h == part_sha[idx], f"PUT over HTTP: drive {i}'s part.1 "
                  f"(index {idx}) != phase 17's framed shard")
        r = step("get", lambda: c.get_object("bucket", "obj"), 200)
        check(sha(r.body) == want_sha, "GET over HTTP: sha256 != payload's")
        off, ln = 7 * bs - 3 * MIB // 2, 3 * MIB
        r = step("ranged_get", lambda: c.get_object(
            "bucket", "obj", headers={"range": f"bytes={off}-{off + ln - 1}"}),
            206)
        check(r.body == data[off:off + ln], "ranged GET over blocks 6-7")
        r = step("list_v2", lambda: c.list_objects_v2("bucket"), 200)
        check(b"<Key>obj</Key>" in r.body and r.body.count(b"<Key>") == 1,
              f"ListObjectsV2: {r.body[:300]!r}")
        r = step("head", lambda: c.head_object("bucket", "obj"), 200)
        check(int(r.headers["content-length"]) == size, f"HEAD {r.headers}")
        if eng.metacache.last_persist is not None:
            eng.metacache.last_persist.join(timeout=30)

        # Degraded GET: the MRF worker held back, as in phase 18.
        eng.mrf.start = lambda: None
        engine_degrade(eng, parts, S)
        r = step("degraded_get", lambda: c.get_object("bucket", "obj"), 200)
        check(sha(r.body) == want_sha, "degraded GET over HTTP: sha256")
        check(eng.mrf.depth() == 1, f"MRF depth {eng.mrf.depth()}")

        # Multipart: 64 + 64 + 5 MiB + 3 B, each part streamed.
        def multipart():
            r = c.request("POST", "/bucket/mpu", query="uploads=")
            check(r.status == 200, f"CreateMultipartUpload {r.status}")
            uid = r.body.split(b"<UploadId>")[1].split(b"</UploadId>")[0]
            done, at = [], 0
            for n, psize in enumerate(MPU_PARTS, 1):
                r = c.request("PUT", "/bucket/mpu",
                              query=f"partNumber={n}&uploadId={uid.decode()}",
                              body=data[at:at + psize])
                check(r.status == 200, f"UploadPart {n}: {r.status}")
                done.append(f"<Part><PartNumber>{n}</PartNumber><ETag>"
                            f"{r.headers['etag']}</ETag></Part>")
                at += psize
            return c.request(
                "POST", "/bucket/mpu", query=f"uploadId={uid.decode()}",
                body=("<CompleteMultipartUpload>" + "".join(done)
                      + "</CompleteMultipartUpload>").encode())

        r = step("multipart", multipart, 200)
        check(b'-3"</ETag>' in r.body,
              f"CompleteMultipartUpload: {r.body[:300]!r}")
        mlen = sum(MPU_PARTS)
        r = step("multipart_get", lambda: c.get_object("bucket", "mpu"), 200)
        check(len(r.body) == mlen and sha(r.body) == sha(data[:mlen]),
              "multipart GET over HTTP != the parts' concatenation")

        # REGEN: the storage class stamps pm-mbr-rbt on the object.
        step("regen_put", lambda: c.put_object(
            "bucket", "regen", data,
            headers={"x-amz-storage-class": "REGEN"}), 200)
        algo = eng.disks[0].read_version("bucket", "regen").erasure.algorithm
        check(algo == REGEN_ALGORITHM, f"REGEN PUT wrote {algo}")
        r = step("regen_get", lambda: c.get_object("bucket", "regen"), 200)
        check(sha(r.body) == want_sha, "REGEN GET over HTTP: sha256")

        # Select on phase 9's object: the bodies must be phase 9's.
        table = select_object(np, SELECT_ROWS)
        step("select_put", lambda: c.put_object("bucket", "table.parquet",
                                                table), 200)
        del table
        for i, q in enumerate(SELECT_QUERIES):
            xml = ("<SelectObjectContentRequest><Expression>" + escape(q)
                   + "</Expression><ExpressionType>SQL</ExpressionType>"
                   "<InputSerialization><Parquet/></InputSerialization>"
                   "<OutputSerialization><JSON/></OutputSerialization>"
                   "</SelectObjectContentRequest>").encode()
            r = step(f"select_q{i + 1}", lambda xml=xml: c.request(
                "POST", "/bucket/table.parquet",
                query="select=&select-type=2", body=xml), 200)
            msgs = decode_messages(r.body)
            check(msgs and msgs[0]["headers"].get(":message-type")
                  != "error", f"select q{i + 1} answered {msgs[:1]}")
            check(sha(r.body) == select_sha[i],
                  f"select q{i + 1} over HTTP: body != phase 9's")

        # Metrics and admin: the dispatch counters of the kernel lane moved
        # by exactly the launches counted (no traffic ran in between).
        r = c.request("GET", "/minio-tpu/metrics")
        check(r.status == 200 and b"minio_tpu_" in r.body,
              f"metrics: HTTP {r.status}")
        stats1 = admin_json(c, "info")["tpu"]
        health = admin_json(c, "kernel-health")["backends"]
        total = {kern: sum(v[kern] for v in launches.values())
                 for kern in ("gf_apply", "hh256", "select_scan")}
        counted = {
            "gf_apply": stats1["rs"]["tpu_dispatches"]
            - stats0["rs"]["tpu_dispatches"],
            "hh256": stats1["bitrot"]["tpu_dispatches"]
            - stats0["bitrot"]["tpu_dispatches"]}
        check(counted["gf_apply"] == total["gf_apply"]
              and counted["hh256"] == total["hh256"],
              f"admin tpu_dispatches {counted} != launches {total}")
        check(health["device"]["state"] == "up"
              and not health["device"]["failures"],
              f"admin kernel-health: {health['device']}")

        step("delete", lambda: c.delete_object("bucket", "obj"), 204)
        check(c.head_object("bucket", "obj").status == 404,
              "HEAD after DeleteObject")
        if eng.metacache.last_persist is not None:
            eng.metacache.last_persist.join(timeout=30)
        srv.stop()
        srv = None
        deadline = time.monotonic() + 10
        while True:
            left = [t.name for t in threading.enumerate()
                    if t not in before and t.is_alive()
                    and not t.name.startswith("quorum_")]
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        check(not left, f"threads left after stop(): {left}")
    finally:
        if srv is not None:
            srv.stop()
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    for kern in ("gf_apply", "hh256", "select_scan"):
        check(total[kern] > 0, f"the front door never launched {kern}")
    phase_s = time.perf_counter() - t_phase
    log(f"[front door] S3Server (async front door) over 16 drives, 12+4, "
        f"10 MiB blocks on the card, SigV4 over loopback: walls (ms) {walls}")
    log(f"[front door] K1 / K2 / X2 launches by step: {launches}; total "
        f"{total}; admin tpu_dispatches moved by {counted}")
    ew = engine["walls_ms"]
    for name, eng_name in (("put", "put"), ("get", "get"),
                           ("ranged_get", "ranged_get"),
                           ("degraded_get", "degraded_get"),
                           ("multipart", "multipart"),
                           ("multipart_get", "multipart_get")):
        log(f"[front door] {name}: {walls[name]} ms over HTTP, "
            f"{ew[eng_name]} ms through the engine (phase 18), "
            f"difference {walls[name] - ew[eng_name]} ms")
    log(f"[front door] every body byte-exact (GET, ranges, degraded GET, "
        f"multipart, REGEN, Select == phase 9); no thread of the server "
        f"left after stop(); phase 19: {phase_s:.1f} s")
    return {"launches": total, "by_step": launches, "walls_ms": walls,
            "phase_s": phase_s}


def setup():
    """(numpy, torch) once a card and the port beside this file are
    there; exits non-zero otherwise."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    here = Path(__file__).resolve().parent
    if not (here / "minio_tpu_torch" / "csrc" / "gf_apply.cu").exists():
        fail("minio_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(here))
    return np, torch


def main() -> None:
    np, torch = setup()
    from minio_tpu_torch.erasure import bitrot
    from minio_tpu_torch.erasure.codec import Erasure
    from minio_tpu_torch.models import ec_pipeline
    from minio_tpu_torch.ops import _cuda, hh256, hh256_gpu, rs_cpu, rs_gpu

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    errs = {"gf_apply": 0, "hh256": 0}

    # 1. Census.
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = smi_line()
    log(f"[census] {name} capability {cap[0]}.{cap[1]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} devices "
        f"{torch.cuda.device_count()}")
    log(smi)
    check(cap == (9, 0), f"need compute capability 9.0, got {cap}")

    # 2. Build.
    lib = _cuda.build()
    log(f"[build] nvcc {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.ptxas_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")

    # 3. Kernel vs plain version, on the card, byte-exact.
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for k, m in [(2, 1), (4, 2), (8, 4), (12, 4), (16, 4), (40, 5)]:
        bm = rs_gpu.placed_parity(k, m, dev)
        for S in (1, 127, 4097, 873814):
            x = torch.from_numpy(rng.integers(0, 256, (2, k, S),
                                              dtype=np.uint8)).to(dev)
            plain = rs_gpu.gf_apply_plain(bm.dense, x)
            e = max_err(torch, rs_gpu.gf_apply(bm, x), plain)
            e = max(e, max_err(torch, rs_gpu.gf_apply(bm, x[1]), plain[1]))
            full = rs_gpu.encode_blocks(bm, x)
            e = max(e, max_err(torch, full[:, k:], plain))
            e = max(e, max_err(torch, full[:, :k], x))
            sm = rs_gpu.encode_blocks_shardmajor(bm, x)
            e = max(e, max_err(torch, sm, full.transpose(0, 1)))
            errs["gf_apply"] = max(errs["gf_apply"], e)
            check(e == 0, f"gf_apply k={k} m={m} S={S}: kernel != plain")
        missing = tuple(sorted({0, k + m - 1} | ({1} if m >= 3 else set()))
                        )[:m]
        avail = tuple(i for i in range(k + m) if i not in missing)
        dm, used = rs_gpu.placed_any_decode(k, m, avail, missing, dev)
        survivors = full[:, list(used)]
        e = max_err(torch, rs_gpu.gf_apply(dm, survivors),
                    rs_gpu.gf_apply_plain(dm.dense, survivors))
        e = max(e, max_err(torch, rs_gpu.gf_apply(dm, survivors),
                           full[:, list(missing)]))
        errs["gf_apply"] = max(errs["gf_apply"], e)
        check(e == 0, f"gf_apply decode k={k} m={m}: mismatch")
    bm84 = rs_gpu.placed_parity(8, 4, dev)
    x = torch.from_numpy(rng.integers(0, 256, (2, 8, 1310720),
                                      dtype=np.uint8)).to(dev)
    e = max_err(torch, rs_gpu.encode_blocks(bm84, x)[:, 8:],
                rs_gpu.gf_apply_plain(bm84.dense, x))
    errs["gf_apply"] = max(errs["gf_apply"], e)
    check(e == 0, "gf_apply full width: kernel != plain")
    errs["gf_apply"] = max(errs["gf_apply"], gf_layout_checks(np, torch,
                                                              dev, rng))
    log(f"[kernels] gf_apply == plain for 6 (k, m), S up to 1310720 (16-byte "
        f"and byte paths, ragged S), rows at offsets 1..15, 2-D/3-D, both "
        f"output layouts, decode, random r = 12 matrix "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    for L in (1, 31, 32, 33, 4096 + 17, 65536 + 5):
        c = torch.from_numpy(rng.integers(0, 256, (64, L + 3),
                                          dtype=np.uint8)).to(dev)
        for rows in (c[:, :L].contiguous(), c[:, 1:L + 1]):
            e = max_err(torch, hh256_gpu.hash_chunks(rows),
                        hh256_gpu.hash_chunks_plain(rows))
            errs["hh256"] = max(errs["hh256"], e)
            check(e == 0, f"hh256 L={L}: kernel != plain")
    pi = torch.tensor(list(hh256.PI_100_DECIMALS.encode()),
                      dtype=torch.uint8, device=dev)[None]
    check(hh256_gpu.hash_chunks(pi, b"\0" * 32).cpu().numpy().tobytes()
          == hh256.MAGIC_KEY, "hh256 magic-key vector")
    v64 = b"0123456789abcdef" * 4
    t64 = torch.tensor(list(v64), dtype=torch.uint8, device=dev)[None]
    check(hh256_gpu.hash_chunks(t64, b"\0" * 32).cpu().numpy().tobytes()
          == hh256.hh256(v64, b"\0" * 32), "hh256 32-aligned vector")
    two = rng.integers(0, 256, (2, 873814), dtype=np.uint8)
    got = hh256_gpu.hash_chunks(torch.from_numpy(two).to(dev)).cpu().numpy()
    for b in range(2):
        check(got[b].tobytes() == hh256.hh256(two[b].tobytes()),
              "hh256 at L=873814 != host reference")
    errs["hh256"] = max(errs["hh256"], hh_layout_checks(np, torch, dev,
                                                          rng))
    log(f"[kernels] hh256 == plain for L in 1..65541, every L % 32, row "
        f"starts at every offset mod 16, B in 1..64 (not multiples of 16), "
        f"== host hh256 at L=873814 ({time.perf_counter() - t0:.1f} s)")

    # 4. Golden pins through the kernels.
    data = pattern(np, 65536)
    for (k, m), (sha, first16) in PARITY_PINS.items():
        shards = rs_cpu.split(data, k, m)
        out = rs_gpu.encode_batch(shards[None, :k], k, m, dev)[0]
        check(hashlib.sha256(out[k:].tobytes()).hexdigest() == sha,
              f"PARITY_PINS {(k, m)}")
        check(out[k, :16].tobytes().hex() == first16, f"first16 {(k, m)}")
    shards = rs_gpu.encode_batch(rs_cpu.split(data, 8, 4)[None, :8], 8, 4,
                                 dev)[0]
    framed = bitrot.encode_stream(shards[0].tobytes(), 4096, device=dev)
    check(len(framed) == FRAMED_LEN, "FRAMED_LEN")
    check(hashlib.sha256(framed).hexdigest() == FRAMED_DATA_SHA,
          "FRAMED_DATA_SHA")
    check(framed[:32].hex() == FRAMED_DATA_FIRST_HASH,
          "FRAMED_DATA_FIRST_HASH")
    framed_p = bitrot.encode_stream(shards[8].tobytes(), 4096, device=dev)
    check(hashlib.sha256(framed_p).hexdigest() == FRAMED_PARITY_SHA,
          "FRAMED_PARITY_SHA")
    check(bitrot.verify_stream(framed, 4096, device=dev), "verify_stream")
    log("[pins] PARITY_PINS 8+4 12+4 16+4, FRAMED_DATA_SHA, "
        "FRAMED_DATA_FIRST_HASH, FRAMED_PARITY_SHA: all match")

    # 5./6. The main path, with every launch count zeroed just before.
    rs_gpu.gf_apply_cuda.launches = 0
    hh256_gpu.hash_chunks_cuda.launches = 0
    main_t0 = time.perf_counter()

    # 5. Flagship step at full width: 320 MiB of data, 480 MiB of shards.
    cfg = ec_pipeline.ECConfig(8, 4)
    t0 = time.perf_counter()
    enc, dec, fdata, used = ec_pipeline.make_full_step_inputs(
        cfg, batch=32, shard_size=1310720, missing=(0, 3), device=dev)
    t_inputs = time.perf_counter() - t0
    out = {}
    step_ms = wall_ms(torch, lambda: out.update(
        ec_pipeline.full_step(enc, dec, fdata, used)))
    mismatch = int(out["mismatch"])
    check(out["shards"].shape == (32, 12, 1310720), "full_step shards")
    check(out["rebuilt"].shape == (32, 8, 1310720), "full_step rebuilt")
    check(mismatch == 0, f"full_step mismatch {mismatch}")
    check(torch.equal(out["shards"][:, :8], fdata), "full_step data rows")
    log(f"[full_step] 8+4 B=32 S=1310720: mismatch 0, step {step_ms} ms "
        f"wall (inputs {t_inputs:.2f} s on the host)")
    del out
    hh_before_6 = hh256_gpu.hash_chunks_cuda.launches

    # 6. PUT -> degraded GET -> heal at deployment size: 12+4, 10 MiB
    #    blocks, a seeded 256 MiB + 3 MiB object (25 full blocks + tail).
    k, m, bs = 12, 4, 10 * MIB
    size = 256 * MIB + 3 * MIB
    codec = Erasure(k, m, block_size=bs, backend="gpu")
    S = codec.shard_size()
    payload = np.random.default_rng(1).integers(0, 256, size,
                                                dtype=np.uint8)
    want_sha = hashlib.sha256(payload).hexdigest()
    p6 = data_plane(np, torch, codec, dev, payload, want_sha, traced=True)
    main_s = time.perf_counter() - main_t0
    tail, nfull = p6["tail"], p6["nfull"]
    dev_us = p6["dev_us"]
    gf_us = sum(v for n, v in dev_us.items() if "gf_apply_kernel" in n)
    hh_us = sum(v for n, v in dev_us.items() if "hh256_kernel" in n)
    cp_us = sum(v for n, v in dev_us.items() if "memcpy" in n.lower())
    all_us = sum(dev_us.values())
    launches = {"gf_apply": rs_gpu.gf_apply_cuda.launches,
                "hh256": hh256_gpu.hash_chunks_cuda.launches}
    log(f"[data plane] 12+4 10 MiB blocks, {size} B object: PUT "
        f"{p6['put_ms']} ms, degraded GET (verify + rebuild 0,5,7 + "
        f"sha) {p6['get_ms']} ms, heal {p6['heal_ms']} ms end to end "
        f"incl. host<->device copies; rotten frame (3, 7) flagged; GET "
        f"sha256 == input; heal byte-identical")
    if all_us:
        e2e_ms = p6["put_ms"] + p6["get_ms"] + p6["heal_ms"]
        log(f"[data plane] device time (torch.profiler): gf_apply kernel "
            f"{gf_us / 1e3} ms, hh256 kernel {hh_us / 1e3} ms, host<->device "
            f"copies {cp_us / 1e3} ms, all device work {all_us / 1e3} ms of "
            f"{e2e_ms} ms end to end (device idle share "
            f"{1 - all_us / 1e3 / e2e_ms})")
    else:
        log("[data plane] device time: not measured (the profiler "
            "reported no device time)")
    hh_phase6 = launches["hh256"] - hh_before_6
    log(f"[main path] {main_s} s, launches {launches}; hh256 launches in "
        f"phase 6: {hh_phase6} (PUT full + PUT tails + GET full + GET "
        f"tails)")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(hh_phase6 == 4, f"phase 6 launched hh256 {hh_phase6} times, "
          f"want 4")

    # 7. Times at the main-path shapes.
    B, K, R, SS = 32, 8, 4, 1310720
    xk = fdata
    ok1 = torch.empty((B, K + R, SS), dtype=torch.uint8, device=dev)
    k1_ms = events_ms(torch, lambda: rs_gpu.gf_apply_cuda(
        enc, xk, ok1, (K + R) * SS, SS, K, True))
    k1_plain_ms = wall_ms(torch, lambda: rs_gpu.gf_apply_plain(enc.dense,
                                                               xk), runs=3)
    k1_bytes = B * K * SS + B * (K + R) * SS
    k1_ops = 2 * (8 * R) * (8 * K) * SS * B
    k1_bound = max(k1_bytes / HBM_BPS, k1_ops / INT8_OPS) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BPS >= k1_ops / INT8_OPS \
        else "operations"
    del ok1

    # K1 at phase 6's shape: shard-major encode of (25, 12, 873814), whose
    # rows are not 16-byte aligned (the byte path).
    bm124 = rs_gpu.placed_parity(k, m, dev)
    x6 = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (nfull, k, S), dtype=np.uint8)).to(dev)
    o6 = torch.empty((k + m, nfull, S), dtype=torch.uint8, device=dev)
    k1_p6_ms = events_ms(torch, lambda: rs_gpu.gf_apply_cuda(
        bm124, x6, o6, S, nfull * S, k, True))
    k1_p6_bound = (nfull * S * (2 * k + m)) / HBM_BPS * 1e3
    del x6, o6

    HB, HL = (k + m) * nfull, S
    rows = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (HB, HL), dtype=np.uint8)).to(dev)
    k2_ms = events_ms(torch, lambda: hh256_gpu.hash_chunks_cuda(
        rows, hh256.MAGIC_KEY))
    # The plain version on the first 32 rows (rows are independent chains;
    # its time is launch-bound, one torch op per step of the chain).
    PB = 32
    t0 = time.perf_counter()
    plain_digs = hh256_gpu.hash_chunks_plain(rows[:PB])
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    full_digs = hh256_gpu.hash_chunks_cuda(rows, hh256.MAGIC_KEY)
    lone = hh256_gpu.hash_chunks_cuda(rows[:1], hh256.MAGIC_KEY)
    e = max(max_err(torch, full_digs[:PB], plain_digs),
            max_err(torch, lone, plain_digs[:1]))
    errs["hh256"] = max(errs["hh256"], e)
    check(e == 0, "hh256 at the main-path shape (and its lone chain): "
          "kernel != plain")
    # A PUT's tails: 16 rows of 786,432 bytes, as a batch and one alone.
    TL = tail.shape[1]
    tails = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (k + m, TL), dtype=np.uint8)).to(dev)
    tails_plain = hh256_gpu.hash_chunks_plain(tails)
    e = max(max_err(torch, hh256_gpu.hash_chunks_cuda(tails,
                                                      hh256.MAGIC_KEY),
                    tails_plain),
            max_err(torch, hh256_gpu.hash_chunks_cuda(tails[5:6],
                                                      hh256.MAGIC_KEY),
                    tails_plain[5:6]))
    errs["hh256"] = max(errs["hh256"], e)
    check(e == 0, f"hh256 at ({k + m}, {TL}) and (1, {TL}): kernel != plain")
    k2_tails_ms = events_ms(torch, lambda: hh256_gpu.hash_chunks_cuda(
        tails, hh256.MAGIC_KEY))
    lone_ms = events_ms(torch, lambda: hh256_gpu.hash_chunks_cuda(
        rows[:1], hh256.MAGIC_KEY))
    lone_tail_ms = events_ms(torch, lambda: hh256_gpu.hash_chunks_cuda(
        tails[:1], hh256.MAGIC_KEY))
    # A lone chain of 262,144 bytes (a 3 MiB tail block over 12 shards),
    # against the host reference.
    short = tails[:1, :262144]
    check(hh256_gpu.hash_chunks_cuda(short, hh256.MAGIC_KEY).cpu().numpy()
          .tobytes() == hh256.hh256(short.cpu().numpy().tobytes()),
          "hh256 lone chain at L=262144 != host hh256")
    lone_short_ms = events_ms(torch, lambda: hh256_gpu.hash_chunks_cuda(
        short, hh256.MAGIC_KEY))
    # The PUT's tail hashing, both dispatches in this run: the 16 tails in
    # one batch (digest_chunks_many) and one batch per tail (as before).
    tail_streams = [tail[j].tobytes() for j in range(k + m)]
    batched_ms = wall_ms(torch, lambda: bitrot.digest_chunks_many(
        bitrot.DEFAULT_ALGORITHM, tail_streams, S, device=dev), runs=5)
    one_by_one_ms = wall_ms(torch, lambda: [
        bitrot.digest(bitrot.DEFAULT_ALGORITHM, t, dev)
        for t in tail_streams], runs=5)
    n_updates = HL // 32 + (1 if HL % 32 else 0) + 10
    k2_bytes = HB * HL + HB * 32
    k2_ops = HB * n_updates * HH_OPS_PER_UPDATE
    k2_bound = max(k2_bytes / HBM_BPS, k2_ops / SCALAR_OPS) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BPS >= k2_ops / SCALAR_OPS \
        else "operations"
    log(f"[times] gf_apply (32, 8->12, 1310720): {k1_ms} ms, bound "
        f"{k1_bound} ms ({k1_by}), plain {k1_plain_ms} ms")
    log(f"[times] gf_apply at phase 6's shape, shard-major (25, 12->16, "
        f"{S}), byte path: {k1_p6_ms} ms, byte bound {k1_p6_bound} ms")
    log(f"[times] hh256 ({HB}, {HL}): {k2_ms} ms, bound "
        f"{k2_bound} ms ({k2_by}), plain {k2_plain_ms} ms on the first "
        f"{PB} rows (compared byte-exact there)")
    log(f"[times] hh256 PUT tails ({k + m}, {TL}): {k2_tails_ms} ms")
    log(f"[times] hh256 lone chain (1, {HL}): {lone_ms} ms, "
        f"{lone_ms * 1e6 / (HL / 32)} ns per 32-byte packet; (1, {TL}): "
        f"{lone_tail_ms} ms, {lone_tail_ms * 1e6 / (TL / 32)} ns per packet; "
        f"(1, 262144): {lone_short_ms} ms, "
        f"{lone_short_ms * 1e6 / (262144 / 32)} ns per packet")
    log(f"[times] PUT tail hashing, wall incl. copies, median of 5: {k + m} "
        f"tails of {TL} B in one hash_chunks call (digest_chunks_many) "
        f"{batched_ms} ms; one call per tail (digest x {k + m}) "
        f"{one_by_one_ms} ms")

    # 8.-10. The S3 Select slice: X2 against its plain version, the
    #        SelectObjectContent path on a 256 MiB Parquet object, times.
    x2_err = select_kernel_checks(np, torch, dev)
    x2_launches, batch, plan, select_sha = select_path(np, torch, dev)
    x2 = select_times(np, torch, dev, batch, plan, lib.ptxas_log)

    # 11.-16. The dispatch plane and the REGEN class.
    t_plane = time.perf_counter()
    native_lane(np, torch, dev, payload)
    ladder = ladder_phase()
    coal = coalescer_phase(np, torch, dev)
    auto = auto_phase(np, torch, payload, want_sha, p6)
    regen = regen_phase(np, torch, dev, payload, want_sha)
    place = placement_phase(torch, [torch.device("cuda", i) for i in range(
        torch.cuda.device_count())], enc, dec, fdata, used)
    final_health()
    log(f"[dispatch plane] phases 11-16: "
        f"{time.perf_counter() - t_plane:.1f} s")

    # 17. The storage layer on the card.
    storage = storage_phase(np, torch, payload)
    part_sha = storage.pop("part_sha")

    # 18. The erasure engine on the card.
    engine = engine_phase(np, torch, dev, payload, want_sha, part_sha)

    # 19. The S3 front door on the card.
    front = front_door_phase(np, torch, dev, payload, want_sha, part_sha,
                             select_sha, engine)

    kernels = [
        {"name": "gf_apply", "route": "cuda",
         "source": "minio_tpu_torch/csrc/gf_apply.cu",
         "replaces": "minio_tpu/ops/rs_pallas.py:81",
         "launches": launches["gf_apply"],
         "max_abs_err": errs["gf_apply"], "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None,
         "shape": "encode_blocks (32, 8, 1310720) -> (32, 12, 1310720)",
         "plain_shape": "the same",
         "library_note": "no PyTorch call computes a GF(2^8) linear map",
         "regen": regen,
         "launches_by_path": {
             "ladder": ladder["launches"]["gf_apply"],
             "coalescer": coal["launches"]["gf_apply"],
             "auto": auto["launches"]["gf_apply"],
             "regen": regen["launches"],
             "placement": place["launches"]["gf_apply"],
             "engine": engine["launches"]["gf_apply"],
             "front_door": front["launches"]["gf_apply"]}},
        {"name": "hh256", "route": "cuda",
         "source": "minio_tpu_torch/csrc/hh256.cu",
         "replaces": "minio_tpu/ops/hh256_tpu.py:232",
         "launches": launches["hh256"],
         "max_abs_err": errs["hh256"], "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None,
         "shape": f"hash_chunks ({HB}, {HL}) -> ({HB}, 32)",
         "plain_shape": f"({PB}, {HL}), the first {PB} rows",
         "lone_chain_ns_per_packet": lone_ms * 1e6 / (HL / 32),
         "library_note": "no PyTorch call computes HighwayHash",
         "storage": storage,
         "engine": engine,
         "launches_by_path": {
             "auto": auto["launches"]["hh256"],
             "storage": storage["launches"],
             "engine": engine["launches"]["hh256"],
             "front_door": front["launches"]["hh256"]}},
        {"name": "select_scan", "route": "cuda",
         "source": "minio_tpu_torch/csrc/select_scan.cu",
         "replaces": "minio_tpu/ops/select_kernels.py:163",
         "launches": x2_launches, "max_abs_err": x2_err, "ms": x2["ms"],
         "plain_ms": x2["plain_ms"], "bound_ms": x2["bound_ms"],
         "bound_by": x2["bound_by"], "library_ms": None,
         "bound_old_formula_ms": x2["bound_old_formula_ms"],
         "ptxas": x2["ptxas"],
         "shape": x2["shape"], "plain_shape": "the same",
         "library_note": "no single PyTorch call computes a predicate "
                         "program",
         "front_door": front,
         "launches_by_path": {
             "front_door": front["launches"]["select_scan"]}},
    ]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--select-trace"]:
        select_trace_main()
    elif sys.argv[1:2] == ["--storage-trace"] and len(sys.argv) == 3:
        storage_trace_main(sys.argv[2])
    elif sys.argv[1:2] == ["--engine-trace"] and len(sys.argv) == 3:
        engine_trace_main(sys.argv[2])
    else:
        main()
