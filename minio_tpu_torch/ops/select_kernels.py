"""Batched predicate scan for columnar S3 Select: kernel X2 on the card.

Port of minio_tpu/ops/select_kernels.py. The scan engine
(s3select/engine.py) hands a compiled predicate plan plus one
ColumnBatch here per dispatch; the answer is the (pass, fallback) row
masks.

- **The kernel.** The reference traces the compile.py node tree under
  ``jax.jit`` once per plan (``_build_jit``). Compiling CUDA per query
  would cost seconds of nvcc on the serving path, so the port lowers
  the tree ONCE per plan into a short postfix program (int32
  instructions plus a float32 constant pool, ``lower_program``) that
  one hand-written interpreter kernel runs, one thread per row
  (csrc/select_scan.cu). ``eval_program_plain`` runs the same program
  with torch ops on whole columns: the CPU lane, and the yardstick the
  kernel is held to on the card.
- **Eligibility** is the reference's: only float32-exact plans
  (compile.Plan.jit_ok) over float32 / int32 / bool columns
  (``bind_plan``, the rules of the reference's ``_bind_jit``) run as a
  program; int32 cells past 2^24 join the fallback mask at bind. Any
  other plan runs on the host numpy lane (``plan.eval_host``), which
  is the reference's own semantics for it.
- **The lane is the caller's device**: ``device="cuda"`` launches the
  kernel (a CUDA error raises; the reference's move to the host lane
  after a failed dispatch is not carried over), ``device="cpu"`` runs
  the plain version. The reference's autotuned lane choice
  (``choose_lane``) and ``probe_lane`` are not ported yet.
- **QoS**: every dispatch enters the priority gate on the BACKGROUND
  lane, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.kernel_stats import KERNEL, SELECT_SCAN, timed
from . import _cuda

# int32 cells past float32's exact-integer range (2^24) cannot ride
# the float32 program exactly; they take the row fallback instead.
_F32_INT_EXACT = 1 << 24

# Opcodes of a predicate program; csrc/select_scan.cu mirrors them. An
# instruction is four int32 (op, a, b, c). Stack entries are
# (val float32, valid, miss); bool values are 0.0 / 1.0.
OP_COL = 0         # a: column         push (vals, valid, miss) of column a
OP_CONST = 1       # a: pool index, b: valid, c: miss
OP_CMP_NUM = 2     # a: comparison     val = (l a r) & l.valid & r.valid
OP_CMP_BOOL = 3    # a: comparison     val = (l a r)
OP_CMP_FALSE = 4   #                   val = False
#                    every comparison: valid = l.valid & r.valid, miss 0
OP_BETWEEN = 5     # a: negate         pop hi, lo: val = lo & hi (^ negate)
OP_IN_OR = 6       #                   pop c: hit |= c.val & c.valid
OP_IN_END = 7      # a: negate         pop hit, value: (hit ^ negate,
#                                      value.valid)
OP_ISNULL = 8      # a: negate, b: IS MISSING (else IS NULL)
OP_AND = 9         # a, b: left / right operand is of kind null
OP_OR = 10         # a, b: as OP_AND
OP_NOT = 11        # a: operand is of kind null

# Comparison codes (the ``a`` of the OP_CMP_* instructions).
CMP_CODES = {"=": 0, "!=": 1, "<>": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

# The kernel's per-thread stack (csrc/select_scan.cu kMaxStack). A plan
# whose program needs a deeper stack runs on the host lane.
MAX_STACK = 64


class Program:
    """A lowered predicate: (m, 4) int32 instructions, a float32
    constant pool, and the stack depth they need. Device copies are
    made once per device."""

    __slots__ = ("ops", "pool", "depth", "ncols", "_placed")

    def __init__(self, ops: np.ndarray, pool: np.ndarray, depth: int,
                 ncols: int):
        self.ops = ops
        self.pool = pool
        self.depth = depth
        self.ncols = ncols
        self._placed: dict = {}

    def placed(self, device: torch.device):
        got = self._placed.get(device)
        if got is None:
            got = (torch.from_numpy(self.ops).to(device),
                   torch.from_numpy(self.pool).to(device))
            self._placed[device] = got
        return got


def lower_program(plan) -> Program | None:
    """The plan's postfix program (cached on the plan), or None when the
    plan is not kernel eligible (``plan.jit_ok`` false, or a stack
    deeper than the kernel's)."""
    if plan._program is not None:
        return plan._program or None
    prog = None
    if plan.jit_ok:
        prog = _Lowering(plan).program()
        if prog.depth > MAX_STACK:
            prog = None
    plan._program = prog if prog is not None else False
    return prog


class _Lowering:
    """Walks the compile.py node tree in evaluation order and emits one
    instruction per value, reproducing each node's three-valued rules
    (compile.py CCmp / CBetween / CIn / CIsNull / CBool / CNot)."""

    def __init__(self, plan):
        self.plan = plan
        self.col_index = {name: i for i, name in enumerate(plan.cols)}
        self.ops: list[tuple[int, int, int, int]] = []
        self.pool: list[float] = []
        self.sp = 0
        self.depth = 0

    def program(self) -> Program:
        kind = self.emit(self.plan.root)
        if kind != "bool" or self.sp != 1:
            raise ValueError("predicate program does not leave one row "
                             "mask on the stack")
        return Program(np.asarray(self.ops, dtype=np.int32).reshape(-1, 4),
                       np.asarray(self.pool or [0.0], dtype=np.float32),
                       self.depth, len(self.plan.cols))

    def _op(self, op: int, a: int = 0, b: int = 0, c: int = 0,
            pops: int = 0, pushes: int = 0) -> None:
        self.ops.append((op, a, b, c))
        self.sp += pushes - pops
        self.depth = max(self.depth, self.sp)

    def _const(self, value: float, valid: bool) -> None:
        self.pool.append(float(np.float32(value)))
        self._op(OP_CONST, len(self.pool) - 1, int(valid), 0, pushes=1)

    def emit(self, node) -> str:
        """Emit ``node``; returns the kind of the value it pushes
        ("num", "bool" or "null")."""
        from ..s3select import compile as c
        if isinstance(node, c.CLit):
            if node.kind == "null":
                self._const(0.0, False)
            elif node.kind == "bool":
                self._const(1.0 if node.value else 0.0, True)
            elif node.kind == "num":
                self._const(float(node.value), True)
            else:
                raise ValueError(f"literal of kind {node.kind}")
            return node.kind
        if isinstance(node, c.CCol):
            if node.kind not in ("num", "bool", "null"):
                raise ValueError(f"column of kind {node.kind}")
            self._op(OP_COL, self.col_index[node.name], pushes=1)
            return node.kind
        if isinstance(node, c.CCmp):
            kinds = (self.emit(node.left), self.emit(node.right))
            if kinds == ("bool", "bool"):
                op = OP_CMP_BOOL
            elif kinds == ("num", "num"):
                op = OP_CMP_NUM
            else:   # bool vs non-bool, or a NULL-kind operand: False
                op = OP_CMP_FALSE
            self._op(op, CMP_CODES[node.op], pops=2, pushes=1)
            return "bool"
        if isinstance(node, c.CBetween):
            self.emit(node.lo_cmp)
            self.emit(node.hi_cmp)
            self._op(OP_BETWEEN, int(node.negate), pops=2, pushes=1)
            return "bool"
        if isinstance(node, c.CIn):
            self.emit(node.value)
            self._const(0.0, True)            # hit = False
            for cmp in node.cmps:
                self.emit(cmp)
                self._op(OP_IN_OR, pops=1)
            self._op(OP_IN_END, int(node.negate), pops=2, pushes=1)
            return "bool"
        if isinstance(node, c.CIsNull):
            self.emit(node.value)
            self._op(OP_ISNULL, int(node.negate), int(node.missing),
                     pops=1, pushes=1)
            return "bool"
        if isinstance(node, c.CBool):
            lk = self.emit(node.left)
            rk = self.emit(node.right)
            self._op(OP_AND if node.op == "and" else OP_OR,
                     int(lk == "null"), int(rk == "null"), pops=2,
                     pushes=1)
            return "bool"
        if isinstance(node, c.CNot):
            k = self.emit(node.inner)
            self._op(OP_NOT, int(k == "null"), pops=1, pushes=1)
            return "bool"
        raise ValueError(f"no program for {type(node).__name__}")


# -- binding ------------------------------------------------------------------


def plan_nbytes(plan, batch) -> int:
    """Referenced-column payload bytes of this dispatch."""
    total = 0
    for name in plan.cols:
        col = batch.col(name)
        if col is not None:
            total += col.data_nbytes()
    return total


def bind_plan(plan, batch):
    """(per-column (vals f32, valid, miss) or None for an absent column,
    base fallback mask) in ``plan.cols`` order, or None when a
    referenced column's dtype has no exact float32 image
    (int64/float64/strings): the rules of the reference's ``_bind_jit``.
    Bool columns bind as 0.0 / 1.0."""
    n = batch.nrows
    cols: list = []
    fb = np.zeros(n, dtype=bool)
    for name in plan.cols:
        col = batch.col(name)
        if col is None:
            cols.append(None)
            continue
        valid = ~col.null_mask()
        miss = col.miss_mask()
        if col.kind == "bool":
            cols.append((np.asarray(col.raw, dtype=bool).astype(np.float32),
                         valid, miss))
            continue
        if col.kind != "num":
            return None
        raw = np.asarray(col.raw)
        if raw.dtype.kind == "f":
            if raw.dtype.itemsize > 4:
                return None
            vals = raw.astype(np.float32, copy=False)
        elif raw.dtype.kind in "iu":
            if raw.dtype.itemsize > 4:
                return None
            big = np.abs(raw.astype(np.int64)) > _F32_INT_EXACT
            if big.any():
                fb |= big & valid
            vals = raw.astype(np.float32)
        else:
            return None
        cols.append((vals, valid, miss))
    return cols, fb


def place_columns(bound: list, n: int, device: torch.device) -> list:
    """Bound host columns as contiguous tensors on ``device``; an absent
    column becomes zeros with valid False and miss True there."""
    out = []
    for entry in bound:
        if entry is None:
            out.append((torch.zeros(n, dtype=torch.float32, device=device),
                        torch.zeros(n, dtype=torch.bool, device=device),
                        torch.ones(n, dtype=torch.bool, device=device)))
            continue
        out.append(tuple(_cuda.host_tensor(a).to(device) for a in entry))
    return out


# -- the kernel and its plain version -----------------------------------------


# The comparison of each CMP_CODES code.
_CMP_FNS = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)


def eval_program_plain(program: Program, cols: list, n: int,
                       device) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same program, one torch
    op per instruction over whole columns (constants as 0-d tensors that
    broadcast). cols: per column (vals f32, valid bool, miss bool), all
    on ``device``. Returns (val, valid) bool tensors of shape (n,) there."""
    dev = torch.device(device)
    true = torch.tensor(True, device=dev)
    false = torch.tensor(False, device=dev)
    pool = torch.from_numpy(program.pool).to(dev)
    stack: list[tuple] = []
    for op, a, b, c in program.ops.tolist():
        if op == OP_COL:
            stack.append(cols[a])
        elif op == OP_CONST:
            stack.append((pool[a], true if b else false,
                          true if c else false))
        elif op in (OP_CMP_NUM, OP_CMP_BOOL, OP_CMP_FALSE):
            r = stack.pop()
            l_ = stack.pop()
            valid = l_[1] & r[1]
            if op == OP_CMP_FALSE:
                val = false
            else:
                val = _CMP_FNS[a](l_[0], r[0])
                if op == OP_CMP_NUM:
                    val = val & valid
            stack.append((val.to(torch.float32), valid, false))
        elif op == OP_BETWEEN:
            hi = stack.pop()
            lo = stack.pop()
            val = (lo[0] != 0) & (hi[0] != 0)
            if a:
                val = ~val
            stack.append((val.to(torch.float32), lo[1] & hi[1], false))
        elif op == OP_IN_OR:
            cv = stack.pop()
            hit = stack.pop()
            stack.append((((hit[0] != 0) | ((cv[0] != 0) & cv[1])
                           ).to(torch.float32), hit[1], hit[2]))
        elif op == OP_IN_END:
            hit = stack.pop()
            value = stack.pop()
            val = hit[0] != 0
            if a:
                val = ~val
            stack.append((val.to(torch.float32), value[1], false))
        elif op == OP_ISNULL:
            vv = stack.pop()
            val = vv[2] if b else ~vv[1]
            if a:
                val = ~val
            stack.append((val.to(torch.float32), true, false))
        elif op in (OP_AND, OP_OR):
            r = stack.pop()
            l_ = stack.pop()
            ta, va = _bool_operand(l_, a, false)
            tb, vb = _bool_operand(r, b, false)
            both = va & vb
            if op == OP_AND:
                decided_false = (va & ~ta) | (vb & ~tb)
                val, valid = ta & tb, decided_false | both
            else:
                val = ta | tb
                valid = val | both
            stack.append((val.to(torch.float32), valid, false))
        elif op == OP_NOT:
            t, defined = _bool_operand(stack.pop(), a, false)
            stack.append(((~t & defined).to(torch.float32), defined,
                          false))
        else:
            raise ValueError(f"opcode {op}")
    val, valid, _ = stack.pop()
    return (torch.broadcast_to(val != 0, (n,)).contiguous(),
            torch.broadcast_to(valid, (n,)).contiguous())


def _bool_operand(vv: tuple, null_kind: int, false: torch.Tensor):
    """(truth, defined) of a BoolOp / Not operand (compile.py
    ``_bool_operand``): MISSING is truthy and defined; a value of kind
    null is never truthy."""
    val, valid, miss = vv
    truthy = false if null_kind else val != 0
    return (truthy & valid) | miss, valid | miss


def select_scan_cuda(program: Program, cols: list, n: int,
                     out_val: torch.Tensor, out_valid: torch.Tensor) -> None:
    """Launch csrc/select_scan.cu: ``program`` over ``cols`` (per column
    (vals f32, valid bool, miss bool), contiguous, length n, on the card)
    into the (n,) bool masks. Counts its launches."""
    dev = out_val.device
    if dev.type != "cuda" or out_valid.device != dev:
        raise ValueError("select_scan_cuda needs its outputs on one CUDA "
                         "device")
    if out_val.dtype != torch.bool or out_valid.dtype != torch.bool or \
            out_val.shape != (n,) or out_valid.shape != (n,):
        raise ValueError("select_scan_cuda needs (n,) bool outputs")
    if len(cols) != program.ncols or program.depth > MAX_STACK:
        raise ValueError("columns do not match the program")
    ptrs = []
    for col in cols:
        for t, dtype in zip(col, (torch.float32, torch.bool, torch.bool)):
            if t.device != dev or t.dtype != dtype or t.shape != (n,) or \
                    not t.is_contiguous():
                raise ValueError("select_scan_cuda needs contiguous (n,) "
                                 "f32 / bool / bool columns on the "
                                 "outputs' device")
            ptrs.append(t.data_ptr())
    ops_t, pool_t = program.placed(dev)
    ptr_t = torch.tensor(ptrs or [0], dtype=torch.int64).to(dev)
    lib = _cuda.build()
    rc = lib.select_scan_launch(
        ops_t.data_ptr(), ops_t.shape[0], pool_t.data_ptr(),
        ptr_t.data_ptr(), len(cols), n, out_val.data_ptr(),
        out_valid.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check(rc, "select_scan")
    select_scan_cuda.launches += 1


select_scan_cuda.launches = 0


def run_program(program: Program, cols: list, n: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(val, valid) row masks on ``device``: the kernel on a CUDA device,
    the plain version on the CPU."""
    if device.type == "cpu":
        return eval_program_plain(program, cols, n, device)
    out_val = torch.empty(n, dtype=torch.bool, device=device)
    out_valid = torch.empty(n, dtype=torch.bool, device=device)
    select_scan_cuda(program, cols, n, out_val, out_valid)
    return out_val, out_valid


# -- dispatch -------------------------------------------------------------------


def eval_predicate(plan, batch, device="cuda"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate a compiled predicate over one batch -> (pass mask,
    fallback mask); accounts the dispatch under kernel ``select_scan``
    with the lane that ran."""
    from ..qos import scheduler as qos_sched
    from ..s3select.compile import passing_mask
    dev = _cuda.resolve_device(device)
    n = batch.nrows
    nbytes = plan_nbytes(plan, batch)
    blocks = max(1, len(plan.cols))
    with qos_sched.GATE.dispatch(qos_sched.BACKGROUND):
        program = lower_program(plan)
        bound = bind_plan(plan, batch) if program is not None else None
        if bound is not None:
            host_cols, base_fb = bound
            with timed() as t:
                cols = place_columns(host_cols, n, dev)
                val, valid = run_program(program, cols, n, dev)
                ok = (val & valid).cpu().numpy() & ~base_fb
            KERNEL.record(SELECT_SCAN, dev.type == "cuda", nbytes, t.s,
                          blocks=blocks)
            return ok, base_fb
        with timed() as t:
            vv = plan.eval_host(batch)
            ok, fb = passing_mask(vv, n)
        KERNEL.record(SELECT_SCAN, False, nbytes, t.s, blocks=blocks)
        return ok, fb
