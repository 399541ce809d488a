"""Batched predicate scan for columnar S3 Select: kernel X2 on the card.

Port of minio_tpu/ops/select_kernels.py. The scan engine
(s3select/engine.py) hands a compiled predicate plan plus one
ColumnBatch here per dispatch; the answer is the (pass, fallback) row
masks: the reference's ``_bind_jit`` + ``_run_jit`` + ``val & valid &
~fb`` on its jit lane.

- **The kernel.** The reference traces the compile.py node tree under
  ``jax.jit`` once per plan (``_build_jit``). Compiling CUDA per query
  would cost seconds of nvcc on the serving path, so the port lowers
  the tree ONCE per plan into a short postfix program (int32
  instructions, a constant pool and a list of IN options,
  ``lower_program``) that one hand-written kernel runs
  (csrc/select_scan.cu). Every comparison of two leaves (a column or a
  literal) is one fused instruction, so what stays on the stack is two
  bits a row: truth and valid.
- **The bind is on the card.** ``bind_columns`` hands the kernel each
  referenced column's raw value buffer with a dtype code, and its NULL
  and MISSING masks only where the column has them; the kernel derives
  valid, the float32 image and the fallback rows (int cells past 2^24)
  itself. ``eval_program_plain`` is the plain PyTorch version of that
  whole function over the same inputs: the CPU lane, and the yardstick
  the kernel is held to on the card.
- **Eligibility** is the reference's: only float32-exact plans
  (compile.Plan.jit_ok) whose program fits the kernel's stack
  (``MAX_STACK``), over float32 / int32 / uint32 / bool columns (and
  narrower numbers, widened exactly on the host); int64, float64 and
  string columns bind to None, as in the reference's ``_bind_jit``, and
  the plan runs on the host numpy lane (``plan.eval_host``), which is the
  reference's own semantics for it.
- **The lane**: a pinned ``device="cuda"`` launches the kernel (a CUDA
  error raises), ``device="cpu"`` runs the plain version.
  ``device="auto"`` rides the measured autotuner model (ops/autotune.py,
  kernel ``select_scan``) like RS math does: ``choose_lane`` picks the
  fastest healthy lane per batch-size bucket -- the kernel on the
  dispatch device (``device``, or ``torch-cpu`` when that is the CPU) or
  the numpy host lane (there is no C++ select kernel, so a NATIVE plan
  resolves to HOST) -- and a failed kernel dispatch feeds kernprof and
  re-runs the batch on the host lane. ``probe_lane`` is the ladder's
  known-answer probe.
- **QoS**: every dispatch enters the priority gate on the BACKGROUND
  lane, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.kernel_stats import KERNEL, SELECT_SCAN, timed
from . import _cuda

# int cells past float32's exact-integer range (2^24) cannot ride the
# float32 program exactly; they take the row fallback instead.
_F32_INT_EXACT = 1 << 24

# Opcodes of a predicate program; csrc/select_scan.cu mirrors them. An
# instruction is four int32 (op, a, b, c): the opcode in the low byte of
# op, the F_* flags above it. A leaf operand is a column (its index in
# plan.cols) or, as ~k, constant k of the pool. Each stack entry is two
# bits a row: truth and valid, truth only where valid.
OP_CMP = 0            # a, b: leaves        push a <cmp> b
OP_BETWEEN = 1        # a: value, b: lo, c: hi leaves
OP_IN = 2             # a: value leaf; args[b:b + c]: the option leaves
OP_PUSH = 3           # a: leaf             push it as F_MODE says
OP_CMP_STACK = 4      #                     pop r, l: push l <cmp> r
OP_BETWEEN_STACK = 5  #                     pop hi, lo comparisons
OP_IN_END = 6         #                     pop hit, value
OP_ISNULL_STACK = 7   #                     pop a computed value
OP_AND = 8            #                     pop r, l: SQL AND
OP_OR = 9             #                     pop r, l: SQL OR
OP_NOT = 10           #                     pop v: SQL NOT
OP_TOUCH = 11         # a: a column no other instruction reads, read
#                       for its fallback rows only
N_OPS = 12

F_CMP_SHIFT = 8             # 3 bits: the comparison's CMP_CODES code
F_NEG = 1 << 11             # NOT BETWEEN / NOT IN / IS NOT ...
F_COMPARES = 1 << 12        # the operands' kinds compare (else False)
F_COMPARES_HI = 1 << 13     # ... for BETWEEN's upper bound
F_MODE_SHIFT = 14           # OP_PUSH: 2 bits, one of the MODE_*
F_MISSING = 1 << 14         # OP_ISNULL_STACK: IS MISSING (else IS NULL)
F_NULL_KIND = 1 << 16       # OP_PUSH: a NULL-kind leaf, never truthy

# How OP_PUSH pushes a leaf: as a value (truth = v != 0), as an operand
# of AND / OR / NOT (MISSING is truthy and defined: compile.py
# ``_bool_operand``), or its IS NULL / IS MISSING.
MODE_VALUE, MODE_OPERAND, MODE_ISNULL, MODE_ISMISSING = range(4)

# Comparison codes.
CMP_CODES = {"=": 0, "!=": 1, "<>": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

# Column dtype codes (csrc/select_scan.cu Dtype). A uint32 column rides
# as its int32 bit image; an absent column has no buffers at all.
DT_F32, DT_I32, DT_U32, DT_BOOL, DT_ABSENT = range(5)

# The kernel's stack depth. A plan whose program needs a deeper stack
# runs on the host lane.
MAX_STACK = 64


class Program:
    """A lowered predicate: (m, 4) int32 instructions, a (p, 2) float32
    constant pool (value, valid), the int32 leaves of IN options, and the
    stack depth they need. Device copies are made once per device."""

    __slots__ = ("ops", "pool", "args", "depth", "ncols", "_placed")

    def __init__(self, ops: np.ndarray, pool: np.ndarray, args: np.ndarray,
                 depth: int, ncols: int):
        self.ops = ops
        self.pool = pool
        self.args = args
        self.depth = depth
        self.ncols = ncols
        self._placed: dict = {}

    def opcodes(self) -> set:
        return set((self.ops[:, 0] & 0xFF).tolist())

    def placed(self, device: torch.device):
        got = self._placed.get(device)
        if got is None:
            got = tuple(torch.from_numpy(a).to(device)
                        for a in (self.ops, self.pool, self.args))
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


# Leaf operands an instruction reads: its a (and b, c).
_LEAVES = {OP_CMP: 2, OP_BETWEEN: 3, OP_IN: 1, OP_PUSH: 1}


def _compares(lk: str, rk: str) -> bool:
    """Does a comparison of operands of these kinds compare values
    (compile.py CCmp: num with num, bool with bool)? Any other pair is
    False, with the operands' valid."""
    return (lk, rk) in (("num", "num"), ("bool", "bool"))


class _Lowering:
    """Walks the compile.py node tree in evaluation order, reproducing
    each node's three-valued rules (compile.py CCmp / CBetween / CIn /
    CIsNull / CBool / CNot). Under ``Plan.jit_ok`` a number only ever
    appears as a leaf, so every comparison of leaves fuses into one
    instruction and every computed value is a bool."""

    def __init__(self, plan):
        from ..s3select import compile as c
        self.c = c
        self.plan = plan
        self.col_index = {name: i for i, name in enumerate(plan.cols)}
        self.ops: list[tuple[int, int, int, int]] = []
        self.pool: dict[tuple[float, float], int] = {}
        self.args: list[int] = []
        self.sp = 0
        self.depth = 0

    def program(self) -> Program:
        self.emit(self.plan.root)
        if self.sp != 1:
            raise ValueError("predicate program does not leave one row "
                             "mask on the stack")
        # The kernel finds an int column's fallback rows where it reads
        # the column; a column no instruction reads (only an IN option
        # that can never hit) is read once for them alone.
        read = set(self.args)
        for op, a, b, c in self.ops:
            read.update((a, b, c)[:_LEAVES.get(op & 0xFF, 0)])
        for col in range(len(self.plan.cols)):
            if col not in read:
                self._op(OP_TOUCH, col, pushes=0)
        pool = np.asarray(list(self.pool) or [(0.0, 0.0)],
                          dtype=np.float32).reshape(-1, 2)
        return Program(np.asarray(self.ops, dtype=np.int32).reshape(-1, 4),
                       pool, np.asarray(self.args or [0], dtype=np.int32),
                       self.depth, len(self.plan.cols))

    def _op(self, op: int, a: int = 0, b: int = 0, c: int = 0,
            pops: int = 0, pushes: int = 1) -> None:
        self.ops.append((op, a, b, c))
        self.sp += pushes - pops
        self.depth = max(self.depth, self.sp)

    def _kind(self, node) -> str:
        """A leaf's kind; any other node of an eligible plan is a bool."""
        c = self.c
        if isinstance(node, (c.CCol, c.CLit)):
            if node.kind not in ("num", "bool", "null"):
                raise ValueError(f"leaf of kind {node.kind}")
            return node.kind
        return "bool"

    def _is_leaf(self, node) -> bool:
        return isinstance(node, (self.c.CCol, self.c.CLit))

    def _leaf(self, node) -> int:
        """The leaf operand of a column or literal."""
        self._kind(node)
        if isinstance(node, self.c.CCol):
            return self.col_index[node.name]
        if node.kind == "null":
            entry = (0.0, 0.0)
        elif node.kind == "bool":
            entry = (1.0 if node.value else 0.0, 1.0)
        else:
            entry = (float(np.float32(node.value)), 1.0)
        return ~self.pool.setdefault(entry, len(self.pool))

    def operand(self, node, mode: int) -> None:
        """Push ``node``: a leaf as ``mode`` says, a computed bool as it
        is (its truth is already masked by valid and it is never
        MISSING, so it serves every mode)."""
        if not self._is_leaf(node):
            self.emit(node)
            return
        flags = mode << F_MODE_SHIFT
        if self._kind(node) == "null":
            flags |= F_NULL_KIND
        self._op(OP_PUSH | flags, self._leaf(node))

    def emit(self, node) -> None:
        """Emit a computed node: it pushes one (truth, valid) entry."""
        c = self.c
        if isinstance(node, c.CCmp):
            flags = CMP_CODES[node.op] << F_CMP_SHIFT
            if _compares(self._kind(node.left), self._kind(node.right)):
                flags |= F_COMPARES
            if self._is_leaf(node.left) and self._is_leaf(node.right):
                self._op(OP_CMP | flags, self._leaf(node.left),
                         self._leaf(node.right))
            else:
                self.operand(node.left, MODE_VALUE)
                self.operand(node.right, MODE_VALUE)
                self._op(OP_CMP_STACK | flags, pops=2)
            return
        neg = F_NEG if getattr(node, "negate", False) else 0
        if isinstance(node, c.CBetween):
            value, lo, hi = (node.lo_cmp.left, node.lo_cmp.right,
                             node.hi_cmp.right)
            if all(self._is_leaf(x) for x in (value, lo, hi)):
                vk = self._kind(value)
                flags = neg
                if _compares(vk, self._kind(lo)):
                    flags |= F_COMPARES
                if _compares(vk, self._kind(hi)):
                    flags |= F_COMPARES_HI
                self._op(OP_BETWEEN | flags, self._leaf(value),
                         self._leaf(lo), self._leaf(hi))
            else:
                self.emit(node.lo_cmp)
                self.emit(node.hi_cmp)
                self._op(OP_BETWEEN_STACK | neg, pops=2)
            return
        if isinstance(node, c.CIn):
            options = [cmp.right for cmp in node.cmps]
            if self._is_leaf(node.value) and \
                    all(self._is_leaf(o) for o in options):
                # Options whose kind never compares with the value's
                # (NULL, a bool against a number) can never hit.
                vk = self._kind(node.value)
                start = len(self.args)
                self.args.extend(self._leaf(o) for o in options
                                 if _compares(vk, self._kind(o)))
                self._op(OP_IN | neg, self._leaf(node.value), start,
                         len(self.args) - start)
                return
            self.operand(node.value, MODE_VALUE)
            if not node.cmps:
                self._op(OP_PUSH | MODE_VALUE << F_MODE_SHIFT,
                         self._leaf(c.CLit(False)))
            for i, cmp in enumerate(node.cmps):
                self.emit(cmp)
                if i:                     # hit |= this comparison
                    self._op(OP_OR, pops=2)
            self._op(OP_IN_END | neg, pops=2)
            return
        if isinstance(node, c.CIsNull):
            if self._is_leaf(node.value):
                mode = MODE_ISMISSING if node.missing else MODE_ISNULL
                self._op(OP_PUSH | neg | mode << F_MODE_SHIFT,
                         self._leaf(node.value))
            else:
                self.emit(node.value)
                self._op(OP_ISNULL_STACK | neg
                         | (F_MISSING if node.missing else 0), pops=1)
            return
        if isinstance(node, c.CBool):
            self.operand(node.left, MODE_OPERAND)
            self.operand(node.right, MODE_OPERAND)
            self._op(OP_AND if node.op == "and" else OP_OR, pops=2)
            return
        if isinstance(node, c.CNot):
            self.operand(node.inner, MODE_OPERAND)
            self._op(OP_NOT, pops=1)
            return
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


def _mask(m):
    return None if m is None else np.asarray(m, dtype=bool)


def bind_columns(plan, batch):
    """Per referenced column, in ``plan.cols`` order, what the kernel
    reads: (values, dtype code, null, miss) as host arrays, the values in
    their own 4-byte dtype (bool as bytes) and each mask only where the
    column has one; an absent column is (None, DT_ABSENT, None, None).
    None when a referenced column has no exact float32 image
    (int64/float64/strings): the refusals of the reference's
    ``_bind_jit``. No pass over the rows, except to widen a 1- or 2-byte
    number exactly (to int32, or float16 to float32)."""
    out = []
    for name in plan.cols:
        col = batch.col(name)
        if col is None:
            out.append((None, DT_ABSENT, None, None))
            continue
        if col.kind == "bool":
            vals, code = np.asarray(col.raw, dtype=bool), DT_BOOL
        elif col.kind == "num":
            vals = np.asarray(col.raw)
            kind, size = vals.dtype.kind, vals.dtype.itemsize
            if kind not in "fiu" or size > 4:
                return None
            if kind == "f":
                vals, code = vals.astype(np.float32, copy=False), DT_F32
            elif size < 4:
                vals, code = vals.astype(np.int32), DT_I32
            elif kind == "i":
                vals, code = vals.astype(np.int32, copy=False), DT_I32
            else:
                vals = vals.astype(np.uint32, copy=False).view(np.int32)
                code = DT_U32
        else:
            return None
        out.append((vals, code, _mask(col.null), _mask(col.miss)))
    return out


def place_columns(bound: list, device: torch.device) -> list:
    """Bound host columns as tensors on ``device``: one copy of each
    array that is there (none on the CPU)."""
    def put(a):
        return None if a is None else _cuda.host_tensor(a).to(device)
    return [(put(v), code, put(null), put(miss))
            for v, code, null, miss in bound]


# -- the kernel and its plain version -----------------------------------------


# The comparison of each CMP_CODES code, on values and on truth bits.
_CMP_FNS = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)
_CMP_BITS = (lambda a, b: ~(a ^ b), lambda a, b: a ^ b,
             lambda a, b: ~a & b, lambda a, b: ~a | b,
             lambda a, b: a & ~b, lambda a, b: a | ~b)


def _plain_bind(cols: list, n: int, dev: torch.device):
    """The bind the kernel does: per column (float32 image, valid, miss),
    and the fallback rows (|v| > 2^24 where valid, int columns only)."""
    false = torch.tensor(False, device=dev)
    true = torch.tensor(True, device=dev)
    fb = torch.zeros(n, dtype=torch.bool, device=dev)
    leaves = []
    for vals, code, null, miss in cols:
        if code == DT_ABSENT:
            leaves.append((torch.tensor(0.0, device=dev), false, true))
            continue
        mi = false if miss is None else miss
        valid = ~((false if null is None else null) | mi)
        if code == DT_F32:
            image = vals
        elif code == DT_BOOL:
            image = vals.to(torch.float32)
        else:
            wide = vals.to(torch.int64)
            if code == DT_U32:
                wide = wide & 0xFFFFFFFF
            fb |= (wide.abs() > _F32_INT_EXACT) & valid
            image = wide.to(torch.float32)
        leaves.append((image, valid, mi))
    return leaves, fb


def eval_program_plain(program: Program, cols: list, n: int,
                       device) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same bind and program,
    one torch op at a time over whole columns (constants as 0-d tensors
    that broadcast). cols: ``place_columns`` output on ``device``.
    Returns the (pass, fallback) bool masks of shape (n,) there."""
    dev = torch.device(device)
    false = torch.tensor(False, device=dev)
    true = torch.tensor(True, device=dev)
    leaves, fb = _plain_bind(cols, n, dev)

    def leaf(ref: int):
        if ref >= 0:
            return leaves[ref]
        value, valid = program.pool[~ref].tolist()
        return (torch.tensor(value, dtype=torch.float32, device=dev),
                true if valid else false, false)

    stack: list[tuple] = []
    for word, a, b, c in program.ops.tolist():
        op = word & 0xFF
        code = (word >> F_CMP_SHIFT) & 7

        def neg(t):
            return ~t if word & F_NEG else t

        if op == OP_CMP:
            x, y = leaf(a), leaf(b)
            v = x[1] & y[1]
            t = _CMP_FNS[code](x[0], y[0]) & v if word & F_COMPARES \
                else false
            stack.append((t, v))
        elif op == OP_BETWEEN:
            x, lo, hi = leaf(a), leaf(b), leaf(c)
            vlo, vhi = x[1] & lo[1], x[1] & hi[1]
            tlo = (x[0] >= lo[0]) & vlo if word & F_COMPARES else false
            thi = (x[0] <= hi[0]) & vhi if word & F_COMPARES_HI else false
            v = vlo & vhi
            stack.append((neg(tlo & thi) & v, v))
        elif op == OP_IN:
            x = leaf(a)
            hit = false
            for ref in program.args[b:b + c].tolist():
                o = leaf(ref)
                hit = hit | ((x[0] == o[0]) & o[1])
            stack.append((neg(hit) & x[1], x[1]))
        elif op == OP_PUSH:
            x = leaf(a)
            mode = (word >> F_MODE_SHIFT) & 3
            if mode == MODE_ISNULL:
                stack.append((neg(~x[1]), true))
            elif mode == MODE_ISMISSING:
                stack.append((neg(x[2]), true))
            else:
                t = false if word & F_NULL_KIND else x[0] != 0
                t = t & x[1]
                if mode == MODE_VALUE:
                    stack.append((t, x[1]))
                else:
                    stack.append((t | x[2], x[1] | x[2]))
        elif op == OP_CMP_STACK:
            y, x = stack.pop(), stack.pop()
            v = x[1] & y[1]
            t = _CMP_BITS[code](x[0], y[0]) & v if word & F_COMPARES \
                else false
            stack.append((t, v))
        elif op == OP_BETWEEN_STACK:
            hi, lo = stack.pop(), stack.pop()
            v = lo[1] & hi[1]
            stack.append((neg(lo[0] & hi[0]) & v, v))
        elif op == OP_IN_END:
            hit, x = stack.pop(), stack.pop()
            stack.append((neg(hit[0]) & x[1], x[1]))
        elif op == OP_ISNULL_STACK:
            x = stack.pop()      # a computed value is never MISSING
            stack.append((neg(false if word & F_MISSING else ~x[1]), true))
        elif op in (OP_AND, OP_OR):
            y, x = stack.pop(), stack.pop()
            if op == OP_AND:
                t = x[0] & y[0]
                v = (x[1] & ~x[0]) | (y[1] & ~y[0]) | (x[1] & y[1])
            else:
                t = x[0] | y[0]
                v = t | (x[1] & y[1])
            stack.append((t, v))
        elif op == OP_NOT:
            x = stack.pop()
            stack.append((~x[0] & x[1], x[1]))
        elif op != OP_TOUCH:     # the fallback rows of every column are in
            raise ValueError(f"opcode {op}")     # fb already
    truth, _ = stack.pop()
    return torch.broadcast_to(truth & ~fb, (n,)).contiguous(), fb


_DTYPES = {DT_F32: torch.float32, DT_I32: torch.int32, DT_U32: torch.int32,
           DT_BOOL: torch.bool}


def select_scan_cuda(program: Program, cols: list, n: int,
                     out_pass: torch.Tensor, out_fb: torch.Tensor,
                     any_fb: torch.Tensor) -> None:
    """Launch csrc/select_scan.cu: ``program`` over ``cols``
    (``place_columns`` output on the card) into the (n,) bool masks;
    ``any_fb`` (one int32) becomes nonzero when a fallback row is set.
    Counts its launches."""
    launch_select_scan(select_scan_args(program, cols, n, out_pass, out_fb,
                                        any_fb))


def launch_select_scan(prepared: tuple) -> None:
    """Launch the kernel with ``select_scan_args`` output; counts the
    launch."""
    args, _ = prepared
    _cuda.check(_cuda.build().select_scan_launch(*args), "select_scan")
    select_scan_cuda.launches += 1


def select_scan_args(program: Program, cols: list, n: int,
                     out_pass: torch.Tensor, out_fb: torch.Tensor,
                     any_fb: torch.Tensor) -> tuple:
    """(the launcher's arguments, the tensor of column descriptors they
    point into) for ``select_scan_cuda``, checked; the descriptors are
    copied to the card here."""
    dev = out_pass.device
    if dev.type != "cuda" or out_fb.device != dev or any_fb.device != dev:
        raise ValueError("select_scan_cuda needs its outputs on one CUDA "
                         "device")
    for out in (out_pass, out_fb):
        if out.dtype != torch.bool or out.shape != (n,) or \
                not out.is_contiguous():
            raise ValueError("select_scan_cuda needs contiguous (n,) bool "
                             "outputs")
    if any_fb.dtype != torch.int32 or any_fb.numel() != 1:
        raise ValueError("select_scan_cuda needs one int32 for any_fb")
    if len(cols) != program.ncols or program.depth > MAX_STACK:
        raise ValueError("columns do not match the program")
    desc = []
    for vals, code, null, miss in cols:
        if code == DT_ABSENT:
            if vals is not None or null is not None or miss is not None:
                raise ValueError("an absent column has no buffers")
            desc += [0, 0, 0, code]
            continue
        want = _DTYPES.get(code)
        if want is None or vals is None or vals.dtype != want:
            raise ValueError(f"column dtype code {code} does not match its "
                             f"values")
        ptrs = []
        for t in (vals, null, miss):
            if t is None:
                ptrs.append(0)
                continue
            if t.device != dev or t.shape != (n,) or not t.is_contiguous() \
                    or t.data_ptr() % t.element_size() or \
                    (t is not vals and t.dtype != torch.bool):
                raise ValueError("select_scan_cuda needs aligned contiguous "
                                 "(n,) columns (bool masks) on the outputs' "
                                 "device")
            ptrs.append(t.data_ptr())
        desc += [*ptrs, code]
    ops_t, pool_t, args_t = program.placed(dev)
    desc_t = torch.tensor(desc or [0, 0, 0, DT_ABSENT],
                          dtype=torch.int64).to(dev)
    return (ops_t.data_ptr(), ops_t.shape[0], pool_t.data_ptr(),
            args_t.data_ptr(), desc_t.data_ptr(), len(cols), n,
            program.depth, out_pass.data_ptr(), out_fb.data_ptr(),
            any_fb.data_ptr(), _cuda.stream_handle(dev)), desc_t


select_scan_cuda.launches = 0

# Bytes ahead of the pass mask in run_program's device buffer: the
# any_fb word, padded so that both masks start 16-byte aligned.
_HEAD = 16


def run_program(program: Program, cols: list, n: int,
                device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """(pass, fallback) row masks as host arrays: on a CUDA device the
    kernel, whose fallback mask is copied back only when it flagged a
    row; on the CPU the plain version."""
    if device.type == "cpu":
        ok, fb = eval_program_plain(program, cols, n, device)
        return ok.numpy(), fb.numpy()
    fb_at = _HEAD + -(-n // 16) * 16
    buf = torch.empty(fb_at + n, dtype=torch.uint8, device=device)
    select_scan_cuda(program, cols, n,
                     buf[_HEAD:_HEAD + n].view(torch.bool),
                     buf[fb_at:].view(torch.bool), buf[:4].view(torch.int32))
    head = buf[:_HEAD + n].cpu().numpy()
    ok = head[_HEAD:].view(bool)
    if head[:4].view(np.int32)[0]:
        return ok, buf[fb_at:].cpu().numpy().view(bool)
    return ok, np.zeros(n, dtype=bool)


# -- dispatch -------------------------------------------------------------------

AUTO = "auto"


def resolve_scan_device(device):
    """``"auto"`` (after checking that the dispatch device resolves: it
    raises without a card when it is the card) or a resolved pinned
    torch.device."""
    if isinstance(device, str) and device == AUTO:
        from .batching import dispatch_device
        dispatch_device()
        return AUTO
    return _cuda.resolve_device(device)


def choose_lane(plan, nbytes: int) -> str:
    """The measured plan's lane for this dispatch; NATIVE resolves to
    HOST (no C++ select kernel), and the kernel lanes need a plan the
    kernel can run (``lower_program``)."""
    from ..obs.kernprof import DEVICE, HOST, NATIVE, TORCH_CPU
    from .autotune import AUTOTUNE
    lane = AUTOTUNE.decide(SELECT_SCAN, nbytes)
    if lane == NATIVE:
        lane = HOST
    if lane in (DEVICE, TORCH_CPU) and lower_program(plan) is None:
        lane = HOST
    return lane


def eval_predicate(plan, batch, device="cuda"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate a compiled predicate over one batch -> (pass mask,
    fallback mask); accounts the dispatch under kernel ``select_scan``
    with the lane that ran."""
    from ..obs.kernprof import DEVICE, HOST, TORCH_CPU
    from ..qos import scheduler as qos_sched
    from ..s3select.compile import passing_mask
    from . import batching
    device = resolve_scan_device(device)
    auto = device == AUTO
    n = batch.nrows
    nbytes = plan_nbytes(plan, batch)
    blocks = max(1, len(plan.cols))
    with qos_sched.GATE.dispatch(qos_sched.BACKGROUND):
        if auto:
            kernel_lane = choose_lane(plan, nbytes) in (DEVICE, TORCH_CPU)
            dev = batching.dispatch_device() if kernel_lane else None
        else:
            kernel_lane, dev = True, device
        program = lower_program(plan) if kernel_lane else None
        bound = bind_columns(plan, batch) if program is not None else None
        if bound is not None:
            try:
                with timed() as t:
                    ok, fb = run_program(program, place_columns(bound, dev),
                                         n, dev)
                KERNEL.record(SELECT_SCAN, dev.type == "cuda", nbytes, t.s,
                              blocks=blocks,
                              backend=batching.attempt_backend(dev))
                return ok, fb
            except Exception as exc:  # noqa: BLE001 - CPU lane failover
                if not (auto and batching.device_dispatch_failed(exc, dev)):
                    raise
        with timed() as t:
            vv = plan.eval_host(batch)
            ok, fb = passing_mask(vv, n)
        KERNEL.record(SELECT_SCAN, False, nbytes, t.s, blocks=blocks,
                      backend=HOST)
        return ok, fb


# -- autotune probe -------------------------------------------------------------


def probe_lane(lane: str, nrows: int) -> tuple[float | None, str]:
    """One sized known-answer probe of a select lane: (bytes/s, "") or
    (None, cause).  A REAL dispatch -- it routes through the
    fault-injection `kernel` hook like the RS probes, so an active fault
    plan keeps the lane unmeasured; a kernel build failure raises."""
    import time as _time

    from ..faultinject import FAULTS
    from ..obs.kernprof import DEVICE, TORCH_CPU
    from ..s3select import sql
    from ..s3select.columnar import Column, ColumnBatch
    from ..s3select.compile import Plan, lower, passing_mask
    from . import batching

    rng = np.random.default_rng(nrows)
    a = rng.integers(0, 97, nrows).astype(np.float32)
    b = rng.integers(0, 97, nrows).astype(np.float32)
    cols = {"a": Column("a", "num", raw=a),
            "b": Column("b", "num", raw=b)}
    batch = ColumnBatch(["a", "b"], cols, nrows, int(a.nbytes * 2))
    where = sql.BoolOp("and", sql.Cmp("<", sql.Col(("a",)),
                                      sql.Lit(48)),
                       sql.Cmp(">=", sql.Col(("b",)), sql.Lit(16)))
    plan = Plan(lower(where, batch))
    want = (a < 48) & (b >= 16)
    try:
        FAULTS.kernel(SELECT_SCAN)
        if lane in (DEVICE, TORCH_CPU):
            program = lower_program(plan)
            bound = bind_columns(plan, batch) if program is not None \
                else None
            if bound is None:
                return None, "kernel bind declined"
            dev = batching.dispatch_device()
            placed = place_columns(bound, dev)

            def run():
                return run_program(program, placed, nrows, dev)[0]
        else:
            def run():
                return passing_mask(plan.eval_host(batch), nrows)[0]
        got = run()   # warm: kernel build
        t0 = _time.perf_counter()
        got = run()
        wall = _time.perf_counter() - t0
        if not (np.asarray(got) == want).all():
            return None, "known-answer mismatch"
        return batch.nbytes / max(wall, 1e-9), ""
    except _cuda.BuildFailed:
        raise
    except Exception as exc:  # noqa: BLE001 - a probe must not raise
        return None, f"{type(exc).__name__}: {exc}"
