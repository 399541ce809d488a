"""Product-matrix regenerating-code kernels (the REGEN storage class).

Port of minio_tpu/ops/rs_regen.py.

Construction: repair-by-transfer product-matrix MBR (PM-MBR, Rashmi/
Shah/Kumar product-matrix framework; "Fast Product-Matrix Regenerating
Codes" is the batched-evaluation treatment this module follows).  For a
k+m layout the code uses n = k+m nodes, repair degree d = n-1, per-node
sub-symbol count alpha = d and message size B = k*d - k*(k-1)/2 stripe
symbols per block.

The message matrix is the classic symmetric PM-MBR form

    M = [[S, T], [T^t, 0]]   (d x d)

with S a k x k symmetric matrix holding k(k+1)/2 message symbols and T
a k x (d-k) matrix holding the rest.  With Psi the n x d Vandermonde
encoding matrix, the full product P = Psi @ M @ Psi^t is symmetric and
node i stores the off-diagonal row sigma_i = (P[i, j] : j != i) — an
invertible remap of the conventional PM-MBR share psi_i^t M (any d rows
of Psi are independent, so the remap matrix Psi_{-i}^t is invertible).

That remap is what buys repair-by-transfer: to repair node f, helper i
reads and ships exactly ONE stored stripe symbol, P[i, f] = P[f, i],
and the d helper responses ARE sigma_f verbatim — no helper-side matrix
math, no rebuilder-side inversion, and per repaired block both disk and
network traffic are d/B of the block instead of the ~1 block plain RS
pays (4+2: 5/14 ≈ 0.36x, a ~2.8x reduction).  The price is MBR storage
overhead: n*alpha/B raw bytes per byte stored (4+2: 30/14 ≈ 2.14x vs
RS 1.5x) — the REGEN-vs-RS tradeoff documented in docs/robustness.md.

Everything here is plain GF(2^8) linear algebra so the batched apply
rides the existing lanes: kernel K1 (rs_gpu.gf_apply, csrc/gf_apply.cu)
on the card, its plain PyTorch version on the ``torch-cpu`` lane, and
the native/numpy table-gather (batching.host_apply_tagged) on the host
lanes, recorded under the ``regen_code`` kernel and planned by the
ops/autotune probe ladder.  The bit-plane matrices are placed once per
device (``placed_encode_bitplane`` / ``placed_decode_bitplane``).

Layout contract (consumed by erasure/regen, heal and repair_project):
a block of L bytes packs into W with shape (B, nst), nst =
ceil(L / B), column-major stripes (pad -> reshape(nst, B) -> T), and
node i's chunk is its (d, nst) symbol rows flattened row-major — so
stored row r of a block lives contiguous at byte offset r*nst inside
the chunk, which is what makes the minimum-bandwidth repair read a
plain ranged read.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .gf256 import (MUL_TABLE, gf_inv, gf_mat_invert, gf_mat_vec_apply,
                    gf_matmul, gf_matrix_to_bitplane)
from .rs_matrix import vandermonde

# Kernel name for autotune plans / kernprof / metrics2 series.  One name
# covers encode and decode: both are a single GF matmul of the same
# shape family, so one measured lane model fits both.
REGEN_CODE = "regen_code"


@dataclass(frozen=True)
class RegenGeometry:
    """Derived PM-MBR parameters for a k+m layout."""

    k: int
    m: int
    n: int      # total nodes = k + m
    d: int      # repair degree = n - 1 (every survivor helps)
    alpha: int  # stripe symbols stored per node per block = d
    B: int      # message stripe symbols per block = k*d - k*(k-1)/2


@functools.lru_cache(maxsize=64)
def geometry(k: int, m: int) -> RegenGeometry:
    if k <= 0 or m <= 0:
        raise ValueError("regen geometry needs k > 0 and m > 0")
    n = k + m
    if n > 255:
        raise ValueError("too many shards for GF(2^8) evaluation points")
    d = n - 1
    return RegenGeometry(k=k, m=m, n=n, d=d, alpha=d,
                         B=k * d - k * (k - 1) // 2)


@functools.lru_cache(maxsize=64)
def basis_positions(k: int, m: int) -> tuple[tuple[int, int], ...]:
    """Message-symbol slots inside the d x d matrix M, in stripe order:
    S's upper triangle first (row-major, i <= j < k), then T row-major
    (i < k, k <= j < d).  Symmetric mirror positions are implied."""
    g = geometry(k, m)
    pos = [(i, j) for i in range(g.k) for j in range(i, g.k)]
    pos += [(i, j) for i in range(g.k) for j in range(g.k, g.d)]
    return tuple(pos)


def message_matrix(k: int, m: int, w: np.ndarray) -> np.ndarray:
    """Stripe vector w (B,) -> symmetric message matrix M (d, d)."""
    g = geometry(k, m)
    M = np.zeros((g.d, g.d), dtype=np.uint8)
    for t, (i, j) in enumerate(basis_positions(k, m)):
        M[i, j] = w[t]
        M[j, i] = w[t]
    return M


@functools.lru_cache(maxsize=64)
def node_generators(k: int, m: int) -> np.ndarray:
    """(n, d, B) generator tensor: node i's stored row r is
    G[i, r] @ w for message stripe w.

    Built by pushing each basis stripe e_t through the bilinear form
    P_t = Psi @ M_t @ Psi^t and reading off the off-diagonal row of
    each node (B is small — 14 for 4+2, 184 for 16+4 — so the B
    passes of tiny gf_matmuls are negligible and cached per (k, m))."""
    g = geometry(k, m)
    psi = vandermonde(g.n, g.d)
    G = np.zeros((g.n, g.d, g.B), dtype=np.uint8)
    others = [[j for j in range(g.n) if j != i] for i in range(g.n)]
    w = np.zeros(g.B, dtype=np.uint8)
    for t in range(g.B):
        w[:] = 0
        w[t] = 1
        P = gf_matmul(gf_matmul(psi, message_matrix(k, m, w)), psi.T)
        for i in range(g.n):
            G[i, :, t] = P[i, others[i]]
    return G


@functools.lru_cache(maxsize=64)
def encode_matrix_regen(k: int, m: int) -> np.ndarray:
    """(n*d, B) flattened encode matrix: all nodes' stored rows from one
    GF matmul against the (B, S) stripe columns."""
    g = geometry(k, m)
    return np.ascontiguousarray(
        node_generators(k, m).reshape(g.n * g.d, g.B))


@functools.lru_cache(maxsize=64)
def encode_bitplane(k: int, m: int) -> np.ndarray:
    return gf_matrix_to_bitplane(encode_matrix_regen(k, m))


def _independent_rows(rows: np.ndarray, want: int) -> list[int]:
    """Greedy GF(2^8) row selection: indices of the first `want`
    linearly independent rows (Gaussian elimination over the field)."""
    basis: list[tuple[int, np.ndarray]] = []
    chosen: list[int] = []
    for ri in range(rows.shape[0]):
        r = rows[ri].copy()
        for p, br in basis:
            c = int(r[p])
            if c:
                r ^= MUL_TABLE[c, br]
        nz = np.nonzero(r)[0]
        if nz.size == 0:
            continue
        p = int(nz[0])
        r = MUL_TABLE[gf_inv(int(r[p])), r]
        basis.append((p, r))
        chosen.append(ri)
        if len(chosen) == want:
            break
    return chosen


@functools.lru_cache(maxsize=256)
def decode_plan(k: int, m: int, nodes: tuple[int, ...],
                ) -> tuple[tuple[tuple[int, int], ...], np.ndarray]:
    """Conventional MBR decode plan from >= k surviving nodes.

    Returns (picks, inv): picks is a tuple of B (node, stored_row)
    coordinates whose generator rows are independent, and inv is the
    (B, B) inverse such that W = inv @ stacked_picked_symbol_rows.
    MBR decodability guarantees any k nodes span the full message; the
    greedy selection just finds a concrete invertible subset."""
    g = geometry(k, m)
    if len(set(nodes)) < g.k:
        raise ValueError(
            f"regen decode needs >= {g.k} nodes, got {len(set(nodes))}")
    G = node_generators(k, m)
    rows = np.concatenate([G[i] for i in nodes], axis=0)
    sel = _independent_rows(rows, g.B)
    if len(sel) < g.B:
        raise ValueError(
            f"regen generator rows rank-deficient: {len(sel)}/{g.B}")
    inv = gf_mat_invert(rows[sel])
    picks = tuple((nodes[p // g.d], p % g.d) for p in sel)
    return picks, inv


@functools.lru_cache(maxsize=256)
def decode_bitplane(k: int, m: int, nodes: tuple[int, ...]) -> np.ndarray:
    return gf_matrix_to_bitplane(decode_plan(k, m, nodes)[1])


@functools.lru_cache(maxsize=64)
def placed_encode_bitplane(k: int, m: int, device: torch.device):
    """encode_bitplane as an rs_gpu.BitMatrix on ``device``, placed once."""
    from .rs_gpu import BitMatrix
    return BitMatrix.from_numpy(encode_bitplane(k, m), device)


@functools.lru_cache(maxsize=256)
def placed_decode_bitplane(k: int, m: int, nodes: tuple[int, ...],
                           device: torch.device):
    """decode_bitplane as an rs_gpu.BitMatrix on ``device``, placed once."""
    from .rs_gpu import BitMatrix
    return BitMatrix.from_numpy(decode_bitplane(k, m, nodes), device)


def repair_rows(k: int, m: int, failed: int,
                ) -> tuple[tuple[int, int, int], ...]:
    """Repair-by-transfer plan for node `failed`.

    Returns ((helper, helper_row, dest_row), ...): helper i's stored
    row for partner j=failed (its helper_row-th stored row) IS the
    failed node's stored row for partner j=i (its dest_row-th row) —
    P is symmetric, so the shipped symbols need no transform at all."""
    g = geometry(k, m)
    if not 0 <= failed < g.n:
        raise ValueError(f"failed node {failed} out of range 0..{g.n - 1}")
    plan = []
    for helper in range(g.n):
        if helper == failed:
            continue
        helper_row = failed - 1 if failed > helper else failed
        dest_row = helper - 1 if helper > failed else helper
        plan.append((helper, helper_row, dest_row))
    return tuple(plan)


# --- stripe packing -----------------------------------------------------------


def stripe_count(k: int, m: int, length: int) -> int:
    """Stripes per block of `length` bytes: nst = ceil(length / B)."""
    g = geometry(k, m)
    return -(-length // g.B)


def pack_block(k: int, m: int, data: bytes | np.ndarray) -> np.ndarray:
    """One block's bytes -> (B, nst) stripe columns (zero-padded)."""
    g = geometry(k, m)
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(
            data, dtype=np.uint8)
    nst = stripe_count(k, m, buf.size)
    padded = np.zeros(nst * g.B, dtype=np.uint8)
    padded[:buf.size] = buf
    return np.ascontiguousarray(padded.reshape(nst, g.B).T)


def pack_blocks_batch(k: int, m: int, blocks: np.ndarray) -> np.ndarray:
    """(nblk, L) equal-length blocks -> (B, nblk * nst) stripe columns,
    block b occupying column slice [b*nst, (b+1)*nst)."""
    g = geometry(k, m)
    nblk, L = blocks.shape
    nst = stripe_count(k, m, L)
    padded = np.zeros((nblk, nst * g.B), dtype=np.uint8)
    padded[:, :L] = blocks
    cols = padded.reshape(nblk, nst, g.B).transpose(2, 0, 1)
    return np.ascontiguousarray(cols.reshape(g.B, nblk * nst))


def unpack_block(W: np.ndarray, length: int) -> bytes:
    """(B, nst) stripe columns -> the block's first `length` bytes."""
    return np.ascontiguousarray(W.T).tobytes()[:length]


# --- measured-lane dispatch ---------------------------------------------------


def apply_regen(mat: np.ndarray, cols: np.ndarray, *,
                use_device, bitplane=None,
                affinity: int | None = None, blocks: int = 1,
                device_fallback: bool = True, device=None) -> np.ndarray:
    """One GF matmul (mat @ cols) on the measured lane.

    use_device: callable(nbytes) -> bool (the codec's lane seam).
    bitplane: ``device -> rs_gpu.BitMatrix``, mat's bit-plane matrix
    placed on a device (``placed_encode_bitplane`` & co., partially
    applied); packed from ``mat`` per call if omitted.
    device: where the kernel lane runs (default: the dispatch device).
    Recorded under REGEN_CODE in kernel_stats/kernprof so the autotuner
    refines the regen lanes from live traffic like rs_encode/rs_decode.
    """
    from ..obs.kernel_stats import KERNEL, timed
    from ..qos import scheduler as qos_sched
    from . import batching
    cols = np.ascontiguousarray(cols, dtype=np.uint8)
    nbytes = int(cols.nbytes)
    lane = qos_sched.current_lane()
    with qos_sched.GATE.dispatch(lane):
        if use_device(nbytes) and batching._device_allowed(device_fallback,
                                                           device):
            try:
                from ..faultinject import FAULTS
                FAULTS.kernel(REGEN_CODE)
                out = _device_apply(mat, bitplane, cols, affinity, blocks,
                                    device)
                batching.STATS.add(True, nbytes, 1)
                return out
            except Exception as exc:
                if not (device_fallback
                        and batching.device_dispatch_failed(exc, device)):
                    raise
        from .autotune import AUTOTUNE
        with timed() as t:
            out, backend = batching.host_apply_tagged(
                mat, cols, AUTOTUNE.host_lane(REGEN_CODE, nbytes))
        KERNEL.record(REGEN_CODE, False, nbytes, t.s, blocks=blocks,
                      backend=backend)
        batching.STATS.add(False, nbytes, 1)
        return out


def _device_apply(mat: np.ndarray, bitplane, cols: np.ndarray,
                  affinity: int | None, blocks: int,
                  device=None) -> np.ndarray:
    """K1 over the (1, B, S) batch on the kernel lane, split over the
    serving mesh like any batch."""
    from ..obs.kernel_stats import KERNEL, timed
    from . import batching, rs_gpu
    with timed() as t:
        placed = batching.device_put_batch(cols[None], affinity, device)
        if bitplane is None:
            mats = batching.device_put_replicated(
                gf_matrix_to_bitplane(mat), placed.device)
            bitplane = mats.__getitem__
        out = placed.apply(lambda x: rs_gpu.gf_apply(bitplane(x.device),
                                                     x))[0]
    dev = placed.device
    KERNEL.record(REGEN_CODE, dev.type == "cuda", cols.nbytes, t.s,
                  blocks=blocks, backend=batching.attempt_backend(dev))
    return out


# --- probe (ops/autotune ladder) ----------------------------------------------


def probe_lane(lane: str, nstripes: int) -> tuple[float | None, str]:
    """Known-answer throughput probe of one regen dispatch lane.

    Mirrors select_kernels.probe_lane: a deterministic 4+2 encode of
    `nstripes` stripe columns, checked against the table-gather truth,
    timed after one warm-up run.  Returns (bytes/s, "") or (None, why);
    a kernel or native build failure raises.
    """
    import time

    from ..obs.kernprof import DEVICE, HOST, NATIVE, TORCH_CPU
    from . import _cuda, batching, rs_gpu
    from ._cuda import BuildFailed
    k, m = 4, 2
    g = geometry(k, m)
    rng = np.random.default_rng(12073022)
    W = rng.integers(0, 256, size=(g.B, nstripes), dtype=np.uint8)
    mat = encode_matrix_regen(k, m)
    want = gf_mat_vec_apply(mat, W)
    nbytes = W.nbytes
    try:
        from ..faultinject import FAULTS
        FAULTS.kernel(REGEN_CODE)
        if lane in (DEVICE, TORCH_CPU):
            dev = batching.dispatch_device()
            bm = placed_encode_bitplane(k, m, dev)
            x = _cuda.to_device(W[None], dev)
            rs_gpu.gf_apply(bm, x).cpu()  # warm: kernel build
            t0 = time.perf_counter()
            got = rs_gpu.gf_apply(bm, x).cpu().numpy()[0]
            wall = time.perf_counter() - t0
        elif lane in (NATIVE, HOST):
            batching.host_apply_tagged(mat, W, lane)  # warm
            t0 = time.perf_counter()
            got, backend = batching.host_apply_tagged(mat, W, lane)
            wall = time.perf_counter() - t0
            if lane == NATIVE and backend != NATIVE:
                return None, "native kernel disabled"
        else:
            return None, f"unknown lane {lane!r}"
        if not np.array_equal(got, want):
            return None, "known-answer mismatch"
        return nbytes / max(wall, 1e-9), ""
    except BuildFailed:
        raise
    except Exception as exc:  # probe must never take the ladder down
        return None, f"{type(exc).__name__}: {exc}"
