"""Mask-grouped batching and the device side of the dispatch plane.

Port of minio_tpu/ops/batching.py. It decides, for each coding dispatch,
which lane runs it and on which device:

- **The dispatch device.** ``set_dispatch_device`` names, for the whole
  process, the device the kernel lane runs on: ``"cuda"`` (the default:
  the hand-written kernels on every card the census finds) or ``"cpu"``
  (their plain PyTorch versions, the ``torch-cpu`` lane).
  ``dispatch_device()`` raises without a card when it is ``"cuda"``:
  nothing falls back to the CPU silently.
- **Placement.** A (B, R, S) batch splits over the serving mesh
  (parallel/mesh.py): B over 'blocks', S over 'lanes' when they divide,
  or lands whole on its erasure set's home device. ``PlacedBatch``
  launches the kernel once per tile on that tile's device and gathers
  the results on the host.
- ``reconstruct_blocks``: blocks sharing an erasure signature
  ``(available, missing, shard_len)`` collapse into ONE dispatch, on the
  kernel lane or the host lanes (C++ ``native``, numpy ``host``) as the
  caller's policy says.
- ``EncodeCoalescer``: a cross-request window that merges concurrent PUT
  encodes into one device dispatch, fanned out per home device when a
  window's requests span several.

``STATS`` counts every dispatch so tests can prove which lane did the
math; its keys are the port's (``gpu_dispatches``, ``gpu_bytes``) where
the reference says ``tpu_*``. A kernel-lane failure feeds the kernprof
health machine (obs/kernprof.py). Only on the CPU lane (``torch-cpu``)
does the dispatch then rerun on the host lanes: a failure on a card,
and any build failure, reaches the caller, as on a pinned lane.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _cuda, rs_gpu
from ._cuda import BuildFailed
from .gf256 import gf_mat_vec_apply
from .rs_matrix import any_decode_matrix

# --- the dispatch device -----------------------------------------------------

_dispatch_type = "cuda"
_device_present: bool | None = None
_device_count: int | None = None


def set_dispatch_device(device) -> None:
    """Set the process-wide device of the kernel lane, ``"cuda"`` or
    ``"cpu"``; drops the device census and the serving mesh."""
    global _dispatch_type, _device_present, _device_count
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported dispatch device {device!r}")
    _dispatch_type = kind
    _device_present = None
    _device_count = None
    reset_serving_mesh()


def dispatch_device() -> torch.device:
    """The device the kernel lane runs on; raises RuntimeError without a
    card when the dispatch device is ``"cuda"``."""
    return _cuda.resolve_device(_dispatch_type)


def device_list() -> list[torch.device]:
    """The device census: every CUDA card, or the CPU."""
    if _dispatch_type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_present() -> bool:
    """A card is the kernel lane (cached census; ``reprobe`` renews it)."""
    global _device_present, _device_count
    if _device_present is None:
        devs = device_list()
        _device_count = max(1, len(devs))
        _device_present = _dispatch_type == "cuda" and bool(devs)
    return _device_present


def device_count() -> int:
    """Devices in the census (at least 1)."""
    device_present()
    return _device_count or 1


def reprobe_device_present() -> bool:
    """Drop the cached device census and ask again -- the kernprof DEVICE
    recovery probe's entry point.  A census that comes back with a
    DIFFERENT device count must not keep dispatching over the stale
    mesh: the serving mesh is rebuilt and the autotuner re-probes and
    re-plans."""
    global _device_present
    old_count = _device_count
    _device_present = None
    present = device_present()
    if old_count is not None and _device_count != old_count:
        reset_serving_mesh()
        from .autotune import AUTOTUNE
        AUTOTUNE.on_device_census_change(old_count, _device_count or 1)
    return present


def _lane_type(device=None) -> str:
    return torch.device(device).type if device is not None \
        else _dispatch_type


def attempt_backend(device=None) -> str:
    """Which kernprof backend a kernel-lane dispatch on ``device`` (the
    dispatch device by default) lands on: ``device`` on a card,
    ``torch-cpu`` (the plain versions) on the CPU."""
    from ..obs.kernprof import DEVICE, TORCH_CPU
    return DEVICE if _lane_type(device) == "cuda" else TORCH_CPU


def device_dispatch_failed(exc: BaseException, device=None) -> bool:
    """A kernel-lane dispatch on ``device`` raised ``exc``: feed the
    per-backend health state machine (obs/kernprof.py), which logs every
    state TRANSITION with its cause, and say whether the dispatch may
    rerun on the host lanes.  Only the CPU lane may: a card's failure
    and a build failure reach the caller, so no broken card or kernel
    hides behind host work."""
    if isinstance(exc, BuildFailed):
        return False
    from ..obs.kernprof import KERNPROF
    KERNPROF.dispatch_failed(attempt_backend(device), exc)
    return _lane_type(device) != "cuda"


def _device_allowed(device_fallback: bool = True, device=None) -> bool:
    """State-machine gate on the kernel lane: a DOWN backend is skipped
    (recovery is the probe's job; the card lane is never skipped, see
    ``KernelProfiler.allow``).  A pinned backend (device_fallback=False)
    bypasses the gate -- the caller asked for errors, not rerouting."""
    if not device_fallback:
        return True
    from ..obs.kernprof import KERNPROF
    return KERNPROF.allow(attempt_backend(device))


class DispatchStats:
    """Thread-safe counters for codec dispatches (device vs host)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.gpu_dispatches = 0
            self.gpu_bytes = 0
            self.cpu_dispatches = 0
            self.cpu_bytes = 0
            self.coalesced_requests = 0

    def add(self, device: bool, nbytes: int, requests: int = 1) -> None:
        with self._lock:
            if device:
                self.gpu_dispatches += 1
                self.gpu_bytes += nbytes
            else:
                self.cpu_dispatches += 1
                self.cpu_bytes += nbytes
            if requests > 1:
                self.coalesced_requests += requests

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "gpu_dispatches": self.gpu_dispatches,
                "gpu_bytes": self.gpu_bytes,
                "cpu_dispatches": self.cpu_dispatches,
                "cpu_bytes": self.cpu_bytes,
                "coalesced_requests": self.coalesced_requests,
            }


STATS = DispatchStats()

# Bitrot (HighwayHash) dispatch counters -- a separate instance so the two
# halves of the data plane (coding vs hashing) are told apart.
HH_STATS = DispatchStats()


class ReconstructError(ValueError):
    """Not enough survivor shards to rebuild a block."""


# --- multi-device placement ----------------------------------------------------

_serving_mesh = None
_serving_mesh_built = False
_mesh_lock = threading.Lock()


def serving_mesh():
    """The device mesh serving batches split over (None on one device):
    any (B, R, S) batch spreads B over 'blocks' and S over 'lanes'
    whenever the dims divide the mesh."""
    global _serving_mesh, _serving_mesh_built
    if not _serving_mesh_built:
        with _mesh_lock:
            if not _serving_mesh_built:
                devs = device_list()
                mesh = None
                if len(devs) > 1:
                    from ..parallel.mesh import make_mesh
                    mesh = make_mesh(devs)
                _serving_mesh = mesh
                _serving_mesh_built = True
    return _serving_mesh


def reset_serving_mesh() -> None:
    """Rebuild the mesh after device-count changes."""
    global _serving_mesh, _serving_mesh_built
    with _mesh_lock:
        _serving_mesh = None
        _serving_mesh_built = False


def _mesh_for(dev: torch.device):
    """The serving mesh when ``dev`` is of the dispatch device's kind."""
    return serving_mesh() if dev.type == _dispatch_type else None


class PlacedBatch:
    """A host (B, R, S) batch laid out for one dispatch: per tile, the
    device that computes it, its batch and lane slices, and the tile as
    a tensor on that device."""

    def __init__(self, shape: tuple[int, ...], tiles: list):
        self.shape = shape
        self.tiles = tiles

    @property
    def device(self) -> torch.device:
        return self.tiles[0][3].device

    def apply(self, fn, shardmajor: bool = False) -> np.ndarray:
        """fn(tile) -> (b, R', s) tensor, launched on every tile first and
        then gathered into one host array: (B, R', S), or (R', B, S)
        when ``shardmajor`` (fn then returns (R', b, s))."""
        outs = [(bs, ss, fn(t)) for _, bs, ss, t in self.tiles]
        if len(outs) == 1:
            return outs[0][2].cpu().numpy()
        B, _, S = self.shape
        rows = outs[0][2].shape[0 if shardmajor else 1]
        host = np.empty((rows, B, S) if shardmajor else (B, rows, S),
                        dtype=np.uint8)
        for bs, ss, o in outs:
            if shardmajor:
                host[:, bs, ss] = o.cpu().numpy()
            else:
                host[bs, :, ss] = o.cpu().numpy()
        return host


def device_put_batch(x: np.ndarray, affinity: int | None = None,
                     device=None) -> PlacedBatch:
    """np (B, R, S) -> the placed batch: split across the serving mesh
    when an axis divides it, WHOLE on the owning erasure set's home
    device otherwise (parallel/mesh.batch_placement).  Every mesh
    placement lands in the MESH_AFFINITY census.  ``device`` (default:
    the dispatch device) is where a batch runs when there is no mesh of
    its kind."""
    dev = _cuda.resolve_device(device if device is not None
                               else _dispatch_type)
    m = _mesh_for(dev)
    if m is None:
        return PlacedBatch(x.shape, [(0, slice(None), slice(None),
                                      _cuda.to_device(x, dev))])
    from ..parallel.mesh import MESH_AFFINITY, batch_placement
    B, _, S = x.shape
    placement, dev_indices = batch_placement(m, B, S, affinity)
    MESH_AFFINITY.record_dispatch(dev_indices, x.nbytes)
    census = device_list()
    return PlacedBatch(x.shape, [
        (di, bs, ss, _cuda.to_device(x[bs, :, ss], census[di]))
        for di, bs, ss in placement.tiles])


def pinned_device(B: int, S: int, affinity: int | None) -> int | None:
    """Device index a (B, ., S) batch will be pinned to under the current
    mesh placement, or None when it splits across the mesh."""
    m = serving_mesh()
    if m is None or affinity is None:
        return None
    from ..parallel.mesh import batch_placement
    _, dev_indices = batch_placement(m, B, S, affinity)
    return dev_indices[0] if len(dev_indices) == 1 else None


def batch_home_device(x, affinity: int | None) -> int | None:
    """pinned_device for an actual (B, R, S) array."""
    return pinned_device(x.shape[0], x.shape[-1], affinity)


def device_put_replicated(big_m, device=None) -> dict:
    """A small operand (a GF bit-plane matrix) placed on every device a
    batch may run on: {torch.device: rs_gpu.BitMatrix}."""
    dev = _cuda.resolve_device(device if device is not None
                               else _dispatch_type)
    m = _mesh_for(dev)
    devs = set(m.devices) if m is not None else {dev}
    return {d: rs_gpu.as_bitmatrix(big_m, d) for d in devs}


def device_encode(data: np.ndarray, k: int, m: int,
                  affinity: int | None = None, device=None,
                  shardmajor: bool = False) -> np.ndarray:
    """Encode a (B, k, S) batch on the kernel lane -> (B, k+m, S), or
    (k+m, B, S) when ``shardmajor``: split over the serving mesh or
    pinned to the set's home device (``device_put_batch``), one K1 launch
    per tile.  Recorded in the kernel counters under the lane that
    ran."""
    from ..obs.kernel_stats import KERNEL, RS_ENCODE, timed
    with timed() as t:
        placed = device_put_batch(data, affinity, device)
        if shardmajor:
            out = placed.apply(lambda x: rs_gpu.encode_blocks_shardmajor(
                rs_gpu.placed_parity(k, m, x.device), x), shardmajor=True)
        else:
            out = placed.apply(lambda x: rs_gpu.encode_blocks(
                rs_gpu.placed_parity(k, m, x.device), x))
    dev = placed.device
    KERNEL.record(RS_ENCODE, dev.type == "cuda", data.nbytes, t.s,
                  blocks=data.shape[0], backend=attempt_backend(dev))
    return out


def _device_reconstruct(stack: np.ndarray, k: int, m: int,
                        avail: tuple[int, ...], missing: tuple[int, ...],
                        affinity: int | None = None,
                        device=None) -> np.ndarray:
    from ..obs.kernel_stats import KERNEL, RS_DECODE, timed
    with timed() as t:
        placed = device_put_batch(stack, affinity, device)
        out = placed.apply(lambda x: rs_gpu.gf_apply(
            rs_gpu.placed_any_decode(k, m, avail, missing, x.device)[0],
            x))
    dev = placed.device
    KERNEL.record(RS_DECODE, dev.type == "cuda", stack.nbytes, t.s,
                  blocks=stack.shape[0], backend=attempt_backend(dev))
    return out


def host_apply_tagged(mat: np.ndarray, cols: np.ndarray,
                      lane: str | None = None,
                      ) -> tuple[np.ndarray, str]:
    """host_apply plus which backend actually ran (kernprof NATIVE when
    the C++ kernel answered, HOST for the numpy table-gather) -- the
    per-dispatch profile must not lump them.  ``lane`` (from the
    autotuner plan) pins pure numpy when the measured model says so;
    default is native-first, numpy only when the native library is
    disabled."""
    from ..obs.kernprof import HOST, NATIVE
    if lane != HOST:
        from ..native import rs_apply_native
        out = rs_apply_native(mat, cols)
        if out is not None:
            return out, NATIVE
    return gf_mat_vec_apply(mat, cols), HOST


def host_apply(mat: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """(r, k) GF matrix x (k, N) bytes on the host: the C++ nibble-
    shuffle kernel (native/rs.cc), numpy table-gather when it is
    disabled. Byte-identical either way."""
    return host_apply_tagged(mat, cols)[0]


def _host_reconstruct(stack: np.ndarray, mat: np.ndarray,
                      lane: str | None = None) -> np.ndarray:
    """(B, n_used, S) -> (B, n_missing, S) via one folded apply: RS is
    byte-column-independent, so the batch dim folds into the columns."""
    from ..obs.kernel_stats import KERNEL, RS_DECODE, timed
    B, n_used, S = stack.shape
    with timed() as t:
        cols = stack.transpose(1, 0, 2).reshape(n_used, B * S)
        out, backend = host_apply_tagged(mat, cols, lane)
        out = out.reshape(mat.shape[0], B, S).transpose(1, 0, 2)
    KERNEL.record(RS_DECODE, False, stack.nbytes, t.s, blocks=B,
                  backend=backend)
    return out


def reconstruct_blocks(blocks: list[list[np.ndarray | None]], k: int,
                       m: int, *, want_all: bool, use_device,
                       device_fallback: bool = True,
                       affinity: int | None = None, device=None,
                       ) -> list[list[np.ndarray | None]]:
    """Rebuild missing shards across many blocks, one dispatch per mask.

    blocks: each entry is a k+m shard list (None = missing) for one
    stripe block; shard lengths may differ between blocks (tail blocks).
    want_all: rebuild parity too (heal) vs data only (GET).
    use_device: callable(coalesced_nbytes) -> bool: the kernel lane, or
    the host lanes the autotuner's plan names.
    device_fallback: on a failure of the CPU kernel lane, feed kernprof
    and use the host lanes (False when the caller pinned the lane: errors
    propagate, as they always do on a card).
    device: where the kernel lane runs (default: the dispatch device).

    Returns new per-block lists; input arrays are never mutated.
    Byte-identical to per-block rs_cpu reconstruct.
    """
    n = k + m
    out = [list(b) for b in blocks]
    groups: dict[tuple, list[int]] = {}
    for bi, shards in enumerate(blocks):
        if len(shards) != n:
            raise ValueError(f"block {bi}: expected {n} shard slots")
        avail = tuple(i for i, s in enumerate(shards) if s is not None)
        lim = n if want_all else k
        missing = tuple(i for i in range(lim) if shards[i] is None)
        if not missing:
            continue
        if len(avail) < k:
            raise ReconstructError(
                f"block {bi}: only {len(avail)}/{k} shards available")
        S = int(np.asarray(shards[avail[0]]).shape[-1])
        groups.setdefault((avail, missing, S), []).append(bi)

    # Priority lanes (qos/scheduler.py): a heal/crawler reconstruct
    # defers its dispatch while foreground GET/PUT work is busy; aging
    # promotes it after a bounded wait so background never starves.
    from ..qos import scheduler as qos_sched
    lane = qos_sched.current_lane()
    on_card = _lane_type(device) == "cuda"
    for (avail, missing, S), idxs in groups.items():
        mat, used = any_decode_matrix(k, m, avail, missing)
        stack = np.stack([
            np.asarray(blocks[bi][j], dtype=np.uint8)
            for bi in idxs for j in used]).reshape(
                len(idxs), len(used), S)
        with qos_sched.GATE.dispatch(lane):
            if use_device(stack.nbytes) and \
                    _device_allowed(device_fallback, device):
                try:
                    # Kernel-dispatch fault hook: an injected failure
                    # lands inside this try, so on the CPU lane the host
                    # lane below is what gets exercised.
                    from ..faultinject import FAULTS
                    FAULTS.kernel("rs_decode")
                    rebuilt = _device_reconstruct(stack, k, m, avail,
                                                  missing, affinity, device)
                    STATS.add(on_card, stack.nbytes, len(idxs))
                except Exception as exc:
                    if not (device_fallback
                            and device_dispatch_failed(exc, device)):
                        raise
                    rebuilt = _host_reconstruct(stack, mat)
                    STATS.add(False, stack.nbytes, len(idxs))
            else:
                from .autotune import AUTOTUNE
                from .autotune import RS_DECODE as _RSD
                rebuilt = _host_reconstruct(
                    stack, mat, lane=AUTOTUNE.host_lane(_RSD,
                                                        stack.nbytes))
                STATS.add(False, stack.nbytes, len(idxs))
        for bn, bi in enumerate(idxs):
            for mi, j in enumerate(missing):
                out[bi][j] = rebuilt[bn, mi]
    return out


# --- cross-request encode coalescing -------------------------------------------


def host_encode(blocks: np.ndarray, k: int, m: int,
                lane: str | None = None) -> np.ndarray:
    """(B, k, S) -> (B, k+m, S) on the host lanes, counted in STATS.

    The batch folds into the columns of ONE matrix apply (native C++
    unless the plan pins numpy), matching the reference's per-block
    encode bytes exactly (ref cmd/erasure-coding.go:70)."""
    from .rs_matrix import parity_matrix
    from ..obs.kernel_stats import KERNEL, RS_ENCODE, timed
    B, _, S = blocks.shape
    with timed() as t:
        out = np.zeros((B, k + m, S), dtype=np.uint8)
        out[:, :k] = blocks
        cols = blocks.transpose(1, 0, 2).reshape(k, B * S)
        parity, backend = host_apply_tagged(parity_matrix(k, m), cols,
                                            lane)
        out[:, k:] = parity.reshape(m, B, S).transpose(1, 0, 2)
    STATS.add(False, blocks.nbytes)
    KERNEL.record(RS_ENCODE, False, blocks.nbytes, t.s, blocks=B,
                  backend=backend)
    return out


def host_encode_shardmajor(blocks: np.ndarray, k: int, m: int,
                           lane: str | None = None) -> np.ndarray:
    """(B, k, S) -> SHARD-MAJOR (k+m, B, S) contiguous, on the host lanes:
    the matrix apply reads the output buffer's own data rows as its
    (k, B*S) columns, and the caller's bitrot framing wants shard-major
    anyway."""
    from .rs_matrix import parity_matrix
    from ..obs.kernel_stats import KERNEL, RS_ENCODE, timed
    B, _, S = blocks.shape
    with timed() as t:
        out = np.empty((k + m, B, S), dtype=np.uint8)
        out[:k] = blocks.transpose(1, 0, 2)
        parity, backend = host_apply_tagged(parity_matrix(k, m),
                                            out[:k].reshape(k, B * S),
                                            lane)
        out[k:] = parity.reshape(m, B, S)
    STATS.add(False, blocks.nbytes)
    KERNEL.record(RS_ENCODE, False, blocks.nbytes, t.s, blocks=B,
                  backend=backend)
    return out


@dataclass
class _EncodeRequest:
    blocks: np.ndarray  # (B, k, S) uint8 data shards
    k: int
    m: int
    # Home device of the submitting erasure set (parallel/mesh.py
    # DeviceAffinity): a coalesced window whose requests span >= 2
    # home devices fans out as parallel per-device dispatches.
    affinity: int | None = None
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    declined: bool = False
    # A card's dispatch or a kernel build failed: raised to the caller,
    # never declined.
    error: BaseException | None = None
    # Enqueue stamp: the window wait this request paid, reported apart
    # from the execute wall (kernprof queue-wait vs execute split).
    t_enq: float = field(default_factory=time.perf_counter)


class EncodeCoalescer:
    """Cross-request PUT-encode window.

    Handler threads submit ``(B, k, S)`` pre-split batches; a dispatcher
    thread gathers everything arriving within ``window_s`` of the first
    request, groups by ``(k, m, S)``, and issues one device dispatch per
    group when the coalesced bytes clear the policy. Groups below it are
    DECLINED back to their callers, which host-encode in their own
    threads -- the dispatcher never serializes host work, it only fronts
    the (serial) device. A failure of the CPU kernel lane also declines
    (after feeding kernprof); a card's failure, or a build failure, is
    raised to every caller of the window. ``stop()`` ends the dispatcher
    thread.
    """

    def __init__(self, use_device, window_s: float = 0.003):
        self._use_device = use_device
        self.window_s = window_s
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._stopped = False

    def encode(self, blocks: np.ndarray, k: int, m: int,
               affinity: int | None = None) -> np.ndarray:
        """Blocking encode: (B, k, S) data -> (B, k+m, S) all shards.

        A background caller (heal) yields the coalescing window: it
        defers submission while foreground PUT encodes are busy, so the
        window batches client traffic; aging promotes it after a
        bounded wait."""
        from ..qos import scheduler as qos_sched
        with qos_sched.GATE.dispatch(qos_sched.current_lane()):
            req = _EncodeRequest(
                np.ascontiguousarray(blocks, dtype=np.uint8), k, m,
                affinity)
            self._ensure_thread()
            self._q.put(req)
            # Liveness-checked wait: if the dispatcher dies, host-encode
            # rather than hang the PUT handler forever.
            while not req.done.wait(0.25):
                t = self._thread
                if t is None or not t.is_alive():
                    req.declined = True
                    break
            if req.error is not None:
                raise req.error
            if req.declined or req.result is None:
                return host_encode(req.blocks, k, m)
            return req.result

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stopped = False
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="encode-coalescer")
                self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- dispatcher ----------------------------------------------------

    def _run(self) -> None:
        while not self._stopped:
            req = self._q.get()
            if req is None:
                break
            batch = [req]
            # Fast path: a lone sub-threshold request has nothing to
            # coalesce with -- decline immediately instead of taxing the
            # PUT with the window latency. A concurrent burst still
            # coalesces: the queue is non-empty then.
            if self._q.empty() and not (
                    self._use_device(req.blocks.nbytes)
                    and _device_allowed()):
                self._dispatch(batch)
                continue
            deadline = time.monotonic() + self.window_s
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stopped = True
                    break
                batch.append(nxt)
            self._dispatch(batch)

    def _dispatch(self, batch: list[_EncodeRequest]) -> None:
        from ..obs.kernprof import KERNPROF
        from ..obs.kernel_stats import RS_ENCODE as _RS_ENC
        now = time.perf_counter()
        for r in batch:
            # Window wait, whatever the outcome: a declined request
            # still paid it on top of its own host encode.
            KERNPROF.record_queue_wait(_RS_ENC, (now - r.t_enq) * 1e3)
        groups: dict[tuple, list[_EncodeRequest]] = {}
        for r in batch:
            key = (r.k, r.m, r.blocks.shape[-1])
            groups.setdefault(key, []).append(r)
        for (k, m, S), reqs in groups.items():
            total = sum(r.blocks.nbytes for r in reqs)
            if not self._use_device(total) or \
                    not KERNPROF.allow(attempt_backend()):
                for r in reqs:
                    r.declined = True
                    r.done.set()
                continue
            try:
                # Kernel-dispatch fault hook: on the CPU lane, raising
                # here declines the batch to the callers' host encode.
                from ..faultinject import FAULTS
                FAULTS.kernel("rs_encode")
                by_dev = self._fanout_split(reqs)
                if by_dev is not None:
                    self._fanout_encode(by_dev, k, m)
                else:
                    stack = (reqs[0].blocks if len(reqs) == 1 else
                             np.concatenate([r.blocks for r in reqs],
                                            axis=0))
                    encoded = device_encode(stack, k, m,
                                            affinity=reqs[0].affinity)
                    off = 0
                    for r in reqs:
                        B = r.blocks.shape[0]
                        r.result = encoded[off:off + B]
                        off += B
                STATS.add(_dispatch_type == "cuda", total, len(reqs))
                if len(reqs) > 1:
                    # device_encode counted the dispatch itself; the
                    # coalescing win (requests merged per window) is only
                    # visible here.
                    from ..obs.kernel_stats import KERNEL, RS_ENCODE
                    KERNEL.record_coalesced(RS_ENCODE, len(reqs))
            except Exception as exc:  # noqa: BLE001 - each caller decides
                to_host = device_dispatch_failed(exc)
                for r in reqs:
                    r.declined = to_host
                    r.error = None if to_host else exc
            finally:
                for r in reqs:
                    r.done.set()

    @staticmethod
    def _fanout_split(reqs: list[_EncodeRequest],
                      ) -> dict[int, list[_EncodeRequest]] | None:
        """Group a coalesced window's requests by home device.

        >= 2 distinct home devices on a live serving mesh, AND every
        sub-batch PINS to its home device -> the window fans out as
        parallel per-device dispatches. A sub-batch an axis of which
        divides the mesh would split across ALL devices instead --
        fanning those out turns one combined dispatch into N contending
        ones, so the split is declined.  None = no clean split: the
        caller makes one dispatch, split over the mesh when B divides."""
        if len(reqs) < 2 or serving_mesh() is None:
            return None
        from ..parallel.mesh import MESH_AFFINITY
        n_dev = MESH_AFFINITY.n_devices()
        by: dict[int, list[_EncodeRequest]] = {}
        for r in reqs:
            if r.affinity is None:
                return None
            # Group by EFFECTIVE device: after a device-count shrink, two
            # sets' stale raw indices can alias (mod n) onto one device.
            by.setdefault(r.affinity % max(1, n_dev), []).append(r)
        if len(by) < 2:
            return None
        for dev, sub in by.items():
            B = sum(r.blocks.shape[0] for r in sub)
            S = sub[0].blocks.shape[-1]
            if pinned_device(B, S, dev) is None:
                return None
        return by

    @staticmethod
    def _fanout_encode(by_dev: dict[int, list[_EncodeRequest]],
                       k: int, m: int) -> None:
        """Parallel per-device encode of a fanned-out window; each
        request's result is byte-identical to the single-dispatch path
        (encode is per-block independent).  Any sub-dispatch failure
        propagates, and the whole window fails as one dispatch would."""
        from ..parallel.quorum import parallel_map

        def enc(dev: int, sub: list[_EncodeRequest]) -> None:
            stack = (sub[0].blocks if len(sub) == 1 else
                     np.concatenate([r.blocks for r in sub], axis=0))
            encoded = device_encode(stack, k, m, affinity=dev)
            off = 0
            for r in sub:
                B = r.blocks.shape[0]
                r.result = encoded[off:off + B]
                off += B

        subs = sorted(by_dev.items())
        _, errs = parallel_map(
            [lambda d=dev, s=sub: enc(d, s) for dev, sub in subs])
        for e in errs:
            if e is not None:
                raise e
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_codec_plan_fanout_total",
                     {"devices": str(len(subs))})


_global_coalescer: EncodeCoalescer | None = None
_global_lock = threading.Lock()


def default_device_policy(nbytes: int) -> bool:
    """Kernel-lane policy for the shared coalescer: the MEASURED plan
    (ops/autotune.py), the static device-first policy until the probe
    ladder has run."""
    from .autotune import AUTOTUNE, RS_ENCODE
    return AUTOTUNE.use_jit_lane(RS_ENCODE, nbytes)


def get_coalescer() -> EncodeCoalescer:
    """Process-wide coalescer shared by every codec instance."""
    global _global_coalescer
    with _global_lock:
        if _global_coalescer is None:
            _global_coalescer = EncodeCoalescer(default_device_policy)
        return _global_coalescer
