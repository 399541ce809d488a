"""RegenErasure: the REGEN storage class codec.

Port of minio_tpu/erasure/regen/codec.py.

Size semantics (the layout contract shared with ops/rs_regen.py,
storage/metadata.ErasureInfo.shard_size and repair.py): a block of L
bytes carries nst = ceil(L / B) stripes; every node stores alpha = d
symbol rows of nst bytes each, flattened row-major, so a node's chunk
for the block is d * nst bytes and stored row r sits contiguous at
byte offset r * nst inside it.  All n node chunks are the same size —
regen shards have no data/parity asymmetry (the code is
non-systematic: every GET decodes).

Dispatch rides the lanes exactly like `Erasure`: ``"gpu"`` pins the
batched GF apply to kernel K1 on the card (rs_gpu.gf_apply, errors
propagate), ``"cpu"`` to K1's plain PyTorch version, and ``"auto"``
asks the autotune plan for the ``regen_code`` kernel per dispatch
(the kernel lane on ``device``, or native/numpy through
batching.host_apply_tagged).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import functools

import torch

from ...ops import rs_regen
from ...ops.autotune import AUTOTUNE, REGEN_CODE
from ..codec import BLOCK_SIZE, codec_device


@dataclass
class RegenErasure:
    data_blocks: int
    parity_blocks: int
    block_size: int = BLOCK_SIZE
    backend: str = "gpu"  # "gpu" | "cpu" | "auto"
    # Home device of the owning erasure set (parallel/mesh.py).
    affinity: int | None = field(default=None, repr=False)
    # Where the kernel lane runs (resolved in __post_init__, as Erasure).
    device: torch.device | str | None = field(default=None, repr=False)

    # Dispatch seam for the engine: Erasure instances answer False via
    # getattr default, so every regen branch is one attribute probe.
    is_regen = True

    def __post_init__(self):
        # geometry() validates k > 0, m > 0, n <= 255
        rs_regen.geometry(self.data_blocks, self.parity_blocks)
        self.device = codec_device(self.backend, self.device)

    # --- sizes ---------------------------------------------------------

    @property
    def g(self) -> rs_regen.RegenGeometry:
        return rs_regen.geometry(self.data_blocks, self.parity_blocks)

    @property
    def total_shards(self) -> int:
        return self.g.n

    def stripe_count(self, length: int) -> int:
        return rs_regen.stripe_count(self.data_blocks,
                                     self.parity_blocks, length)

    def chunk_size(self, block_len: int) -> int:
        """Per-node stored bytes for a block of block_len bytes."""
        return self.g.d * self.stripe_count(block_len)

    def shard_size(self) -> int:
        """Per-node size of a full block (the bitrot framing unit)."""
        return self.chunk_size(self.block_size)

    def shard_file_size(self, total_length: int) -> int:
        if total_length == 0:
            return 0
        if total_length < 0:
            return -1
        n_full = total_length // self.block_size
        tail = total_length % self.block_size
        return n_full * self.shard_size() + self.chunk_size(tail)

    def shard_file_offset(self, start_offset: int, length: int,
                          total_length: int) -> int:
        shard_size = self.shard_size()
        end_shard = (start_offset + length) // self.block_size
        till = end_shard * shard_size + shard_size
        return min(till, self.shard_file_size(total_length))

    # --- dispatch ------------------------------------------------------

    def _use_device(self, nbytes: int) -> bool:
        if self.backend != "auto":
            return True
        return AUTOTUNE.use_jit_lane(REGEN_CODE, nbytes)

    def _apply(self, mat: np.ndarray, cols: np.ndarray, bitplane,
               blocks: int) -> np.ndarray:
        return rs_regen.apply_regen(
            mat, cols, use_device=self._use_device, bitplane=bitplane,
            affinity=self.affinity, blocks=blocks,
            device_fallback=self.backend == "auto", device=self.device)

    def _encode_bitplane(self):
        return functools.partial(rs_regen.placed_encode_bitplane,
                                 self.data_blocks, self.parity_blocks)

    # --- encode --------------------------------------------------------

    def encode_data(self, data: bytes | np.ndarray) -> np.ndarray:
        """Encode one (possibly short) block: (n, chunk) uint8 — node
        i's stored chunk is row i."""
        k, m = self.data_blocks, self.parity_blocks
        g = self.g
        buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(
                data, dtype=np.uint8)
        if buf.size == 0:
            return np.zeros((g.n, 0), dtype=np.uint8)
        W = rs_regen.pack_block(k, m, buf)
        flat = self._apply(rs_regen.encode_matrix_regen(k, m), W,
                           self._encode_bitplane(), blocks=1)
        # (n*d, nst) row-major -> node i's d rows are contiguous
        return np.ascontiguousarray(flat.reshape(g.n, g.d * W.shape[1]))

    def encode_blocks_batch_bytes(self, blocks: np.ndarray) -> np.ndarray:
        """Batched encode of (nblk, block_size) raw block bytes ->
        shard-major (n, nblk, shard_size) uint8 (the layout the bitrot
        framer wants, mirroring encode_blocks_batch_shardmajor)."""
        k, m = self.data_blocks, self.parity_blocks
        g = self.g
        nblk, L = blocks.shape
        nst = self.stripe_count(L)
        cols = rs_regen.pack_blocks_batch(k, m, blocks)
        flat = self._apply(rs_regen.encode_matrix_regen(k, m), cols,
                           self._encode_bitplane(), blocks=nblk)
        out = flat.reshape(g.n, g.d, nblk, nst).transpose(0, 2, 1, 3)
        return np.ascontiguousarray(out.reshape(g.n, nblk, g.d * nst))

    # --- decode --------------------------------------------------------

    def _solve_w_groups(self, blocks: list, lens: list[int]):
        """Group blocks by (node set, stripe count) and solve each
        group's message stripes in one batched apply.

        blocks: per block, a length-n list of chunk arrays (d*nst
        bytes) with None for missing nodes.  Yields (idxs, nst, W)
        with W (B, len(idxs)*nst)."""
        k, m = self.data_blocks, self.parity_blocks
        g = self.g
        groups: dict[tuple, list[int]] = {}
        for bi, (shards, L) in enumerate(zip(blocks, lens)):
            avail = tuple(j for j, s in enumerate(shards)
                          if s is not None)
            if len(avail) < k:
                from ...ops.batching import ReconstructError
                raise ReconstructError(
                    f"regen block {bi}: only {len(avail)}/{k} chunks")
            nodes = avail[:k]
            groups.setdefault((nodes, self.stripe_count(L)),
                              []).append(bi)
        for (nodes, nst), idxs in groups.items():
            picks, inv = rs_regen.decode_plan(k, m, nodes)
            sel = np.empty((g.B, len(idxs) * nst), dtype=np.uint8)
            for gi, bi in enumerate(idxs):
                for pi, (node, row) in enumerate(picks):
                    chunk = np.asarray(blocks[bi][node], dtype=np.uint8)
                    sel[pi, gi * nst:(gi + 1) * nst] = \
                        chunk[row * nst:(row + 1) * nst]
            W = self._apply(inv, sel,
                            functools.partial(
                                rs_regen.placed_decode_bitplane, k, m,
                                nodes), blocks=len(idxs))
            yield idxs, nst, W

    def decode_blocks_batch(self, blocks: list,
                            lens: list[int]) -> list[bytes]:
        """Whole-block decode (the GET path — regen is non-systematic,
        so every read decodes): per block a length-n chunk list with
        None for unavailable nodes, plus the block's plain length.
        Any k chunks suffice; mask-grouped into batched dispatches."""
        out: list[bytes | None] = [None] * len(blocks)
        for idxs, nst, W in self._solve_w_groups(blocks, lens):
            for gi, bi in enumerate(idxs):
                out[bi] = rs_regen.unpack_block(
                    W[:, gi * nst:(gi + 1) * nst], lens[bi])
        return out

    def reencode_missing_batch(self, blocks: list, lens: list[int],
                               missing: list[int],
                               ) -> list[dict[int, bytes]]:
        """Conventional repair fallback: solve the message stripes from
        any k chunks, then re-encode the missing nodes' chunks — one
        extra batched apply per group over the stacked missing-node
        generators."""
        k, m = self.data_blocks, self.parity_blocks
        g = self.g
        G = rs_regen.node_generators(k, m)
        mat = np.ascontiguousarray(
            np.concatenate([G[f] for f in missing], axis=0))
        out: list[dict[int, bytes] | None] = [None] * len(blocks)
        for idxs, nst, W in self._solve_w_groups(blocks, lens):
            rebuilt = self._apply(mat, W, None, blocks=len(idxs))
            for gi, bi in enumerate(idxs):
                per: dict[int, bytes] = {}
                for fi_, f in enumerate(missing):
                    rows = rebuilt[fi_ * g.d:(fi_ + 1) * g.d,
                                   gi * nst:(gi + 1) * nst]
                    per[f] = np.ascontiguousarray(rows).tobytes()
                out[bi] = per
        return out
