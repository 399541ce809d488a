"""Erasure codec orchestration: the reference's `Erasure` struct over the
port's batched GF kernel.

Port of minio_tpu/erasure/codec.py. Size semantics are byte-compatible
with the reference (ref cmd/erasure-coding.go:115-143 ShardSize /
ShardFileSize / ShardFileOffset and the Split padding of its codec
dependency): objects are striped into `block_size` blocks; each block
splits into k shards of ceil(block/k) bytes (zero-padded) plus m parity
shards. Shards go in and come out as numpy arrays, as in the reference.

Backends:

- ``"gpu"`` (the default) pins every dispatch to kernel K1 on the card;
  errors propagate -- the counterpart of the reference's pinned ``"tpu"``.
- ``"cpu"`` pins every dispatch to K1's plain PyTorch version.
- ``"auto"`` asks the measured plan (ops/autotune.py) per dispatch: the
  kernel lane on ``device`` (the card; or the ``torch-cpu`` lane with
  ``device="cpu"``), the C++ ``native`` lane or the numpy ``host`` lane;
  PUT encodes go through the cross-request coalescer while the plan
  still sends encode work to a card. ``device`` defaults to the process
  dispatch device (ops/batching.py ``set_dispatch_device``); without a
  card and without ``device="cpu"`` it raises ``AutoUnavailable``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import _cuda, batching, rs_cpu
from ..ops.autotune import AUTOTUNE, RS_DECODE, RS_ENCODE
from ..utils import ceil_frac

# Default stripe block: 10 MiB (ref cmd/object-api-common.go:32).
BLOCK_SIZE = 10 * 1024 * 1024

BACKENDS = ("gpu", "cpu", "auto")

# The xl.meta erasure algorithm stamp of the regenerating-code storage
# class (the port's own copy of minio_tpu/storage/metadata.py's).
REGEN_ALGORITHM = "pm-mbr-rbt"


class AutoUnavailable(NotImplementedError):
    """``backend="auto"`` plans over the lanes of a device, and the
    dispatch device is the card while none is present. The port
    implements no CPU default for "auto": pass ``device="cpu"`` (or set
    ``batching.set_dispatch_device("cpu")``) to plan over the CPU lanes.
    A NotImplementedError, so also a RuntimeError."""


def codec_device(backend: str, device=None) -> torch.device:
    """The device a codec's kernel lane runs on, resolved (raising
    without a card) from its backend and an explicit ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        if device is None:
            try:
                return batching.dispatch_device()
            except RuntimeError as exc:
                raise AutoUnavailable(
                    "backend='auto' runs the autotuned dispatch plan over "
                    "the lanes of the card, and no CUDA device is "
                    "available; pass device='cpu' to plan over the CPU "
                    "lanes") from exc
        return _cuda.resolve_device(device)
    want = "cuda" if backend == "gpu" else "cpu"
    dev = torch.device(device if device is not None else want)
    if dev.type != want:
        raise ValueError(f"backend={backend!r} runs on {want}, not {dev}")
    return _cuda.resolve_device(dev)


@dataclass
class Erasure:
    data_blocks: int
    parity_blocks: int
    block_size: int = BLOCK_SIZE
    backend: str = "gpu"  # "gpu" | "cpu" | "auto"
    # Home device of the owning erasure set (parallel/mesh.py
    # DeviceAffinity): concurrent sets' dispatches spread across the
    # mesh instead of queueing on device 0.
    affinity: int | None = field(default=None, repr=False)
    # Where the kernel lane runs (resolved in __post_init__).
    device: torch.device | str | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.data_blocks <= 0 or self.parity_blocks <= 0:
            raise ValueError("data and parity block counts must be positive")
        if self.data_blocks + self.parity_blocks > 256:
            raise ValueError("too many shards (k+m > 256)")
        self.device = codec_device(self.backend, self.device)

    # --- sizes (byte-compatible with the reference) ---

    @property
    def total_shards(self) -> int:
        return self.data_blocks + self.parity_blocks

    def shard_size(self) -> int:
        """Per-shard size of a full block (ref cmd/erasure-coding.go:115)."""
        return ceil_frac(self.block_size, self.data_blocks)

    def chunk_size(self, block_len: int) -> int:
        """Per-shard stored bytes for a block of block_len bytes."""
        return ceil_frac(block_len, self.data_blocks)

    def shard_file_size(self, total_length: int) -> int:
        """On-disk per-shard data size for an object of total_length bytes
        (ref cmd/erasure-coding.go:120)."""
        if total_length == 0:
            return 0
        if total_length < 0:
            return -1
        num_shards = total_length // self.block_size
        last_block_size = total_length % self.block_size
        last_shard_size = ceil_frac(last_block_size, self.data_blocks)
        return num_shards * self.shard_size() + last_shard_size

    def shard_file_offset(self, start_offset: int, length: int,
                          total_length: int) -> int:
        """Until-offset for shard reads covering [start, start+length)
        (ref cmd/erasure-coding.go:134)."""
        shard_size = self.shard_size()
        shard_file_size = self.shard_file_size(total_length)
        end_shard = (start_offset + length) // self.block_size
        till = end_shard * shard_size + shard_size
        return min(till, shard_file_size)

    # --- dispatch ---

    def _use_device(self, nbytes: int, kernel: str = RS_ENCODE) -> bool:
        """Route this batch through the kernel lane?  Pins always do;
        "auto" asks the measured plan, which never picks a kernprof-DOWN
        lane."""
        if self.backend != "auto":
            return True
        return AUTOTUNE.use_jit_lane(kernel, nbytes)

    def _use_device_decode(self, nbytes: int) -> bool:
        return self._use_device(nbytes, RS_DECODE)

    def _coalesce_ok(self) -> bool:
        """Route encodes through the cross-request coalescer? Only under
        "auto" on a card, while the plan still sends encode work to it --
        the window buys nothing (and costs its latency) in front of host
        encodes."""
        return (self.backend == "auto" and self.device.type == "cuda"
                and AUTOTUNE.coalesce_worthwhile())

    def _device_encode(self, blocks: np.ndarray,
                       shardmajor: bool = False) -> np.ndarray:
        out = batching.device_encode(
            blocks, self.data_blocks, self.parity_blocks,
            affinity=self.affinity, device=self.device,
            shardmajor=shardmajor)
        batching.STATS.add(self.device.type == "cuda", blocks.nbytes)
        return out

    # --- encode / decode ---

    def encode_data(self, data: bytes | np.ndarray) -> np.ndarray:
        """Encode one block: returns (k+m, shard_len) uint8
        (ref EncodeData, cmd/erasure-coding.go:70)."""
        buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else data
        if buf.size == 0:
            return np.zeros((self.total_shards, 0), dtype=np.uint8)
        k, m = self.data_blocks, self.parity_blocks
        shards = rs_cpu.split(buf, k, m)
        data_bytes = shards[:k].nbytes
        if self.backend != "auto":
            return self._device_encode(shards[None, :k])[0]
        if self._coalesce_ok():
            return batching.get_coalescer().encode(
                shards[None, :k], k, m, affinity=self.affinity)[0]
        if self._use_device(data_bytes):
            return self._device_encode(shards[None, :k])[0]
        return batching.host_encode(
            shards[None, :k], k, m,
            lane=AUTOTUNE.host_lane(RS_ENCODE, data_bytes))[0]

    def encode_blocks_batch(self, blocks: np.ndarray) -> np.ndarray:
        """Batched encode of (B, k, S) pre-split blocks -> (B, k+m, S),
        one dispatch for the whole batch (still coalescable under
        "auto")."""
        if self._use_device(blocks.nbytes):
            return self._device_encode(blocks)
        if self._coalesce_ok():
            return batching.get_coalescer().encode(
                blocks, self.data_blocks, self.parity_blocks,
                affinity=self.affinity)
        return batching.host_encode(
            blocks, self.data_blocks, self.parity_blocks,
            lane=AUTOTUNE.host_lane(RS_ENCODE, blocks.nbytes))

    def encode_blocks_batch_shardmajor(self, blocks: np.ndarray,
                                       ) -> np.ndarray:
        """Batched encode returning SHARD-MAJOR (k+m, B, S) contiguous --
        the layout the bitrot framer wants; the kernel lane and the host
        lanes write it directly, the coalescer path pays one transpose
        copy."""
        if self._use_device(blocks.nbytes):
            return self._device_encode(blocks, shardmajor=True)
        if self._coalesce_ok():
            encoded = self.encode_blocks_batch(blocks)
            return np.ascontiguousarray(encoded.transpose(1, 0, 2))
        return batching.host_encode_shardmajor(
            blocks, self.data_blocks, self.parity_blocks,
            lane=AUTOTUNE.host_lane(RS_ENCODE, blocks.nbytes))

    def decode_data_blocks(self, shards: list[np.ndarray | None],
                           ) -> list[np.ndarray]:
        """Reconstruct missing DATA shards in place of Nones
        (ref DecodeDataBlocks, cmd/erasure-coding.go:89)."""
        return self.decode_data_blocks_batch([shards])[0]

    def decode_all_blocks(self, shards: list[np.ndarray | None],
                          ) -> list[np.ndarray]:
        """Reconstruct ALL missing shards (heal path; ref
        DecodeDataAndParityBlocks, cmd/erasure-coding.go:106)."""
        return self.decode_all_blocks_batch([shards])[0]

    def decode_data_blocks_batch(self, blocks: list,
                                 ) -> list[list[np.ndarray]]:
        """Mask-grouped batched data reconstruct: blocks sharing an
        erasure signature collapse into one dispatch."""
        return self._reconstruct(blocks, want_all=False)

    def decode_all_blocks_batch(self, blocks: list,
                                ) -> list[list[np.ndarray]]:
        """Mask-grouped batched full reconstruct (heal): data and parity
        rebuilt by a single combined matrix per mask group."""
        return self._reconstruct(blocks, want_all=True)

    def _reconstruct(self, blocks: list, want_all: bool):
        return batching.reconstruct_blocks(
            blocks, self.data_blocks, self.parity_blocks,
            want_all=want_all, use_device=self._use_device_decode,
            device_fallback=self.backend == "auto",
            affinity=self.affinity, device=self.device)


def codec_for_algorithm(algorithm: str | None, data_blocks: int,
                        parity_blocks: int,
                        block_size: int = BLOCK_SIZE,
                        backend: str = "gpu",
                        affinity: int | None = None, device=None):
    """The codec for an xl.meta erasure algorithm stamp: plain RS
    (``rs-vandermonde``, the default and the value every pre-REGEN object
    carries) or the regenerating-code class (``pm-mbr-rbt``)."""
    if algorithm == REGEN_ALGORITHM:
        from .regen import RegenErasure
        return RegenErasure(data_blocks, parity_blocks, block_size,
                            backend=backend, affinity=affinity,
                            device=device)
    return Erasure(data_blocks, parity_blocks, block_size,
                   backend=backend, affinity=affinity, device=device)
