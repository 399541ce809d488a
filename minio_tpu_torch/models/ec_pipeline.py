"""The flagship data-plane pipeline: the erasure-code step on the card.

Port of minio_tpu/models/ec_pipeline.py. A declarative EC configuration
(k data + m parity, shard size) drives the hot path that a PutObject /
GetObject / heal dispatches to (ref call stacks: cmd/erasure-object.go:582
encode, :240 decode, cmd/erasure-healing.go:224 heal). The reference's
jitted chain becomes eager launches of the GF kernel:

forward step  = encode:      (B, k, S) data shards   -> (B, k+m, S)
reconstruct   = decode:      (B, k, S) survivors     -> (B, r, S) rebuilt
verify        = mismatch count between rebuilt and original data.

``full_step_sharded`` is the reference's multi-chip step (rs_pallas.py
``encode_blocks_sharded`` / ``gf_apply_sharded`` under the shardings of
``dryrun_multichip``): the batch splits over a mesh of devices (B over
'blocks', S over 'lanes', parallel/mesh.py), each device launches K1 on
its own tile, and the mismatch counts are summed. No collectives.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..ops import _cuda, rs_gpu
from ..utils import ceil_frac

# Reference stripe block: 10 MiB (ref cmd/object-api-common.go:32).
DEFAULT_BLOCK_SIZE = 10 * 1024 * 1024


@dataclass(frozen=True)
class ECConfig:
    data_shards: int
    parity_shards: int
    block_size: int = DEFAULT_BLOCK_SIZE

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    @property
    def shard_size(self) -> int:
        """Per-shard bytes of one full stripe block (ref ShardSize,
        cmd/erasure-coding.go:115)."""
        return ceil_frac(self.block_size, self.data_shards)


class ECPipeline:
    """Erasure pipeline for one EC geometry on one device."""

    def __init__(self, config: ECConfig, device="cuda"):
        self.config = config
        self.device = _cuda.resolve_device(device)

    @cached_property
    def parity_bitplane(self) -> rs_gpu.BitMatrix:
        return rs_gpu.placed_parity(self.config.data_shards,
                                    self.config.parity_shards, self.device)

    def encode(self, data) -> torch.Tensor:
        """(B, k, S) uint8 tensor or array -> (B, k+m, S) on the device."""
        if not isinstance(data, torch.Tensor):
            data = _cuda.to_device(data, self.device)
        return rs_gpu.encode_blocks(self.parity_bitplane,
                                    data.to(self.device))

    def reconstruct(self, survivors, available: tuple[int, ...],
                    missing: tuple[int, ...]) -> torch.Tensor:
        """(B, k, S) survivors (the first k available) -> (B, r, S)."""
        bm, used = rs_gpu.placed_decode(
            self.config.data_shards, self.config.parity_shards,
            tuple(available), tuple(missing), self.device)
        if not isinstance(survivors, torch.Tensor):
            survivors = _cuda.to_device(survivors, self.device)
        if survivors.shape[-2] != len(used):
            raise ValueError(f"expected {len(used)} survivor shards, got "
                             f"{survivors.shape[-2]}")
        return rs_gpu.gf_apply(bm, survivors.to(self.device))

    def example_args(self, batch: int = 4, shard_size: int = 4096,
                     seed: int = 0,
                     ) -> tuple[rs_gpu.BitMatrix, torch.Tensor]:
        rng = np.random.default_rng(seed)
        data = rng.integers(
            0, 256, (batch, self.config.data_shards, shard_size),
        ).astype(np.uint8)
        return self.parity_bitplane, _cuda.to_device(data, self.device)


def full_step(big_enc, big_dec, data: torch.Tensor,
              survivor_idx: torch.Tensor) -> dict:
    """One full data-plane step on data's device: encode -> simulated
    shard loss -> reconstruct -> verify.

    survivor_idx: (k,) int64 indices of surviving shards. Returns the
    shards, the rebuilt data shards and the count of mismatched bytes."""
    shards = rs_gpu.encode_blocks(big_enc, data)
    survivors = shards.index_select(-2, survivor_idx.to(data.device))
    rebuilt = rs_gpu.gf_apply(big_dec, survivors)
    mismatch = torch.sum(rebuilt != data)
    return {"shards": shards, "rebuilt": rebuilt, "mismatch": mismatch}


def make_full_step_inputs(config: ECConfig, batch: int, shard_size: int,
                          missing: tuple[int, ...], seed: int = 0,
                          device="cuda"):
    """Host-side prep for full_step: matrices + data + survivor indices,
    on ``device``. The data bytes equal the reference's for the same
    seed (numpy generator).

    `missing` are data-shard indices knocked out; the decode matrix
    rebuilds every data shard from the first-k survivors (klauspost
    ReconstructData order — see rs_matrix.decode_matrix)."""
    dev = _cuda.resolve_device(device)
    k, m = config.data_shards, config.parity_shards
    available = tuple(i for i in range(k + m) if i not in missing)
    dec_all, used = rs_gpu.placed_decode(k, m, available, tuple(range(k)),
                                         dev)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (batch, k, shard_size)).astype(np.uint8)
    return (rs_gpu.placed_parity(k, m, dev), dec_all,
            _cuda.to_device(data, dev),
            torch.tensor(used, dtype=torch.int64, device=dev))


def full_step_sharded(devices, big_enc, big_dec, data,
                      survivor_idx) -> dict:
    """full_step with the (B, k, S) batch split over a mesh of
    ``devices`` (torch devices, or "cpu" repeated for virtual ones): B
    over 'blocks' and S over 'lanes' where they divide, as the
    reference's block sharding. Each tile's encode, survivor gather and
    decode run on its device; the mismatch is the sum over tiles.

    big_enc, big_dec: bit-plane matrices (BitMatrix, tensor or array);
    data: (B, k, S) uint8 array or tensor; survivor_idx: (k,) indices.
    Returns shards and rebuilt assembled on the first device."""
    from ..parallel.mesh import batch_placement, make_mesh
    devs = [_cuda.resolve_device(d) for d in devices]
    mesh = make_mesh(devs)
    host = data.cpu().numpy() if isinstance(data, torch.Tensor) \
        else np.asarray(data, dtype=np.uint8)
    idx = np.asarray(survivor_idx.cpu() if isinstance(
        survivor_idx, torch.Tensor) else survivor_idx, dtype=np.int64)
    B, k, S = host.shape
    parts = []
    for di, bs, ss in batch_placement(mesh, B, S)[0].tiles:
        dev = devs[di]
        out = full_step(rs_gpu.as_bitmatrix(big_enc, dev),
                        rs_gpu.as_bitmatrix(big_dec, dev),
                        _cuda.to_device(host[bs, :, ss], dev),
                        torch.from_numpy(idx).to(dev))
        parts.append((bs, ss, out))
    home = devs[0]
    shards = torch.empty((B, parts[0][2]["shards"].shape[1], S),
                         dtype=torch.uint8, device=home)
    rebuilt = torch.empty((B, parts[0][2]["rebuilt"].shape[1], S),
                          dtype=torch.uint8, device=home)
    mismatch = torch.zeros((), dtype=torch.int64, device=home)
    for bs, ss, out in parts:
        shards[bs, :, ss] = out["shards"].to(home)
        rebuilt[bs, :, ss] = out["rebuilt"].to(home)
        mismatch += out["mismatch"].to(home)
    return {"shards": shards, "rebuilt": rebuilt, "mismatch": mismatch}
