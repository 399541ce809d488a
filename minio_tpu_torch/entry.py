"""Entry points of the port: the flagship step, and a dry run of the full
data-plane step split over n devices.

The port's counterparts of the repository's ``__graft_entry__.entry``
and ``dryrun_multichip``, on PyTorch: ``entry`` returns the 8+4
erasure-encode step (kernel K1) with example arguments on ``device``;
``dryrun_multichip`` runs ONE full step (encode -> shard loss ->
reconstruct -> verify) with B over 'blocks' and S over 'lanes' of an
n-device mesh (models/ec_pipeline.py ``full_step_sharded``), on tiny
shapes, and raises on any mismatch. Both run on the card unless the
caller passes ``device="cpu"`` (n virtual CPU devices for the dry run).

    python -m minio_tpu_torch.entry [n_devices] [cuda|cpu]
"""

from __future__ import annotations

import sys


def entry(device="cuda"):
    """(fn, example_args): the 8+4 erasure-encode step on ``device``."""
    from .models.ec_pipeline import ECConfig, ECPipeline

    pipe = ECPipeline(ECConfig(data_shards=8, parity_shards=4),
                      device=device)
    return pipe.encode, pipe.example_args(batch=4, shard_size=4096)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full data-plane step over an n-device mesh with real
    block/lane splits on tiny shapes; returns full_step_sharded's dict.
    ``device="cuda"`` needs n cards; ``"cpu"`` uses n virtual devices."""
    import torch

    from .models.ec_pipeline import (ECConfig, full_step_sharded,
                                     make_full_step_inputs)
    from .ops import _cuda
    from .parallel.mesh import make_mesh

    kind = torch.device(device).type
    if kind == "cuda":
        _cuda.resolve_device("cuda")
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [torch.device("cpu")] * n_devices
    config = ECConfig(data_shards=8, parity_shards=4, block_size=8 * 1024)
    mesh = make_mesh(devices)
    # Tiny shapes, real splits: the batch over 'blocks', the shard bytes
    # over 'lanes'.
    batch = 2 * mesh.shape["blocks"]
    shard_size = 256 * mesh.shape["lanes"]
    enc, dec, data, used = make_full_step_inputs(
        config, batch=batch, shard_size=shard_size, missing=(0, 3),
        device="cpu")
    out = full_step_sharded(devices, enc, dec, data, used)
    mismatch = int(out["mismatch"])
    if mismatch != 0:
        raise RuntimeError(f"reconstruct mismatch: {mismatch} bytes differ")
    if tuple(out["shards"].shape) != (batch, config.total_shards,
                                      shard_size):
        raise RuntimeError(f"shards shape {tuple(out['shards'].shape)}")
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    fn, args = entry(dev)
    print("entry step:", tuple(fn(args[1]).shape))
    dryrun_multichip(n, dev)
    print(f"dryrun_multichip({n}, {dev!r}) OK")
