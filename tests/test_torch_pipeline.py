"""The slice as a whole: the port's Erasure codec and flagship pipeline
held to the JAX package (Erasure(backend="tpu") and full_step, on the JAX
CPU platform), state carried across through minio_tpu_torch.interop, and
the package's rules (no JAX imports, the card unless the CPU is asked
for)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from minio_tpu.erasure.codec import Erasure as RefErasure
from minio_tpu.models import ec_pipeline as ref_pipeline
from minio_tpu.ops import rs_tpu
from minio_tpu_torch import interop
from minio_tpu_torch.erasure import bitrot
from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.models import ec_pipeline
from minio_tpu_torch.ops import batching, rs_gpu

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 64 * 1024


def _object_blocks(k: int, size: int, seed: int):
    """(full (B, k, S) pre-split blocks, tail bytes) as the engine cuts
    an object of `size` bytes into BLOCK-sized stripes."""
    payload = np.random.default_rng(seed).integers(0, 256, size).astype(
        np.uint8)
    S = -(-BLOCK // k)
    nfull = size // BLOCK
    full = np.zeros((nfull, k * S), np.uint8)
    full[:, :BLOCK] = payload[:nfull * BLOCK].reshape(nfull, BLOCK)
    return payload, full.reshape(nfull, k, S), payload[nfull * BLOCK:]


@pytest.mark.parametrize("k,m", [(8, 4), (12, 4)])
def test_erasure_cpu_equals_jax(k, m):
    payload, full, tail = _object_blocks(k, 3 * BLOCK + 5000, seed=k)
    port = Erasure(k, m, block_size=BLOCK, backend="cpu")
    ref = RefErasure(k, m, block_size=BLOCK, backend="tpu")
    assert port.shard_size() == ref.shard_size()
    assert port.shard_file_size(len(payload)) == \
        ref.shard_file_size(len(payload))
    assert port.shard_file_offset(BLOCK, 100, len(payload)) == \
        ref.shard_file_offset(BLOCK, 100, len(payload))

    enc = port.encode_blocks_batch(full)
    assert np.array_equal(enc, ref.encode_blocks_batch(full))
    sm = port.encode_blocks_batch_shardmajor(full)
    assert np.array_equal(sm, ref.encode_blocks_batch_shardmajor(full))
    tail_shards = port.encode_data(tail.tobytes())
    assert np.array_equal(tail_shards, ref.encode_data(tail.tobytes()))

    lost = (0, 5, k + 1)
    blocks = [[None if j in lost else enc[b, j] for j in range(k + m)]
              for b in range(enc.shape[0])]
    blocks.append([None if j in lost else tail_shards[j]
                   for j in range(k + m)])
    got = port.decode_data_blocks_batch(blocks)
    want = ref.decode_data_blocks_batch(blocks)
    got_all = port.decode_all_blocks_batch(blocks)
    want_all = ref.decode_all_blocks_batch(blocks)
    for b in range(len(blocks)):
        for j in range(k):
            assert np.array_equal(got[b][j], want[b][j]), (b, j)
        for j in range(k + m):
            assert np.array_equal(got_all[b][j], want_all[b][j]), (b, j)
    rejoined = b"".join(got[b][j].tobytes() for b in range(len(blocks) - 1)
                        for j in range(k))
    # Full blocks carry BLOCK payload bytes each (plus split padding).
    data = b"".join(rejoined[i * k * full.shape[2]:][:BLOCK]
                    for i in range(full.shape[0]))
    data += b"".join(got[-1][j].tobytes() for j in range(k))[:len(tail)]
    assert data == payload.tobytes()
    assert got_all[0][k + 1].tobytes() == enc[0, k + 1].tobytes()


def test_reconstruct_groups_one_dispatch_per_mask():
    k, m = 4, 2
    port = Erasure(k, m, block_size=4096, backend="cpu")
    rng = np.random.default_rng(5)
    enc = port.encode_blocks_batch(
        rng.integers(0, 256, (5, k, 1024)).astype(np.uint8))
    blocks = [[None if j == 1 else enc[b, j] for j in range(k + m)]
              for b in range(5)]
    batching.STATS.reset()
    port.decode_data_blocks_batch(blocks)
    snap = batching.STATS.snapshot()
    assert snap["tpu_dispatches"] == 1 and snap["coalesced_requests"] == 5
    with pytest.raises(batching.ReconstructError):
        port.decode_data_blocks([None, None, None, enc[0, 3], enc[0, 4],
                                 None])


def test_full_step_on_jax_inputs():
    cfg = ref_pipeline.ECConfig(8, 4)
    big_enc, big_dec, data, used = ref_pipeline.make_full_step_inputs(
        cfg, batch=3, shard_size=4096 + 3, missing=(0, 3), seed=1)
    ref_out = ref_pipeline.full_step(big_enc, big_dec, data, used)
    enc, dec, idx = interop.matrices_from_numpy(
        np.asarray(big_enc), np.asarray(big_dec), np.asarray(used),
        device="cpu")
    out = ec_pipeline.full_step(enc, dec, torch.from_numpy(np.array(data)),
                                idx)
    assert int(out["mismatch"]) == 0 == int(ref_out["mismatch"])
    assert np.array_equal(out["shards"].numpy(), np.asarray(ref_out["shards"]))
    assert np.array_equal(out["rebuilt"].numpy(),
                          np.asarray(ref_out["rebuilt"]))
    # The port's own inputs are the same bytes for the same seed.
    p_enc, p_dec, p_data, p_used = ec_pipeline.make_full_step_inputs(
        ec_pipeline.ECConfig(8, 4), batch=3, shard_size=4096 + 3,
        missing=(0, 3), seed=1, device="cpu")
    assert np.array_equal(p_data.numpy(), np.asarray(data))
    assert np.array_equal(p_used.numpy(), np.asarray(used))
    assert np.array_equal(p_dec.dense.numpy(), np.asarray(big_dec))
    assert np.array_equal(p_enc.packed.numpy(), enc.packed.numpy())


def test_pipeline_encode_and_reconstruct():
    pipe = ec_pipeline.ECPipeline(ec_pipeline.ECConfig(4, 2), device="cpu")
    bm, data = pipe.example_args(batch=2, shard_size=300, seed=3)
    ref_pipe = ref_pipeline.ECPipeline(ref_pipeline.ECConfig(4, 2))
    _, ref_data = ref_pipe.example_args(batch=2, shard_size=300, seed=3)
    assert np.array_equal(data.numpy(), np.asarray(ref_data))
    shards = pipe.encode(data)
    assert np.array_equal(shards.numpy(), ref_pipe.encode(np.asarray(data)))
    avail = (1, 2, 4, 5)
    got = pipe.reconstruct(shards[:, [1, 2, 4, 5]], avail, (0, 3))
    assert np.array_equal(got.numpy(), shards[:, [0, 3]].numpy())
    assert np.array_equal(got.numpy(), rs_tpu.reconstruct_batch(
        shards[:, [1, 2, 4, 5]].numpy(), 4, 2, avail, (0, 3)))


def test_jax_shard_files_decode_in_port():
    """A PUT framed by the JAX package, two shards lost: the port
    verifies the survivors' frames and rebuilds the object."""
    from minio_tpu.erasure import bitrot as ref_bitrot
    k, m = 4, 2
    payload, full, tail = _object_blocks(k, 2 * BLOCK + 777, seed=9)
    ref = RefErasure(k, m, block_size=BLOCK, backend="tpu")
    sm = ref.encode_blocks_batch_shardmajor(full)
    tails = ref.encode_data(tail.tobytes())
    files = [np.concatenate([f, np.frombuffer(t, np.uint8)]) for f, t in zip(
        ref_bitrot.encode_stream_arrays(list(sm)),
        ref_bitrot.encode_streams([tails[j].tobytes()
                                   for j in range(k + m)], full.shape[2]))]
    files[1] = files[4] = None
    blocks, hashes = interop.shards_from_numpy(files, full.shape[2])
    datas = [d for row in blocks for d in row if d is not None]
    wants = [h for row in hashes for h in row if h is not None]
    assert all(bitrot.verify_frames(datas, wants, device="cpu"))
    port = Erasure(k, m, block_size=BLOCK, backend="cpu")
    fixed = port.decode_data_blocks_batch(blocks)
    out = b"".join(b"".join(fixed[b][j].tobytes()
                            for j in range(k))[:BLOCK]
                   for b in range(2))
    out += b"".join(fixed[2][j].tobytes() for j in range(k))[:len(tail)]
    assert out == payload.tobytes()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((1, 4, 8), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Erasure(4, 2)
    with pytest.raises(RuntimeError):
        rs_gpu.encode_batch(data, 4, 2)
    with pytest.raises(RuntimeError):
        bitrot.digest(bitrot.DEFAULT_ALGORITHM, b"abc")
    with pytest.raises(RuntimeError):
        bitrot.encode_stream_arrays([data[0]])
    with pytest.raises(RuntimeError):
        ec_pipeline.ECPipeline(ec_pipeline.ECConfig(4, 2))
    with pytest.raises(RuntimeError):
        ec_pipeline.make_full_step_inputs(ec_pipeline.ECConfig(4, 2), 1, 8,
                                          (0,))
    with pytest.raises(RuntimeError):
        interop.matrices_from_numpy(rs_tpu.parity_bitplane(4, 2),
                                    rs_tpu.parity_bitplane(4, 2), [0])
    with pytest.raises(NotImplementedError, match="autotune"):
        Erasure(4, 2, backend="auto")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_no_jax():
    files = sorted((ROOT / "minio_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "minio_tpu"), (f, name)
