"""The REGEN storage class of the port (ops/rs_regen.py,
erasure/regen/codec.py) held byte for byte to the JAX package: the
product-matrix MBR geometry and matrices, the repair-by-transfer plan,
the stripe packing, and RegenErasure's encode, decode and re-encode at
4+2, 6+3 and 12+4 -- on the kernel lane (K1's plain version, the
``torch-cpu`` lane) and on the host lanes (native, numpy) -- against the
JAX RegenErasure (``backend="cpu"``) and the JAX ``apply_regen`` with its
jit lane forced. Also ``codec_for_algorithm`` for both xl.meta stamps and
the REGEN probe lanes of the autotuner."""

from __future__ import annotations

import itertools
from dataclasses import astuple

import numpy as np
import pytest

from minio_tpu.erasure.codec import codec_for_algorithm as ref_codec_for
from minio_tpu.erasure.regen.codec import RegenErasure as RefRegen
from minio_tpu.obs import kernprof as ref_kp
from minio_tpu.ops import autotune as ref_at
from minio_tpu.ops import rs_regen as ref_regen
from minio_tpu.faultinject import FAULTS as REF_FAULTS
from minio_tpu_torch.erasure.codec import (REGEN_ALGORITHM, Erasure,
                                           codec_for_algorithm)
from minio_tpu_torch.erasure.regen import RegenErasure
from minio_tpu_torch.faultinject import FAULTS
from minio_tpu_torch.obs import kernprof as kp
from minio_tpu_torch.ops import autotune as at
from minio_tpu_torch.ops import batching, rs_regen

GEOMETRIES = [(2, 2), (3, 3), (4, 2), (6, 3), (12, 4), (16, 4)]
CODEC_GEOMETRIES = [(4, 2), (6, 3), (12, 4)]
LANES = [kp.TORCH_CPU, kp.NATIVE, kp.HOST]


@pytest.fixture(autouse=True)
def _cpu_dispatch():
    batching.set_dispatch_device("cpu")
    for prof in (kp.KERNPROF, ref_kp.KERNPROF):
        prof.reset()
    at.AUTOTUNE.reset()
    ref_at.AUTOTUNE.reset()
    yield
    FAULTS.clear()
    REF_FAULTS.clear()
    for prof in (kp.KERNPROF, ref_kp.KERNPROF):
        prof.reset()
    at.AUTOTUNE.reset()
    ref_at.AUTOTUNE.reset()
    batching.set_dispatch_device("cuda")


def _codec(k, m, lane, monkeypatch, block_size=4096):
    """A port RegenErasure whose every apply runs on `lane`: the kernel
    lane pinned (backend="cpu"), or "auto" with the plan on a host
    lane."""
    if lane == kp.TORCH_CPU:
        return RegenErasure(k, m, block_size=block_size, backend="cpu")
    monkeypatch.setattr(at.AUTOTUNE, "decide", lambda *a: lane)
    return RegenErasure(k, m, block_size=block_size, backend="auto",
                        device="cpu")


# ---------------------------------------------------------------------------
# host math


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_geometry_and_matrices_match_jax(k, m):
    assert astuple(rs_regen.geometry(k, m)) == \
        astuple(ref_regen.geometry(k, m))
    assert rs_regen.basis_positions(k, m) == ref_regen.basis_positions(k, m)
    assert np.array_equal(rs_regen.node_generators(k, m),
                          ref_regen.node_generators(k, m))
    assert np.array_equal(rs_regen.encode_matrix_regen(k, m),
                          ref_regen.encode_matrix_regen(k, m))
    assert np.array_equal(rs_regen.encode_bitplane(k, m),
                          ref_regen.encode_bitplane(k, m))
    w = np.arange(rs_regen.geometry(k, m).B, dtype=np.uint8)
    assert np.array_equal(rs_regen.message_matrix(k, m, w),
                          ref_regen.message_matrix(k, m, w))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_repair_rows_match_jax(k, m):
    for failed in range(k + m):
        assert rs_regen.repair_rows(k, m, failed) == \
            ref_regen.repair_rows(k, m, failed)
    with pytest.raises(ValueError):
        rs_regen.repair_rows(k, m, k + m)


@pytest.mark.parametrize("k,m", CODEC_GEOMETRIES)
def test_decode_plans_match_jax(k, m):
    n = k + m
    rng = np.random.default_rng(k)
    for _ in range(6):
        nodes = tuple(sorted(rng.choice(n, size=k, replace=False).tolist()))
        picks, inv = rs_regen.decode_plan(k, m, nodes)
        ref_picks, ref_inv = ref_regen.decode_plan(k, m, nodes)
        assert picks == ref_picks and np.array_equal(inv, ref_inv)
        assert np.array_equal(rs_regen.decode_bitplane(k, m, nodes),
                              ref_regen.decode_bitplane(k, m, nodes))


def test_stripe_packing_matches_jax():
    rng = np.random.default_rng(2)
    for k, m in CODEC_GEOMETRIES:
        for L in (1, 13, 114, 1000):
            data = rng.integers(0, 256, L).astype(np.uint8)
            W = rs_regen.pack_block(k, m, data)
            assert np.array_equal(W, ref_regen.pack_block(k, m, data))
            assert rs_regen.unpack_block(W, L) == data.tobytes()
            assert rs_regen.stripe_count(k, m, L) == \
                ref_regen.stripe_count(k, m, L)
        blocks = rng.integers(0, 256, (3, 500)).astype(np.uint8)
        assert np.array_equal(rs_regen.pack_blocks_batch(k, m, blocks),
                              ref_regen.pack_blocks_batch(k, m, blocks))


# ---------------------------------------------------------------------------
# RegenErasure


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("k,m", CODEC_GEOMETRIES)
def test_regen_codec_matches_jax(k, m, lane, monkeypatch):
    """Encode (one block, and a batch of full blocks), decode with the
    most losses the layout tolerates, and re-encode of lost nodes: every
    byte equals the JAX RegenErasure's, and every apply ran on `lane`."""
    bs = 4096
    port = _codec(k, m, lane, monkeypatch, bs)
    ref = RefRegen(k, m, block_size=bs, backend="cpu")
    n = k + m
    rng = np.random.default_rng(k * 7 + m)
    tail = rng.integers(0, 256, 1500).astype(np.uint8)
    chunks = port.encode_data(tail)
    assert np.array_equal(chunks, ref.encode_data(tail))
    full = rng.integers(0, 256, (3, bs)).astype(np.uint8)
    sm = port.encode_blocks_batch_bytes(full)
    assert np.array_equal(sm, ref.encode_blocks_batch_bytes(full))
    lost = set(range(1, 1 + m))
    blocks = [[None if j in lost else sm[j, b] for j in range(n)]
              for b in range(3)]
    blocks.append([None if j in lost else chunks[j] for j in range(n)])
    lens = [bs] * 3 + [len(tail)]
    got = port.decode_blocks_batch(blocks, lens)
    assert got == ref.decode_blocks_batch(blocks, lens)
    assert got[:3] == [full[b].tobytes() for b in range(3)]
    assert got[3] == tail.tobytes()
    missing = sorted(lost)
    re = port.reencode_missing_batch(blocks, lens, missing)
    assert re == ref.reencode_missing_batch(blocks, lens, missing)
    assert all(re[b][f] == sm[f, b].tobytes() for b in range(3)
               for f in missing)
    mix = kp.KERNPROF.mix_snapshot()
    assert mix[lane]["dispatches"] == sum(
        v["dispatches"] for v in mix.values()) > 0


@pytest.mark.parametrize("k,m", CODEC_GEOMETRIES)
def test_kernel_lane_matches_jax_jit_lane(k, m):
    """apply_regen on the port's kernel lane (K1's plain version, on the
    CPU dispatch device) against the JAX apply_regen with its jit lane
    forced, for the encode matrix and a decode matrix."""
    g = rs_regen.geometry(k, m)
    W = np.random.default_rng(5).integers(0, 256, (g.B, 97)).astype(
        np.uint8)
    mat = rs_regen.encode_matrix_regen(k, m)
    got = rs_regen.apply_regen(mat, W, use_device=lambda n: True)
    want = ref_regen.apply_regen(mat, W, use_device=lambda n: True)
    assert np.array_equal(got, want)
    nodes = tuple(range(m, k + m))
    picks, inv = rs_regen.decode_plan(k, m, nodes)
    sel = got[[i * g.d + r for i, r in picks]]
    back = rs_regen.apply_regen(inv, sel, use_device=lambda n: True)
    assert np.array_equal(back, ref_regen.apply_regen(
        inv, sel, use_device=lambda n: True))
    assert np.array_equal(back, W)
    assert kp.KERNPROF.mix_snapshot()[kp.TORCH_CPU]["dispatches"] == 2
    assert ref_kp.KERNPROF.mix_snapshot()[ref_kp.XLA_CPU]["dispatches"] == 2


@pytest.mark.parametrize("k,m", [(4, 2), (3, 3)])
def test_decode_every_erasure_pattern(k, m):
    n = k + m
    data = np.random.default_rng(k * 10 + m).integers(
        0, 256, 501, dtype=np.uint8).tobytes()
    port = RegenErasure(k, m, block_size=1024, backend="cpu")
    ref = RefRegen(k, m, block_size=1024, backend="cpu")
    chunks = port.encode_data(data)
    for nlost in range(m + 1):
        for lost in itertools.combinations(range(n), nlost):
            shards = [None if i in lost else chunks[i] for i in range(n)]
            assert port.decode_blocks_batch([shards], [len(data)]) == \
                ref.decode_blocks_batch([shards], [len(data)]) == [data]
    with pytest.raises(batching.ReconstructError):
        port.decode_blocks_batch([[chunks[0]] + [None] * (n - 1)],
                                 [len(data)])


@pytest.mark.parametrize("k,m", CODEC_GEOMETRIES)
def test_repair_by_transfer_rebuilds_every_node(k, m):
    """The d helper symbols the plan names ARE the lost node's chunk."""
    data = np.random.default_rng(3 * k + m).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    codec = RegenErasure(k, m, block_size=4096, backend="cpu")
    chunks = codec.encode_data(data)
    nst = codec.stripe_count(len(data))
    for failed in range(k + m):
        rebuilt = bytearray(codec.chunk_size(len(data)))
        for helper, helper_row, dest_row in rs_regen.repair_rows(k, m,
                                                                 failed):
            rebuilt[dest_row * nst:(dest_row + 1) * nst] = chunks[helper][
                helper_row * nst:(helper_row + 1) * nst].tobytes()
        assert bytes(rebuilt) == chunks[failed].tobytes()


def test_shard_sizes_match_jax():
    for k, m in CODEC_GEOMETRIES:
        port = RegenErasure(k, m, block_size=8192, backend="cpu")
        ref = RefRegen(k, m, block_size=8192, backend="cpu")
        assert port.shard_size() == ref.shard_size()
        for total in (0, 1, 8191, 8192, 3 * 8192 + 100):
            assert port.shard_file_size(total) == ref.shard_file_size(total)
            assert port.shard_file_offset(0, total, max(total, 1)) == \
                ref.shard_file_offset(0, total, max(total, 1))
            assert port.chunk_size(total) == ref.chunk_size(total)


@pytest.mark.parametrize("stamp", [REGEN_ALGORITHM, "rs-vandermonde", None])
def test_codec_for_algorithm_matches_jax(stamp):
    from minio_tpu.storage.metadata import REGEN_ALGORITHM as REF_REGEN
    assert REGEN_ALGORITHM == REF_REGEN
    port = codec_for_algorithm(stamp, 12, 4, 1 << 20, backend="cpu")
    ref = ref_codec_for(stamp, 12, 4, 1 << 20, backend="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert isinstance(port, RegenErasure if stamp == REGEN_ALGORITHM
                      else Erasure)
    assert port.total_shards == ref.total_shards
    assert port.shard_size() == ref.shard_size()
    for total in (0, 5, (1 << 20) + 7, 259 << 20):
        assert port.shard_file_size(total) == ref.shard_file_size(total)
    data = np.random.default_rng(8).integers(0, 256, 70_000).astype(
        np.uint8)
    assert np.array_equal(port.encode_data(data), ref.encode_data(data))


def test_regen_fault_fails_over_like_jax():
    """A `kernel` fault on regen_code: under "auto" the apply fails over
    to the host lanes byte-exact and the kernel lane degrades, as in the
    JAX package; a pinned codec raises."""
    plan = {"rules": [{"kind": "kernel", "target": "regen_code"}]}
    FAULTS.load_plan(plan)
    REF_FAULTS.load_plan(plan)
    data = np.random.default_rng(4).integers(0, 256, 2000).astype(np.uint8)
    port = RegenErasure(4, 2, block_size=4096, backend="auto",
                        device="cpu")
    port._use_device = lambda n: True
    ref = RefRegen(4, 2, block_size=4096, backend="auto")
    ref._use_tpu = lambda n: True
    assert np.array_equal(port.encode_data(data), ref.encode_data(data))
    assert kp.KERNPROF.state_of(kp.TORCH_CPU) == \
        ref_kp.KERNPROF.state_of(ref_kp.XLA_CPU) == kp.DEGRADED
    with pytest.raises(Exception, match="injected"):
        RegenErasure(4, 2, block_size=4096, backend="cpu").encode_data(data)


@pytest.mark.parametrize("lane", LANES)
def test_regen_probe_lane_matches_jax(lane):
    ref_lane = {kp.TORCH_CPU: ref_kp.XLA_CPU, kp.NATIVE: ref_kp.NATIVE,
                kp.HOST: ref_kp.HOST}[lane]
    bps, err = rs_regen.probe_lane(lane, 4096)
    ref_bps, ref_err = ref_regen.probe_lane(ref_lane, 4096)
    assert (bps is not None, err) == (ref_bps is not None, ref_err) == \
        (True, "")
    FAULTS.load_plan({"rules": [{"kind": "kernel", "target": ""}]})
    bps, err = rs_regen.probe_lane(lane, 256)
    assert bps is None and "injected" in err
