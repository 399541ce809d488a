"""The dispatch plane of the port held to the JAX package: placement over
several devices (parallel/mesh.py), the encode coalescer and mask-grouped
reconstruct (ops/batching.py), the per-lane health machine
(obs/kernprof.py), the measured planner (ops/autotune.py), the "auto"
backend of the codec and of bitrot, the select lane choice, and the
multi-device ``full_step``.

Both packages run here on the CPU: the JAX package on the 8 virtual XLA
devices of tests/conftest.py, the port with its dispatch device set to 8
virtual CPU devices (the plain PyTorch versions of the kernels, the
``torch-cpu`` lane, where the JAX package runs ``xla-cpu``). Every
comparison is byte-exact; lane names map xla-cpu <-> torch-cpu. No test
leaves a thread running: coalescers are stopped, the probe ladder runs in
the foreground, and a quorum pool a test created is shut down.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch

from minio_tpu.erasure import bitrot as ref_bitrot
from minio_tpu.erasure.codec import Erasure as RefErasure
from minio_tpu.faultinject import FAULTS as REF_FAULTS
from minio_tpu.models import ec_pipeline as ref_pipeline
from minio_tpu.obs import kernprof as ref_kp
from minio_tpu.obs.metrics2 import METRICS2 as REF_METRICS2
from minio_tpu.ops import autotune as ref_at
from minio_tpu.ops import batching as ref_batching
from minio_tpu.ops import rs_cpu
from minio_tpu.parallel import mesh as ref_mesh
from minio_tpu.parallel import quorum as ref_quorum
from minio_tpu_torch.erasure import bitrot
from minio_tpu_torch.erasure.codec import (AutoUnavailable, Erasure,
                                           codec_for_algorithm)
from minio_tpu_torch.faultinject import FAULTS
from minio_tpu_torch.models import ec_pipeline
from minio_tpu_torch.obs import kernprof as kp
from minio_tpu_torch.obs.metrics2 import METRICS2
from minio_tpu_torch.ops import autotune as at
from minio_tpu_torch.ops import batching
from minio_tpu_torch.parallel import mesh, quorum

LANE = {ref_kp.DEVICE: kp.DEVICE, ref_kp.NATIVE: kp.NATIVE,
        ref_kp.XLA_CPU: kp.TORCH_CPU, ref_kp.HOST: kp.HOST}
N_VIRTUAL = 8


def _reset_all():
    for prof in (kp.KERNPROF, ref_kp.KERNPROF):
        prof.reset()
    for tuner in (at.AUTOTUNE, ref_at.AUTOTUNE):
        tuner.reset()
    FAULTS.clear()
    REF_FAULTS.clear()
    mesh.MESH_AFFINITY.reset()
    ref_mesh.MESH_AFFINITY.reset()
    ref_batching.reset_serving_mesh()


def _virtual_devices(monkeypatch, n: int) -> None:
    """The port's census as n virtual CPU devices (the JAX package's
    tests run on virtual XLA CPU devices the same way)."""
    monkeypatch.setattr(batching, "device_list",
                        lambda: [torch.device("cpu")] * n)
    batching.set_dispatch_device("cpu")


@pytest.fixture(autouse=True)
def _dispatch_plane(monkeypatch):
    """Both packages on their 8 virtual CPU devices, fresh planner and
    health state; afterwards the port's dispatch device is the card
    again and any quorum pool this test created is shut down."""
    pools = (quorum._POOL, ref_quorum._POOL)
    _virtual_devices(monkeypatch, N_VIRTUAL)
    _reset_all()
    yield
    _reset_all()
    batching.set_dispatch_device("cuda")
    for mod, before in ((quorum, pools[0]), (ref_quorum, pools[1])):
        if before is None and mod._POOL is not None:
            mod._POOL.shutdown(wait=True)
            mod._POOL = None


def _encode_ref(data: np.ndarray, k: int, m: int) -> np.ndarray:
    """(B, k, S) -> (B, k+m, S) through the JAX package's host codec."""
    out = np.zeros((data.shape[0], k + m, data.shape[2]), np.uint8)
    for b in range(data.shape[0]):
        out[b, :k] = data[b]
        rs_cpu.encode(out[b], k, m)
    return out


# ---------------------------------------------------------------------------
# placement (parallel/mesh.py)

GRID_B = (1, 2, 3, 4, 6, 8, 16)
GRID_S = (1, 7, 8, 64, 100, 256)


def _jax_tiles(sharding, shape) -> set:
    """{(first device index, b0, b1, s0, s1)} of a JAX sharding: each
    distinct tile once, on the first device that holds it."""
    devs = jax.devices()
    first: dict[tuple, int] = {}
    for d, idx in sharding.devices_indices_map(shape).items():
        b, s = idx[0], idx[-1]
        key = (b.start or 0, shape[0] if b.stop is None else b.stop,
               s.start or 0, shape[-1] if s.stop is None else s.stop)
        first[key] = min(first.get(key, 99), devs.index(d))
    return {(di, *key) for key, di in first.items()}


def _port_tiles(placement, shape) -> set:
    out = set()
    for di, bs, ss in placement.tiles:
        b0, b1, _ = bs.indices(shape[0])
        s0, s1, _ = ss.indices(shape[-1])
        out.add((di, b0, b1, s0, s1))
    return out


@pytest.mark.parametrize("affinity", [None, 0, 3, 13])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_batch_placement_matches_jax(n, affinity):
    """Device-index tuples and each device's (batch, lane) slices equal
    the JAX sharding's, over a grid of (B, S), on n of 8 devices."""
    pm = mesh.make_mesh(batching.device_list(), n)
    rm = ref_mesh.make_mesh(n)
    assert pm.shape == dict(rm.shape)
    for B in GRID_B:
        for S in GRID_S:
            sh, ref_idx = ref_mesh.batch_placement(rm, B, S, affinity)
            placement, idx = mesh.batch_placement(pm, B, S, affinity)
            assert idx == ref_idx, (B, S)
            assert _port_tiles(placement, (B, 4, S)) == \
                _jax_tiles(sh, (B, 4, S)), (B, S)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_rows_sharding_matches_jax(n):
    pm = mesh.make_mesh(batching.device_list(), n)
    rm = ref_mesh.make_mesh(n)
    for B in (1, 2, 3, 4, 8, 12, 16, 24):
        want = _jax_tiles(ref_mesh.rows_sharding(rm, B, 2), (B, 64))
        got = _port_tiles(mesh.rows_sharding(pm, B), (B, 64))
        assert got == want, B


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_device_affinity_sequence_matches_jax(n, monkeypatch):
    """assign / release / record_dispatch on a fresh DeviceAffinity of
    each package, with n devices in the census."""
    _virtual_devices(monkeypatch, n)
    monkeypatch.setattr(ref_mesh.DeviceAffinity, "n_devices",
                        staticmethod(lambda: n))
    port, ref = mesh.DeviceAffinity(), ref_mesh.DeviceAffinity()
    script = [("assign", f"set-{i}") for i in range(10)] + [
        ("assign", "set-3"), ("release", "set-3"), ("assign", "set-3"),
        ("release", "nobody"), ("assign", "set-0"),
        ("record", (0,), 100), ("record", (1, 2, 3), 7),
        ("record", tuple(range(n)), 64), ("assign", "late")]
    for step in script:
        if step[0] == "assign":
            assert port.assign(step[1]) == ref.assign(step[1]), step
        elif step[0] == "release":
            port.release(step[1])
            ref.release(step[1])
        else:
            port.record_dispatch(step[1], step[2])
            ref.record_dispatch(step[1], step[2])
    assert port.snapshot() == ref.snapshot()
    assert port.counters() == ref.counters()


def test_serving_mesh_and_device_put_batch(monkeypatch):
    """The serving mesh over 8 virtual devices; an indivisible batch
    lands whole on its home device, a divisible one splits over all 8,
    and the MESH_AFFINITY census agrees with the JAX package's."""
    assert batching.serving_mesh().shape == \
        dict(ref_batching.serving_mesh().shape)
    x = np.arange(3 * 4 * 7, dtype=np.uint8).reshape(3, 4, 7)
    big = np.arange(16 * 4 * 256, dtype=np.uint8).reshape(16, 4, 256)
    for arr, aff in ((x, 2), (x, 5), (big, 5), (x, None)):
        placed = batching.device_put_batch(arr, aff)
        ref_placed = ref_batching.device_put_batch(arr, aff)
        assert len(placed.tiles) == len(ref_placed.sharding.device_set) \
            or aff is None
        assert np.array_equal(placed.apply(lambda t: t), arr)
        assert batching.pinned_device(arr.shape[0], arr.shape[2], aff) == \
            ref_batching.pinned_device(arr.shape[0], arr.shape[2], aff)
    assert mesh.MESH_AFFINITY.counters() == \
        ref_mesh.MESH_AFFINITY.counters()
    # Four devices in the census: the port's mesh is the JAX package's
    # capped at its first four.
    _virtual_devices(monkeypatch, 4)
    ref_batching.set_mesh_devices(4)
    try:
        assert batching.serving_mesh().shape == \
            dict(ref_batching.serving_mesh().shape)
    finally:
        ref_batching.set_mesh_devices(None)


# ---------------------------------------------------------------------------
# the encode coalescer (ops/batching.py EncodeCoalescer)

# (requests as (B, S, affinity, seed), device policy, window s, fail)
COALESCE = {
    "merge": ([(2, 1024, None, s) for s in range(8)], True, 0.5, False),
    "decline-small": ([(2, 256, None, 11)], False, 0.001, False),
    "device-path": ([(3, 512, None, 9)], True, 0.001, False),
    "fanout": ([(3, 63, i, 7 * i) for i in range(4)], True, 0.5, False),
    "mesh-divisible": ([(2, 64, i, 41 + i) for i in range(2)], True, 0.5,
                       False),
    "single-request": ([(3, 64, 2, 3)], True, 0.003, False),
    "shared-affinity": ([(2, 64, 6, 11 + i) for i in range(2)], True, 0.5,
                        False),
    "fanout-failure": ([(3, 63, i, 29 + i) for i in range(2)], True, 0.5,
                       True),
}


def _fanouts(registry) -> float:
    snap = registry.snapshot().get("minio_tpu_v2_codec_plan_fanout_total",
                                   {})
    return sum(s["value"] for s in snap.get("series", []))


def _run_coalescer(pkg, reqs, policy, window, fail, monkeypatch):
    """Submit every request from its own thread at once; returns the
    results, STATS, kernel-lane dispatches, fan-out delta and the
    per-device census of that package."""
    registry = METRICS2 if pkg is batching else REF_METRICS2
    prof = kp.KERNPROF if pkg is batching else ref_kp.KERNPROF
    lane = kp.TORCH_CPU if pkg is batching else ref_kp.XLA_CPU
    aff = mesh.MESH_AFFINITY if pkg is batching else \
        ref_mesh.MESH_AFFINITY
    if fail:
        def boom(*a, **kw):
            raise RuntimeError("sub-dispatch exploded")
        if pkg is batching:
            monkeypatch.setattr(batching, "device_encode", boom)
        else:
            from minio_tpu.ops import rs_tpu
            monkeypatch.setattr(rs_tpu, "encode_batch", boom)
    co = pkg.EncodeCoalescer(lambda n: policy, window_s=window)
    pkg.STATS.reset()
    fan0 = _fanouts(registry)
    outs = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def put(i, B, S, affinity, seed):
        data = np.random.default_rng(seed).integers(
            0, 256, (B, 4, S)).astype(np.uint8)
        barrier.wait()
        outs[i] = (data, co.encode(data, 4, 2, affinity=affinity))

    threads = [threading.Thread(target=put, args=(i, *r))
               for i, r in enumerate(reqs)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        co.stop()
    return (outs, pkg.STATS.snapshot(),
            prof.mix_snapshot()[lane]["dispatches"],
            _fanouts(registry) - fan0, aff.counters(), prof.state_of(lane))


@pytest.mark.parametrize("case", list(COALESCE))
def test_encode_coalescer_matches_jax(case, monkeypatch):
    reqs, policy, window, fail = COALESCE[case]
    port = _run_coalescer(batching, reqs, policy, window, fail, monkeypatch)
    ref = _run_coalescer(ref_batching, reqs, policy, window, fail,
                         monkeypatch)
    for (data, got), (ref_data, want) in zip(port[0], ref[0]):
        assert np.array_equal(data, ref_data)
        assert np.array_equal(got, want)
        assert np.array_equal(got, _encode_ref(data, 4, 2))
    p_stats, r_stats = port[1], ref[1]
    # A kernel-lane dispatch counts as tpu_* in the JAX package (its jit
    # path) and, on the CPU dispatch device, as cpu_* in the port.
    assert p_stats["coalesced_requests"] == r_stats["coalesced_requests"]
    assert p_stats["cpu_dispatches"] == \
        r_stats["cpu_dispatches"] + r_stats["tpu_dispatches"]
    assert port[2] == ref[2]          # kernel-lane dispatches
    assert port[3] == ref[3]          # fan-outs
    assert port[4] == ref[4]          # per-device placement census
    assert port[5] == ref[5]          # lane health after the window
    if case == "merge":
        assert port[2] == 1 and p_stats["coalesced_requests"] == 8
    if case == "fanout":
        assert port[3] == 1


def test_fanout_aliased_affinities_decline(monkeypatch):
    for pkg, aff_cls in ((batching, mesh.DeviceAffinity),
                         (ref_batching, ref_mesh.DeviceAffinity)):
        monkeypatch.setattr(aff_cls, "n_devices", staticmethod(lambda: 4))

        def mk(a, pkg=pkg):
            return pkg._EncodeRequest(np.zeros((3, 4, 63), np.uint8), 4,
                                      2, affinity=a)
        assert pkg.EncodeCoalescer._fanout_split([mk(0), mk(4)]) is None
        by = pkg.EncodeCoalescer._fanout_split([mk(1), mk(6)])
        assert by is not None and sorted(by) == [1, 2]


def test_coalescer_records_queue_wait_split():
    lbl = {"kernel": "rs_encode"}
    _, n0 = METRICS2.get("minio_tpu_v2_kernel_queue_wait_ms", lbl)
    co = batching.EncodeCoalescer(lambda n: False, window_s=0.002)
    try:
        out = co.encode(np.zeros((1, 2, 64), np.uint8), 2, 1)
    finally:
        co.stop()
    assert np.array_equal(out, _encode_ref(np.zeros((1, 2, 64), np.uint8),
                                           2, 1))
    _, n1 = METRICS2.get("minio_tpu_v2_kernel_queue_wait_ms", lbl)
    assert n1 == n0 + 1


# ---------------------------------------------------------------------------
# mask-grouped reconstruct (ops/batching.py reconstruct_blocks)


def _damaged(k, m, S, B, seed, lose_sets):
    rng = np.random.default_rng(seed)
    blocks = []
    for b in range(B):
        full = _encode_ref(rng.integers(0, 256, (1, k, S)).astype(np.uint8),
                           k, m)[0]
        lose = lose_sets[b % len(lose_sets)]
        blocks.append([None if i in lose else full[i].copy()
                       for i in range(k + m)])
    return blocks


@pytest.mark.parametrize("lane", ["kernel", "native", "host"])
@pytest.mark.parametrize("want_all", [False, True])
def test_reconstruct_blocks_matches_jax(want_all, lane, monkeypatch):
    """Mixed masks (and a tail length) over 7 blocks: the rebuilt shards,
    the dispatch count and the lanes that ran equal the JAX package's."""
    blocks = _damaged(4, 2, 96, 6, 5, [(0,), (1, 4), (0,)])
    blocks += _damaged(4, 2, 33, 1, 6, [(2, 5)])
    if lane == "host":
        monkeypatch.setattr(at.AUTOTUNE, "host_lane", lambda *a: kp.HOST)
        monkeypatch.setattr(ref_at.AUTOTUNE, "host_lane",
                            lambda *a: ref_kp.HOST)
    use = lane == "kernel"
    batching.STATS.reset()
    ref_batching.STATS.reset()
    got = batching.reconstruct_blocks(blocks, 4, 2, want_all=want_all,
                                      use_device=lambda n: use)
    want = ref_batching.reconstruct_blocks(blocks, 4, 2, want_all=want_all,
                                           use_device=lambda n: use)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert (g is None) == (w is None)
            if g is not None:
                assert np.array_equal(g, w)
    ps, rs = batching.STATS.snapshot(), ref_batching.STATS.snapshot()
    assert ps["coalesced_requests"] == rs["coalesced_requests"]
    assert ps["cpu_dispatches"] == rs["cpu_dispatches"] + \
        rs["tpu_dispatches"]
    pm, rm = kp.KERNPROF.mix_snapshot(), ref_kp.KERNPROF.mix_snapshot()
    assert {LANE[k]: v["dispatches"] for k, v in rm.items()} == \
        {k: v["dispatches"] for k, v in pm.items()}


def test_reconstruct_insufficient_shards_raises():
    blocks = _damaged(4, 2, 16, 1, 3, [(0, 1, 2)])
    for pkg in (batching, ref_batching):
        with pytest.raises(pkg.ReconstructError):
            pkg.reconstruct_blocks(blocks, 4, 2, want_all=False,
                                   use_device=lambda n: True)


# ---------------------------------------------------------------------------
# kernprof: per-lane health


SCRIPTS = {
    "degrade-down": [("fail", "device")] * 3 + [("ok", "device")] * 5,
    "streak-recovery": [("fail", "native")] + [("ok", "native")] * 4,
    "flap": [("fail", "host"), ("ok", "host"), ("fail", "host"),
             ("ok", "host")] * 3 + [("ok", "host")] * 4,
    "two-lanes": [("fail", "xla-cpu"), ("fail", "native"),
                  ("fail", "xla-cpu"), ("ok", "native"),
                  ("fail", "xla-cpu"), ("ok", "xla-cpu")] * 2,
    "probe-readopts": [("fail", "host")] * 3 + [("probe", "host")],
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_kernprof_state_machine_matches_jax(script):
    """The same outcomes on a fresh KernelProfiler of each package give
    the same state, streaks and failure counts after every step."""
    port, ref = kp.KernelProfiler(), ref_kp.KernelProfiler()
    for what, lane in SCRIPTS[script]:
        for prof, name in ((port, LANE[lane]), (ref, lane)):
            if what == "fail":
                prof.dispatch_failed(name, RuntimeError(f"{lane} broke"))
            elif what == "ok":
                prof.record_dispatch("rs_encode", name, 1024, 0.001, 1)
            else:
                assert prof.probe(name)
        ps, rs = port.snapshot()["backends"], ref.snapshot()["backends"]
        for name in ref_kp.BACKENDS:
            a, b = ps[LANE[name]], rs[name]
            assert (a["state"], a["failStreak"], a["failures"],
                    a["dispatches"]) == (b["state"], b["failStreak"],
                                         b["failures"], b["dispatches"])


def test_batch_bucket_matches_jax():
    assert [kp.batch_bucket(b) for b in range(0, 200)] == \
        [ref_kp.batch_bucket(b) for b in range(0, 200)]


def test_reconstruct_fault_drives_the_same_transitions():
    """A `kernel` fault on rs_decode takes the kernel lane UP -> DEGRADED
    -> DOWN in both packages, byte-exact on the host meanwhile; DOWN
    skips the lane (the hook is no longer consulted); a pinned caller
    still raises; a probe under the fault fails and one after re-adopts
    the lane."""
    plan = {"rules": [{"kind": "kernel", "target": "rs_decode"}]}
    trace = {}
    for pkg, prof, faults, lane in (
            (batching, kp.KERNPROF, FAULTS, kp.TORCH_CPU),
            (ref_batching, ref_kp.KERNPROF, REF_FAULTS, ref_kp.XLA_CPU)):
        faults.load_plan(plan)
        want = pkg.reconstruct_blocks(_damaged(4, 2, 64, 3, 7, [(1,)]), 4, 2,
                                      want_all=False,
                                      use_device=lambda n: False)
        states = []
        for _ in range(prof.DOWN_AFTER):
            out = pkg.reconstruct_blocks(
                _damaged(4, 2, 64, 3, 7, [(1,)]), 4, 2, want_all=False,
                use_device=lambda n: True)
            assert all(np.array_equal(a, b) for x, y in zip(out, want)
                       for a, b in zip(x, y) if a is not None)
            states.append(prof.state_of(lane))
        seen = faults.snapshot()["rules"][0]["seen"]
        pkg.reconstruct_blocks(_damaged(4, 2, 64, 3, 7, [(1,)]), 4, 2,
                               want_all=False, use_device=lambda n: True)
        skipped = faults.snapshot()["rules"][0]["seen"] == seen
        with pytest.raises(Exception):
            pkg.reconstruct_blocks(
                _damaged(4, 2, 64, 3, 7, [(1,)]), 4, 2, want_all=False,
                use_device=lambda n: True, device_fallback=False)
        faults.load_plan({"rules": [{"kind": "kernel", "target": ""}]})
        under_fault = prof.probe(lane)
        faults.clear()
        readopted = prof.probe(lane)
        trace[pkg] = (states, skipped, under_fault, readopted,
                      prof.state_of(lane))
    assert trace[batching] == trace[ref_batching]
    assert trace[batching][0] == [kp.DEGRADED, kp.DEGRADED, kp.DOWN]
    assert trace[batching][1:] == (True, False, True, kp.UP)


@pytest.mark.parametrize("faulted", [False, True])
def test_probe_all_matches_jax(faulted):
    """One probe per lane; the device lane has no card here in either
    package, the CPU kernel lane, native and host pass, and a global
    kernel fault fails every probe."""
    if faulted:
        for f in (FAULTS, REF_FAULTS):
            f.load_plan({"rules": [{"kind": "kernel", "target": ""}]})
    got, want = kp.KERNPROF.probe_all(), ref_kp.KERNPROF.probe_all()
    assert got == {LANE[k]: v for k, v in want.items()}
    assert got[kp.HOST] is (not faulted)


def test_maybe_probe_rate_limited():
    trace = []
    for prof in (kp.KernelProfiler(), ref_kp.KernelProfiler()):
        for _ in range(prof.DOWN_AFTER):
            prof.dispatch_failed("host", RuntimeError("impossible"))
        seq = [prof.state_of("host")]
        prof.maybe_probe(now=1000.0)
        seq.append(prof.state_of("host"))
        for _ in range(prof.DOWN_AFTER):
            prof.dispatch_failed("host", RuntimeError("impossible"))
        prof.maybe_probe(now=1000.0 + prof.PROBE_INTERVAL_S / 2)
        seq.append(prof.state_of("host"))
        prof.maybe_probe(now=2000.0)
        seq.append(prof.state_of("host"))
        trace.append(seq)
    assert trace[0] == trace[1] == ["down", "up", "down", "up"]


def test_transition_logs_and_emits_span_event(capsys):
    """A transition's console line lands in this test's own capture and
    its span event on the active trace."""
    from minio_tpu_torch.obs.span import TRACER
    FAULTS.load_plan({"rules": [{"kind": "kernel", "target": "rs_decode"}]})
    root = TRACER.begin("s3.request", "kernprof-span-test")
    with root:
        batching.reconstruct_blocks(_damaged(4, 2, 32, 2, 1, [(1,)]), 4, 2,
                                    want_all=False,
                                    use_device=lambda n: True)
    tree = TRACER.recent(8)[-1]

    def events(node):
        out = list(node.get("events", []))
        for c in node.get("children", []):
            out.extend(events(c))
        return out

    ev = [e for e in events(tree) if e["name"] == "kernel.backend"]
    assert ev and ev[0]["new"] == kp.DEGRADED
    assert "kernprof: backend torch-cpu up -> degraded" in \
        capsys.readouterr().err


# ---------------------------------------------------------------------------
# a kernel-lane failure: the CPU lane fails over to the host lanes, and a
# card's failure reaches the caller (nothing reruns its work on the host)


def _card_without_card(monkeypatch):
    """The port's dispatch device is the card, with the 8 virtual devices
    as its census: the dispatch device resolves, and the first tensor a
    dispatch moves there fails, as a failing launch on a card would."""
    batching.set_dispatch_device("cuda")
    monkeypatch.setattr(batching, "dispatch_device",
                        lambda: torch.device("cuda", 0))


def _fail_select_kernel(monkeypatch):
    from minio_tpu_torch.ops import select_kernels

    def boom(*a, **kw):
        raise RuntimeError("select kernel broke")
    monkeypatch.setattr(select_kernels, "run_program", boom)


def _fail_hh_kernel(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("hh256 kernel broke")
    monkeypatch.setattr(bitrot.hh256_gpu, "hash_chunks", boom)


def _reconstruct_site() -> bool:
    blocks = _damaged(4, 2, 64, 3, 7, [(1,)])
    got = batching.reconstruct_blocks(blocks, 4, 2, want_all=False,
                                      use_device=lambda n: True)
    want = ref_batching.reconstruct_blocks(blocks, 4, 2, want_all=False,
                                           use_device=lambda n: False)
    return all(np.array_equal(g, w) for gb, wb in zip(got, want)
               for g, w in zip(gb, wb) if g is not None)


def _coalescer_site() -> bool:
    data = np.random.default_rng(3).integers(
        0, 256, (2, 4, 512)).astype(np.uint8)
    co = batching.EncodeCoalescer(lambda n: True, window_s=0.001)
    try:
        return np.array_equal(co.encode(data, 4, 2),
                              _encode_ref(data, 4, 2))
    finally:
        co.stop()


def _regen_site() -> bool:
    from minio_tpu.ops.gf256 import gf_mat_vec_apply
    from minio_tpu_torch.ops import rs_regen
    mat = rs_regen.encode_matrix_regen(4, 2)
    cols = np.random.default_rng(4).integers(
        0, 256, (mat.shape[1], 256)).astype(np.uint8)
    return np.array_equal(
        rs_regen.apply_regen(mat, cols, use_device=lambda n: True),
        gf_mat_vec_apply(mat, cols))


def _bitrot_site() -> bool:
    # B = 3 rows: no split over the 8-device mesh, one K2 dispatch.
    rows = np.random.default_rng(6).integers(0, 256, (3, 64)).astype(
        np.uint8)
    return bitrot._hash_rows_device(rows, rows.size, 1) is None


def _select_site(monkeypatch) -> bool:
    from minio_tpu_torch.ops import select_kernels
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.s3select.columnar import Column, ColumnBatch
    from minio_tpu_torch.s3select.compile import Plan, lower
    a = np.random.default_rng(5).integers(0, 97, 1000).astype(np.float32)
    batch = ColumnBatch(["a"], {"a": Column("a", "num", raw=a)}, 1000,
                        a.nbytes)
    plan = Plan(lower(sql.Cmp("<", sql.Col(("a",)), sql.Lit(48)), batch))
    monkeypatch.setattr(select_kernels, "choose_lane",
                        lambda *a: kp.DEVICE)
    ok, _ = select_kernels.eval_predicate(plan, batch, device="auto")
    return np.array_equal(ok, a < 48)


def _kernel_fault(target: str):
    return lambda mp: FAULTS.load_plan(
        {"rules": [{"kind": "kernel", "target": target}]})


# site: (run(monkeypatch) -> the answer is right (for bitrot: the caller
# must hash on the host), the CPU lane's injected failure)
FAILOVER_SITES = {
    "reconstruct": (lambda mp: _reconstruct_site(),
                    _kernel_fault("rs_decode")),
    "coalescer": (lambda mp: _coalescer_site(), _kernel_fault("rs_encode")),
    "regen": (lambda mp: _regen_site(), _kernel_fault("regen_code")),
    "bitrot": (lambda mp: _bitrot_site(), _fail_hh_kernel),
    "select": (_select_site, _fail_select_kernel),
}


@pytest.mark.parametrize("lane", [kp.TORCH_CPU, kp.DEVICE])
@pytest.mark.parametrize("site", list(FAILOVER_SITES))
def test_kernel_lane_failure_fails_over_only_on_the_cpu(site, lane,
                                                        monkeypatch):
    """Under "auto" a failed kernel-lane dispatch feeds kernprof; on the
    CPU lane it then reruns on the host lanes with the right answer, and
    on a card it raises to the caller with no host lane run."""
    run, cpu_fault = FAILOVER_SITES[site]
    if lane == kp.DEVICE:
        _card_without_card(monkeypatch)
        # What torch raises for a tensor sent to a card it has none of.
        with pytest.raises((RuntimeError, AssertionError)):
            run(monkeypatch)
        mix = kp.KERNPROF.mix_snapshot()
        assert mix[kp.NATIVE]["dispatches"] == mix[kp.HOST]["dispatches"] \
            == 0
    else:
        cpu_fault(monkeypatch)
        assert run(monkeypatch)
    assert kp.KERNPROF.snapshot()["backends"][lane]["failures"] == 1


def test_card_lane_is_never_gated():
    """A DOWN CPU kernel lane is skipped by dispatch policy; a DOWN card
    lane is not: its failures reach the callers instead."""
    prof = kp.KernelProfiler()
    for lane in (kp.DEVICE, kp.TORCH_CPU):
        for _ in range(prof.DOWN_AFTER):
            prof.dispatch_failed(lane, RuntimeError(f"{lane} broke"))
        assert prof.state_of(lane) == kp.DOWN
    assert prof.allow(kp.DEVICE) and not prof.allow(kp.TORCH_CPU)


def test_failed_card_probe_raises(monkeypatch):
    """The probe ladder never plans a failing card away: its first rung
    on the card raises."""
    _card_without_card(monkeypatch)
    with pytest.raises(RuntimeError, match="rs probe failed on the card"):
        at.CodecAutotuner().probe_ladder()
    assert not at.AUTOTUNE._probed


# ---------------------------------------------------------------------------
# autotune: the measured plan


def _feed(tuner, names, seed: int, n: int = 160):
    """A seeded sequence of live samples (kernel, lane, bytes, wall),
    with lane names mapped for the tuner's package."""
    rng = np.random.default_rng(seed)
    lanes = list(ref_kp.BACKENDS)
    for _ in range(n):
        kernel = ref_at.KERNELS[rng.integers(len(ref_at.KERNELS))]
        lane = lanes[rng.integers(len(lanes))]
        nbytes = int(rng.choice([1024, 48 << 10, 1 << 20, 3 << 20, 9 << 20,
                                 40 << 20]))
        wall = float(nbytes / (rng.uniform(0.2, 8.0) * (1 << 30)))
        tuner.observe(kernel, names[lane], nbytes, wall)
        if rng.random() < 0.05:
            tuner._probed = True


@pytest.mark.parametrize("seed", range(10))
def test_autotune_plans_match_jax(seed):
    """Fresh planners of both packages fed the same live samples hold
    the same plan (lane names mapped) and decide the same lanes."""
    port, ref = at.CodecAutotuner(), ref_at.CodecAutotuner()
    _feed(port, LANE, seed)
    _feed(ref, {k: k for k in LANE}, seed)
    want = {k: {b: LANE[ln] for b, ln in v.items()}
            for k, v in ref.plan_compact().items()}
    assert port.plan_compact() == want
    assert port.plan_indices() == ref.plan_indices()
    assert port._plan_version == ref._plan_version
    for kernel in ref_at.KERNELS:
        for nbytes in (1024, 1 << 20, 3 << 20, 9 << 20, 40 << 20):
            assert port.decide(kernel, nbytes) == \
                LANE[ref.decide(kernel, nbytes)], (kernel, nbytes)


def test_size_buckets_match_jax():
    sizes = [0, 1, 65535, 65536, 65537, (1 << 20) - 1, 1 << 20,
             (1 << 20) + 1, 4 << 20, (4 << 20) + 1, 16 << 20,
             (16 << 20) + 1, 1 << 34]
    assert [at.size_bucket(s) for s in sizes] == \
        [ref_at.size_bucket(s) for s in sizes]
    assert at.BUCKETS == ref_at.BUCKETS and at.KERNELS == ref_at.KERNELS
    assert [LANE[x] for x in ref_at._FALLBACK_ORDER] == \
        list(at._FALLBACK_ORDER)


@pytest.mark.parametrize("present", [False, True])
def test_static_policy_and_lane_availability_match_jax(present,
                                                       monkeypatch):
    """Before any measurement: the static policy, and which of the
    device / CPU-kernel lanes is reachable, with and without a device."""
    for pkg in (batching, ref_batching):
        monkeypatch.setattr(pkg, "_device_present", present)
        monkeypatch.setattr(pkg, "_device_count", 1)
    for nbytes in (1024, 4 << 20, 64 << 20):
        assert at.AUTOTUNE.decide("rs_encode", nbytes) == \
            LANE[ref_at.AUTOTUNE.decide("rs_encode", nbytes)]
    for lane in ref_kp.BACKENDS:
        assert at.AUTOTUNE._lane_available(LANE[lane]) == \
            ref_at.AUTOTUNE._lane_available(lane)
    assert at.AUTOTUNE.coalesce_worthwhile() == \
        ref_at.AUTOTUNE.coalesce_worthwhile()


def _both(fn):
    """fn(tuner, kernprof, lane names) on the port and on the JAX
    package; returns both results."""
    return (fn(at.AUTOTUNE, kp.KERNPROF, LANE),
            fn(ref_at.AUTOTUNE, ref_kp.KERNPROF, {k: k for k in LANE}))


def test_fallback_prefers_host_without_data():
    def run(tuner, prof, names):
        for _ in range(prof.DOWN_AFTER):
            prof.dispatch_failed(names["native"], RuntimeError("broke"))
        return tuner.decide("rs_encode", 1 << 20)
    got, want = _both(run)
    assert got == LANE[want] == kp.HOST


def test_never_selects_a_down_lane():
    def run(tuner, prof, names):
        nbytes = 1 << 20
        for lane, wall in (("native", 0.001), ("host", 0.004),
                           ("xla-cpu", 0.01)):
            for _ in range(tuner.MIN_SAMPLES):
                tuner.observe("rs_encode", names[lane], nbytes, wall)
        tuner._probed = True
        seq = [tuner.decide("rs_encode", nbytes)]
        for _ in range(prof.DOWN_AFTER):
            prof.dispatch_failed(names["native"], RuntimeError("x"))
        seq.append(tuner.decide("rs_encode", nbytes))
        return seq
    got, want = _both(run)
    assert got == [LANE[x] for x in want] == [kp.NATIVE, kp.HOST]


def test_hysteresis_and_noisy_samples_match_jax():
    def run(tuner, prof, names):
        nbytes = 1 << 20
        for _ in range(tuner.MIN_SAMPLES):
            tuner.observe("rs_encode", names["native"], nbytes, 0.001)
        tuner._probed = True
        seq = []
        # Inside the hysteresis margin: no flip, whatever the evidence.
        for _ in range(tuner.MIN_SAMPLES + 1):
            tuner.observe("rs_encode", names["xla-cpu"], nbytes,
                          0.001 / 1.1)
        seq.append((tuner._plan[("rs_encode", "64K-1M")],
                    tuner._plan_version))
        # Decisively faster with MIN_SAMPLES: flips.
        for _ in range(tuner.MIN_SAMPLES + 1):
            tuner.observe("rs_encode", names["xla-cpu"], nbytes,
                          0.001 / 2.5)
        seq.append((tuner._plan[("rs_encode", "64K-1M")],
                    tuner._plan_version))
        # One wild sample on another lane cannot flap the plan.
        tuner.observe("rs_encode", names["host"], nbytes, 0.00001)
        seq.append((tuner._plan[("rs_encode", "64K-1M")],
                    tuner._plan_version))
        return seq
    got, want = _both(run)
    assert got == [(LANE[a], v) for a, v in want]
    assert [lane for lane, _ in got] == [kp.NATIVE, kp.TORCH_CPU,
                                         kp.TORCH_CPU]
    assert got[1][1] == got[2][1]


def test_coalesce_window_stops_after_live_evidence(monkeypatch):
    for pkg in (batching, ref_batching):
        monkeypatch.setattr(pkg, "_device_present", True)
        monkeypatch.setattr(pkg, "_device_count", 1)

    def run(tuner, prof, names):
        seq = [tuner.coalesce_worthwhile()]
        for nbytes in (1024, 1 << 20, 2 << 20, 8 << 20, 32 << 20):
            for _ in range(tuner.MIN_SAMPLES):
                tuner.observe("rs_encode", names["native"], nbytes,
                              max(nbytes / 1e9, 1e-4))
            seq.append(tuner.coalesce_worthwhile())
        return seq
    got, want = _both(run)
    assert got == want == [True, True, True, True, True, False]


def test_configure_and_hysteresis_floor_match_jax():
    def run(tuner, prof, names):
        tuner._probed = True
        for _ in range(tuner.MIN_SAMPLES):
            tuner.observe("rs_encode", names["host"], 1024, 1e-6)
        seq = [tuner.decide("rs_encode", 1024)]
        tuner.configure(enabled=False, hysteresis=1.5)
        seq += [tuner.decide("rs_encode", 1024), tuner.hysteresis]
        tuner.configure(enabled=True, hysteresis=0.2)
        seq += [tuner.decide("rs_encode", 1024), tuner.hysteresis]
        tuner.configure(enabled=True, hysteresis=float("nan"))
        return seq + [tuner.hysteresis]
    got, want = _both(run)
    assert got == want == ["host", "native", 1.5, "host", 1.0, 1.0]


def test_census_change_rebuilds_mesh_and_replans(monkeypatch, capsys):
    """A device count that changed under the cached census rebuilds the
    serving mesh and re-plans, with a console line, as in the JAX
    package."""
    seen = {}
    for pkg, tuner in ((batching, at.AUTOTUNE),
                       (ref_batching, ref_at.AUTOTUNE)):
        pkg.device_present()
        calls = []
        monkeypatch.setattr(pkg, "_device_count", 4)
        monkeypatch.setattr(pkg, "_serving_mesh_built", True)
        monkeypatch.setattr(tuner, "on_device_census_change",
                            lambda o, n, c=calls: c.append((o, n)))
        pkg.reprobe_device_present()
        seen[pkg] = (calls, pkg._serving_mesh_built)
    assert seen[batching] == seen[ref_batching] == ([(4, 8)], False)
    monkeypatch.undo()
    at.AUTOTUNE.on_device_census_change(1, 8)
    assert "device census changed (1 -> 8 devices)" in capsys.readouterr().err


def test_probe_ladder_on_the_cpu_lanes(monkeypatch):
    """The whole ladder in the foreground with small rungs: every CPU
    lane passes its known-answer check at every rung, for RS, Select
    and REGEN, and the plan covers every kernel and bucket; no probe
    thread is left behind."""
    rungs = (("<64K", 2, 1024), ("64K-1M", 2, 4096), ("1-4M", 2, 8192),
             ("4-16M", 2, 16384))
    monkeypatch.setattr(at, "_PROBE_RUNGS", rungs)
    monkeypatch.setattr(at, "_SELECT_PROBE_ROWS", 256)
    before = threading.active_count()
    at.AUTOTUNE.ensure_probed(background=False)
    res = at.AUTOTUNE.snapshot()
    assert threading.active_count() == before
    assert res["probed"]
    assert set(res["lastProbe"]) == {kp.NATIVE, kp.TORCH_CPU, kp.HOST}
    for table in (res["lastProbe"], res["lastSelectProbe"],
                  res["lastRegenProbe"]):
        for lane, per in table.items():
            assert set(per) == {b for b, _, _ in rungs}
            assert all(v for v in per.values()), (lane, per)
    plan = at.AUTOTUNE.plan_compact()
    assert set(plan) == set(at.KERNELS)
    assert all(set(v) == set(at.BUCKETS) for v in plan.values())
    assert set(res["backendStates"]) == set(kp.BACKENDS)


# ---------------------------------------------------------------------------
# the "auto" codec


@pytest.mark.parametrize("lane", [kp.TORCH_CPU, kp.NATIVE, kp.HOST])
def test_erasure_auto_matches_jax(lane, monkeypatch):
    """Erasure(backend="auto", device="cpu") with the plan routing every
    dispatch to one lane: shards, shard-major shards and rebuilt shards
    equal the JAX Erasure's, and the lane mix says which lane ran."""
    monkeypatch.setattr(at.AUTOTUNE, "decide", lambda *a: lane)
    k, m = 4, 2
    port = Erasure(k, m, block_size=4096, backend="auto", device="cpu")
    ref = RefErasure(k, m, block_size=4096, backend="cpu")
    rng = np.random.default_rng(21)
    blocks = rng.integers(0, 256, (3, k, 1024)).astype(np.uint8)
    enc = port.encode_blocks_batch(blocks)
    assert np.array_equal(enc, ref.encode_blocks_batch(blocks))
    assert np.array_equal(port.encode_blocks_batch_shardmajor(blocks),
                          ref.encode_blocks_batch_shardmajor(blocks))
    one = rng.integers(0, 256, 3000).astype(np.uint8)
    assert np.array_equal(port.encode_data(one), ref.encode_data(one))
    dam = [[None if j in (0, 5) else enc[b, j] for j in range(k + m)]
           for b in range(3)]
    for got, want in ((port.decode_data_blocks_batch(dam),
                       ref.decode_data_blocks_batch(dam)),
                      (port.decode_all_blocks_batch(dam),
                       ref.decode_all_blocks_batch(dam))):
        for gb, wb in zip(got, want):
            assert all(np.array_equal(g, w) for g, w in zip(gb, wb)
                       if w is not None)
    mix = kp.KERNPROF.mix_snapshot()   # 3 encodes, 2 mask groups
    assert mix[lane]["dispatches"] == 5
    assert sum(v["dispatches"] for v in mix.values()) == 5


def _no_card(monkeypatch):
    batching.set_dispatch_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


AUTO_ENTRIES = {
    "Erasure": lambda: Erasure(4, 2, backend="auto"),
    "RegenErasure": lambda: __import__(
        "minio_tpu_torch.erasure.regen", fromlist=["RegenErasure"]
    ).RegenErasure(4, 2, backend="auto"),
    "codec_for_algorithm rs": lambda: codec_for_algorithm(
        "rs-vandermonde", 4, 2, backend="auto"),
    "codec_for_algorithm regen": lambda: codec_for_algorithm(
        "pm-mbr-rbt", 4, 2, backend="auto"),
    "bitrot.digest_rows": lambda: bitrot.digest_rows(
        bitrot.DEFAULT_ALGORITHM, np.zeros((2, 64), np.uint8),
        device="auto"),
    "bitrot.encode_streams": lambda: bitrot.encode_streams(
        [b"x" * 100], 64, device="auto"),
    "run_select": lambda: __import__(
        "minio_tpu_torch.s3select.select", fromlist=["run_select"]
    ).run_select({}, b"", device="auto"),
}


@pytest.mark.parametrize("entry", list(AUTO_ENTRIES))
def test_auto_without_a_card_raises(entry, monkeypatch):
    """No silent CPU default: "auto" with the card as dispatch device and
    no card raises; the codecs say how to ask for the CPU."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError) as exc:
        AUTO_ENTRIES[entry]()
    if entry.startswith(("Erasure", "Regen", "codec")):
        assert isinstance(exc.value, AutoUnavailable)
        assert "device='cpu'" in str(exc.value)


def test_auto_with_cpu_dispatch_device_needs_no_argument():
    batching.set_dispatch_device("cpu")
    e = Erasure(4, 2, block_size=4096, backend="auto")
    assert e.device.type == "cpu"
    with pytest.raises(ValueError):
        Erasure(4, 2, backend="gpu", device="cpu")
    with pytest.raises(ValueError):
        batching.set_dispatch_device("meta")


# ---------------------------------------------------------------------------
# bitrot under "auto"


def _rows(seed, B, L):
    return np.random.default_rng(seed).integers(0, 256, (B, L)).astype(
        np.uint8)


BITROT = {
    "digest": lambda mod, dev: mod.digest(
        mod.DEFAULT_ALGORITHM, _rows(1, 1, 777)[0].tobytes(), **dev),
    "digest sha256": lambda mod, dev: mod.digest(
        mod.SHA256, _rows(1, 1, 77)[0].tobytes(), **dev),
    "digest_chunks": lambda mod, dev: mod.digest_chunks(
        mod.DEFAULT_ALGORITHM, _rows(2, 1, 5000)[0].tobytes(), 512, **dev),
    "digest_rows": lambda mod, dev: mod.digest_rows(
        mod.DEFAULT_ALGORITHM, _rows(3, 6, 640), **dev).tobytes(),
    "digest_chunks_many": lambda mod, dev: mod.digest_chunks_many(
        mod.DEFAULT_ALGORITHM, [_rows(4 + i, 1, 1100 + 300 * i)[0].tobytes()
                                for i in range(5)], 512, **dev),
    "encode_stream_arrays": lambda mod, dev: [
        a.tobytes() for a in mod.encode_stream_arrays(
            [_rows(10 + i, 3, 256) for i in range(4)], **dev)],
    "encode_streams": lambda mod, dev: mod.encode_streams(
        [_rows(20 + i, 1, 700)[0].tobytes() for i in range(6)], 256, **dev),
    "frame_shard": lambda mod, dev: mod.frame_shard(
        _rows(30, 4, 128), _rows(31, 1, 50)[0].tobytes(), **dev),
    "verify_frames": lambda mod, dev: mod.verify_frames(
        [r for r in _rows(40, 7, 96)] + [_rows(41, 1, 33)[0]],
        [b"\0" * 32] * 3 + [ref_bitrot.digest(mod.DEFAULT_ALGORITHM,
                                              r.tobytes())
                            for r in _rows(40, 7, 96)[3:]] + [b"\1" * 32],
        **dev),
    "verify_stream": lambda mod, dev: mod.verify_stream(
        ref_bitrot.encode_stream(_rows(50, 1, 1000)[0].tobytes(), 256), 256,
        **dev),
}


@pytest.mark.parametrize("fn", list(BITROT))
def test_bitrot_auto_matches_jax(fn):
    """Under "auto" on the CPU dispatch device every HighwayHash runs on
    the native host lane: the digests and frames equal the JAX
    package's (which routes the same way), and no kernel-lane dispatch
    is counted."""
    batching.HH_STATS.reset()
    got = BITROT[fn](bitrot, {"device": "auto"})
    assert got == BITROT[fn](ref_bitrot, {})
    assert batching.HH_STATS.snapshot()["gpu_dispatches"] == 0
    assert kp.KERNPROF.mix_snapshot()[kp.TORCH_CPU]["dispatches"] == 0


@pytest.mark.parametrize("B", [8, 6])
def test_bitrot_auto_device_route(B, monkeypatch):
    """With a device lane answering and the batch over the threshold,
    "auto" hashes the full chunks in one K2 dispatch -- split over the
    8-device mesh by rows_sharding when B divides it -- and the tails on
    the host; digests equal the JAX package's own device route."""
    for pkg, mod in ((batching, bitrot), (ref_batching, ref_bitrot)):
        monkeypatch.setattr(pkg, "_device_present", True)
        monkeypatch.setattr(pkg, "_device_count", N_VIRTUAL)
        monkeypatch.setattr(mod, "HH_TPU_MIN_BYTES", 1024)
    streams = [_rows(60 + i, 1, 300 * (B // 2) + 17 * i)[0].tobytes()
               for i in range(2)]
    batching.HH_STATS.reset()
    ref_batching.HH_STATS.reset()
    got = bitrot.digest_chunks_many(bitrot.DEFAULT_ALGORITHM, streams, 300,
                                    device="auto")
    assert got == ref_bitrot.digest_chunks_many(
        ref_bitrot.DEFAULT_ALGORITHM, streams, 300)
    ps, rs = batching.HH_STATS.snapshot(), ref_batching.HH_STATS.snapshot()
    assert (ps["gpu_dispatches"], ps["coalesced_requests"]) == \
        (rs["tpu_dispatches"], rs["coalesced_requests"]) == (1, 2)
    assert kp.KERNPROF.mix_snapshot()[kp.TORCH_CPU]["dispatches"] == 1


# ---------------------------------------------------------------------------
# S3 Select on the measured lane


def _select_batch(n, seed=3):
    from minio_tpu_torch.s3select import columnar
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 97, n).astype(np.float32)
    b = rng.integers(0, 97, n).astype(np.int32)
    cols = {"a": columnar.Column("a", "num", raw=a),
            "b": columnar.Column("b", "num", raw=b, intish=True)}
    return columnar.ColumnBatch(["a", "b"], cols, n, 8 * n)


@pytest.mark.parametrize("lane", [kp.TORCH_CPU, kp.NATIVE, kp.HOST])
def test_select_auto_lane_and_masks(lane, monkeypatch):
    """choose_lane maps NATIVE to HOST and keeps the kernel lane only for
    a plan the kernel runs; the masks on any lane equal the pinned CPU
    kernel's, and the dispatch is recorded under the lane that ran."""
    from minio_tpu_torch.ops import select_kernels as sk
    from minio_tpu_torch.s3select import compile as comp, sql
    monkeypatch.setattr(at.AUTOTUNE, "decide", lambda *a: lane)
    batch = _select_batch(1000)
    plan = comp.Plan(comp.lower(sql.parse(
        "SELECT * FROM S3Object WHERE a < 48 AND b BETWEEN 3 AND 60").where,
        batch))
    want_lane = kp.HOST if lane == kp.NATIVE else lane
    assert sk.choose_lane(plan, 8000) == want_lane
    ok, fb = sk.eval_predicate(plan, batch, device="auto")
    pin_ok, pin_fb = sk.eval_predicate(plan, batch, device="cpu")
    assert np.array_equal(ok, pin_ok) and np.array_equal(fb, pin_fb)
    assert kp.KERNPROF.mix_snapshot()[want_lane]["dispatches"] >= 1


@pytest.mark.parametrize("lane", [kp.TORCH_CPU, kp.HOST])
def test_select_probe_lane_matches_jax(lane):
    from minio_tpu.ops import select_kernels as ref_sk
    from minio_tpu_torch.ops import select_kernels as sk
    bps, err = sk.probe_lane(lane, 4096)
    ref_lane = {kp.TORCH_CPU: ref_kp.XLA_CPU, kp.HOST: ref_kp.HOST}[lane]
    ref_bps, ref_err = ref_sk.probe_lane(ref_lane, 4096)
    assert (bps is not None, err) == (ref_bps is not None, ref_err) == \
        (True, "")


@pytest.mark.parametrize("query", [
    "SELECT COUNT(*) FROM S3Object WHERE c0 >= 0.25 AND i0 < 700",
    "SELECT c1 FROM S3Object WHERE c0 < 0.125"])
def test_run_select_auto_matches_jax(query):
    """SelectObjectContent over a Parquet object with device="auto":
    the response body equals the pinned CPU lane's and the JAX
    package's."""
    from xml.sax.saxutils import escape

    from minio_tpu.s3select.select import parse_request as ref_parse
    from minio_tpu.s3select.select import run_select as ref_run
    from minio_tpu_torch.s3select import parquet as pq
    from minio_tpu_torch.s3select.select import parse_request, run_select
    rng = np.random.default_rng(14)
    n = 3000
    cols = [pq.Column("c0", pq.FLOAT, optional=False),
            pq.Column("c1", pq.FLOAT, optional=False),
            pq.Column("i0", pq.INT32, optional=False)]
    data = pq.write_parquet_columns(cols, {
        "c0": rng.random(n, dtype=np.float32),
        "c1": rng.random(n, dtype=np.float32),
        "i0": rng.integers(0, 1000, n).astype(np.int32)}, n)
    xml = ("<SelectObjectContentRequest><Expression>" + escape(query)
           + "</Expression><ExpressionType>SQL</ExpressionType>"
           "<InputSerialization><Parquet/></InputSerialization>"
           "<OutputSerialization><JSON/></OutputSerialization>"
           "</SelectObjectContentRequest>").encode()
    body = run_select(parse_request(xml), data, device="auto")
    assert body == run_select(parse_request(xml), data, device="cpu")
    assert body == ref_run(ref_parse(xml), data)


# ---------------------------------------------------------------------------
# the multi-device full_step and the entry points


@pytest.mark.parametrize("n", [2, 4, 8])
def test_full_step_sharded_matches_jax(n):
    """The JAX full_step under dryrun_multichip's shardings on an
    n-device mesh, and the port's full_step_sharded over n virtual CPU
    devices, on the same inputs: same shards and rebuilt bytes,
    mismatch 0."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    rm = ref_mesh.make_mesh(n)
    cfg = ref_pipeline.ECConfig(8, 4, block_size=8 * 1024)
    batch, shard = 2 * rm.shape["blocks"], 256 * rm.shape["lanes"]
    enc, dec, data, used = ref_pipeline.make_full_step_inputs(
        cfg, batch=batch, shard_size=shard, missing=(0, 3))
    dsh, rep = ref_mesh.block_sharding(rm), NamedSharding(rm, P())
    step = jax.jit(ref_pipeline.full_step,
                   in_shardings=(rep, rep, dsh, rep),
                   out_shardings={"shards": dsh, "rebuilt": dsh,
                                  "mismatch": rep})
    want = step(*(jax.device_put(a, s) for a, s in
                  ((enc, rep), (dec, rep), (data, dsh), (used, rep))))
    got = ec_pipeline.full_step_sharded(
        ["cpu"] * n, np.asarray(enc), np.asarray(dec), np.asarray(data),
        np.asarray(used))
    assert int(got["mismatch"]) == int(want["mismatch"]) == 0
    assert np.array_equal(got["shards"].numpy(), np.asarray(want["shards"]))
    assert np.array_equal(got["rebuilt"].numpy(),
                          np.asarray(want["rebuilt"]))


def test_entry_points_on_the_cpu():
    from minio_tpu_torch import entry
    fn, (bm, data) = entry.entry("cpu")
    ref_pipe = ref_pipeline.ECPipeline(ref_pipeline.ECConfig(8, 4))
    assert np.array_equal(fn(data).numpy(), ref_pipe.encode(data.numpy()))
    out = entry.dryrun_multichip(4, "cpu")
    assert tuple(out["shards"].shape) == (4, 12, 512)


# ---------------------------------------------------------------------------
# the copied host helpers


def test_quorum_helpers_match_jax():
    keys = [f"bucket/obj-{i}" for i in range(50)]
    for n in (1, 4, 6, 16):
        assert [quorum.hash_order(k, n) for k in keys] == \
            [ref_quorum.hash_order(k, n) for k in keys]
    for k, m in ((2, 2), (4, 2), (12, 4)):
        assert quorum.write_quorum(k, m) == ref_quorum.write_quorum(k, m)
    res, errs = quorum.parallel_map([lambda i=i: i * i for i in range(5)]
                                    + [lambda: 1 // 0])
    ref_res, ref_errs = ref_quorum.parallel_map(
        [lambda i=i: i * i for i in range(5)] + [lambda: 1 // 0])
    assert res == ref_res
    assert [type(e) for e in errs] == [type(e) for e in ref_errs]


def test_fault_plan_decisions_match_jax():
    """A seeded probabilistic kernel plan fires on the same occurrences
    in both packages."""
    plan = {"seed": 7, "rules": [{"kind": "kernel", "target": "rs_",
                                  "probability": 0.4, "after": 2,
                                  "count": 9}]}
    fired = []
    for faults in (FAULTS, REF_FAULTS):
        faults.load_plan(plan)
        seq = []
        for i in range(60):
            try:
                faults.kernel("rs_encode" if i % 3 else "select_scan")
                seq.append(0)
            except Exception:
                seq.append(1)
        fired.append((seq, faults.snapshot()["rules"][0]["fired"]))
    assert fired[0] == fired[1]
    assert fired[0][1] == sum(fired[0][0]) > 0
