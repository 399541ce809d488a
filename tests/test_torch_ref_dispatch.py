"""The JAX package's own suites of the dispatch plane, run against the port.

Each module's bodies are collected unchanged through ``test_torch_remap``
and reach ``ops/`` (gf256, rs_cpu, rs_gpu, hh256, hh256_gpu, batching,
autotune), ``parallel/mesh.py``, ``obs/kernprof.py`` and ``native/``.
The port's kernel lane runs on 8 virtual CPU devices, as the reference's
suites run on the 8 virtual XLA devices of tests/conftest.py, and engines
and drives run under "auto" on the CPU (``AUTO_CPU``), so frames hash on
the native lane as the reference's do.
``SUITES`` gives, for each module, the bodies left out, each by the id of
the divergence of ROADMAP §C that covers it (``DIVERGENCES``), and the
bodies marked ``slow`` (out of tier-1), each with why.
Each module's fixtures live while its cases run, and no background thread
or monitored loop it started outlives them (``ModuleLife``).
"""

from __future__ import annotations

import pytest

import test_gf256 as _gf256
import test_rs as _rs
import test_rs_native as _rs_native
import test_hh256 as _hh256
import test_batching as _batching
import test_mesh_serving as _mesh_serving
import test_autotune as _autotune
import test_autotune_mesh as _autotune_mesh
import test_kernprof as _kernprof
import test_device_state as _device_state
from test_torch_remap import (AUTO_CPU, DIVERGENCES, PortRemap, collected,
                              cpu_plane, reference_cases)

REMAP = PortRemap(AUTO_CPU)
SUITES = {
    "gf256": (_gf256, {}, {}),
    "rs": (_rs, {}, {}),
    "rs_native": (_rs_native, {}, {}),
    "hh256": (_hh256, {}, {}),
    "batching": (_batching, {}, {}),
    "mesh_serving": (_mesh_serving, {
        "test_device_put_batch_actually_shards": "D13",
        "test_device_put_batch_indivisible_dims_still_work": "D13",
        "test_hash_chunks_sharded_matches_reference": "D14",
    }, {}),
    "autotune": (_autotune, {
        "test_probe_ladder_measures_and_plans": "D12",
        "test_xla_cpu_unreachable_while_device_present": "D12",
        "test_snapshot_shape": "D12",
        "test_boot_probe_kicks_off": "C3",
    }, {
        "test_never_selects_a_down_lane":
            "unsteady in the reference (ROADMAP, Reference baseline)",
    }),
    "autotune_mesh": (_autotune_mesh, {
        "test_indivisible_batch_pins_to_home_device": "D13",
        "test_divisible_batch_still_shards_across_mesh": "D13",
    }, {}),
    "kernprof": (_kernprof, {
        "test_degrade_down_and_streak_recovery": "D1",
        "test_probe_all_reports_every_backend": "D12",
    }, {}),
    "device_state": (_device_state, {}, {}),
}
for _tag, (_mod, _skip, _slow) in SUITES.items():
    REMAP.collect(_mod, _tag, globals(), skip=_skip, fixtures=True,
                  slow=_slow)


@pytest.fixture(scope="module", autouse=True)
def _port_plane():
    with cpu_plane(8), REMAP.life:
        yield


@pytest.fixture(autouse=True)
def _module_life(request):
    REMAP.life.enter(request.node.name)


@pytest.mark.parametrize("tag", list(SUITES))
def test_every_reference_case_was_collected(tag):
    mod, skip, slow = SUITES[tag]
    want = reference_cases(mod)
    assert want and set(skip) | set(slow) <= set(want)
    assert set(skip.values()) <= set(DIVERGENCES)
    assert len(collected(globals(), tag)) == len(want) - len(skip)


@pytest.mark.parametrize("tag", list(SUITES))
def test_no_thread_outlives_its_module(tag):
    assert REMAP.life.census.get(tag, []) == []
