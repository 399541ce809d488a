"""The JAX package's own suites of the observability planes, run against
the port.

Each module's bodies are collected unchanged through ``test_torch_remap``
and reach ``obs/``, ``s3/asyncserver.py`` and ``faultinject/``.
Engines and drives run under "auto" on the CPU (``AUTO_CPU``), so frames
hash on the native lane as the reference's do.
``SUITES`` gives, for each module, the bodies left out, each by the id of
the divergence of ROADMAP §C that covers it (``DIVERGENCES``), and the
bodies marked ``slow`` (out of tier-1), each with why.
Each module's fixtures live while its cases run, and no background thread
or monitored loop it started outlives them (``ModuleLife``).
"""

from __future__ import annotations

import pytest

import test_observability as _observability
import test_timeline as _timeline
import test_usage as _usage
import test_loopmon as _loopmon
import test_watchdog as _watchdog
import test_front_door as _front_door
import test_fault_harness as _fault_harness
from test_torch_remap import (AUTO_CPU, DIVERGENCES, PortRemap, collected,
                              cpu_plane, reference_cases)

REMAP = PortRemap(AUTO_CPU)
SUITES = {
    "observability": (_observability, {}, {}),
    "timeline": (_timeline, {
        "test_node_endpoint_serves_samples_with_traffic": "D12",
        "test_admin_kernel_health_surface": "D12",
    }, {}),
    "usage": (_usage, {}, {}),
    "loopmon": (_loopmon, {}, {}),
    "watchdog": (_watchdog, {}, {
        "test_e2e_fault_plan_fires_drive_alert_with_incident":
            "unsteady in the reference (ROADMAP, Reference baseline)",
    }),
    "front_door": (_front_door, {}, {
        "test_async_loadgen_closed_loop":
            "unsteady in the reference (ROADMAP, Reference baseline)",
    }),
    # The other cases drive a three-node cluster of the port's CLI
    # (``python -m minio_tpu`` starts ``minio_tpu_torch`` here).
    "fault_harness": (_fault_harness, {}, {
        "test_hedged_read_bounds_straggler_tail":
            "unsteady in the reference (ROADMAP, Reference baseline)",
    }),
}
for _tag, (_mod, _skip, _slow) in SUITES.items():
    REMAP.collect(_mod, _tag, globals(), skip=_skip, fixtures=True,
                  slow=_slow)


@pytest.fixture(scope="module", autouse=True)
def _port_plane():
    with cpu_plane(1), REMAP.life:
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
