"""The JAX package's own suites of the erasure engine, run against the port.

Each module's bodies are collected unchanged through ``test_torch_remap``
and reach ``erasure/engine.py``, ``parallel/quorum.py``, ``storage/xl.py``,
``erasure/heal.py`` and ``fs/backend.py``.
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

import test_concurrency as _concurrency
import test_postpolicy_heal as _postpolicy_heal
import test_fs as _fs
from test_torch_remap import (AUTO_CPU, DIVERGENCES, PortRemap, collected,
                              cpu_plane, reference_cases)

REMAP = PortRemap(AUTO_CPU)
SUITES = {
    "concurrency": (_concurrency, {}, {}),
    "postpolicy_heal": (_postpolicy_heal, {}, {}),
    "fs": (_fs, {}, {}),
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
