"""The JAX package's own suites of the front door, run against the port.

Each module's bodies are collected unchanged through ``test_torch_remap``
and reach ``iam/``, ``crypto/``, ``event/``, ``bucket/``, ``s3/`` (server,
admin), ``qos/``, ``s3select/`` and ``ops/select_kernels.py``.
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

import test_iam as _iam
import test_kms as _kms
import test_sse as _sse
import test_ldap_sts as _ldap_sts
import test_tls as _tls
import test_events as _events
import test_replication as _replication
import test_tiering as _tiering
import test_admin as _admin
import test_qos as _qos
import test_obd_bandwidth as _obd_bandwidth
import test_s3select as _s3select
import test_parquet as _parquet
from test_torch_remap import (AUTO_CPU, DIVERGENCES, PortRemap, collected,
                              cpu_plane, reference_cases)

REMAP = PortRemap(AUTO_CPU)
SUITES = {
    "iam": (_iam, {}, {}),
    "kms": (_kms, {}, {}),
    "sse": (_sse, {}, {}),
    "ldap_sts": (_ldap_sts, {}, {}),
    "tls": (_tls, {}, {}),
    "events": (_events, {}, {}),
    "replication": (_replication, {}, {}),
    "tiering": (_tiering, {}, {}),
    "admin": (_admin, {}, {}),
    "qos": (_qos, {}, {}),
    "obd_bandwidth": (_obd_bandwidth, {}, {}),
    "s3select": (_s3select, {}, {}),
    "parquet": (_parquet, {}, {}),
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
