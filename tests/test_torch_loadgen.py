"""The port's load generator (``minio_tpu_torch/tools/loadgen.py``) against
the JAX system's (``tools/loadgen.py``).

One port ``S3Server`` on the CPU (engines and drives under "auto", no probe
ladder) takes the traffic of both generators. The pure parts (percentile,
Zipf ranks, key shares, pacing) are held to the reference's on seeded
inputs; both packages' ``run_load`` and ``run_async_load`` give reports of
one schema with every status 200 and leave the same keys under
``preload``; and a client process of the port's generator, run as its
CLI, imports neither torch nor JAX nor the JAX package.
"""

from __future__ import annotations

import json
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tools.loadgen as ref_lg
from minio_tpu_torch.tools import loadgen as port_lg

ACCESS, SECRET = "lgadmin", "lgadmin-secret"
ROOT = Path(__file__).resolve().parent.parent
GENERATORS = {"ref": ref_lg, "port": port_lg}


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from minio_tpu_torch.erasure.engine import ErasureObjects
    from minio_tpu_torch.ops import batching
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.xl import XLStorage
    tmp = tmp_path_factory.mktemp("loadgen")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        batching.set_dispatch_device("cpu")
        srv = S3Server(ErasureObjects(
            [XLStorage(str(tmp / f"d{i}"), device="auto") for i in range(4)],
            block_size=64 * 1024, backend="auto", device="cpu"),
            ACCESS, SECRET)
        try:
            port = srv.start()
            yield port
        finally:
            srv.stop()
            batching.set_dispatch_device("cuda")


def _client(port):
    from minio_tpu_torch.s3.client import S3Client
    return S3Client("127.0.0.1", port, ACCESS, SECRET)


def _keys(port, bucket) -> list[str]:
    r = _client(port).request("GET", f"/{bucket}", query="list-type=2")
    assert r.status == 200
    return sorted(k.decode() for k in re.findall(rb"<Key>([^<]*)</Key>",
                                                  r.body))


def _schema(doc) -> object:
    """The report's keys, nested; lists and numbers by type."""
    if isinstance(doc, dict):
        return {k: _schema(v) for k, v in doc.items()}
    return type(doc).__name__


def test_pure_parts_match_the_reference():
    rng = np.random.default_rng(11)
    for n in (0, 1, 7, 100):
        vals = sorted(rng.random(n).tolist())
        for q in (0, 1, 50, 90, 99, 100):
            assert port_lg._percentile(vals, q) == ref_lg._percentile(vals, q)
    for s, n in ((0.8, 10), (1.1, 64), (3.0, 5)):
        r1, r2 = random.Random(5), random.Random(5)
        zp, zr = port_lg._Zipf(s, n), ref_lg._Zipf(s, n)
        assert [zp.sample(r1) for _ in range(500)] == \
            [zr.sample(r2) for _ in range(500)]
    for n in (0, 1, 40, 400):
        counts = {f"k{i}": int(c) for i, c in
                  enumerate(rng.integers(1, 1000, n))}
        assert port_lg._key_shares(counts) == ref_lg._key_shares(counts)


@pytest.mark.parametrize("qps", [0.0, 40.0])
def test_pacer_matches_the_reference(monkeypatch, qps):
    """Both pacers hand out the same slots on one fake clock."""
    slept = {}
    for name, lg in GENERATORS.items():
        now = [100.0]
        out = slept[name] = []

        def sleep(d, now=now, out=out):
            out.append(round(d, 9))
            now[0] += d
        monkeypatch.setattr(lg.time, "monotonic", lambda now=now: now[0])
        monkeypatch.setattr(lg.time, "sleep", sleep)
        p = lg._Pacer(qps)
        for i in range(20):
            now[0] += 0.01 * (i % 3)
            p.wait()
        monkeypatch.undo()
    assert slept["port"] == slept["ref"]
    assert bool(slept["port"]) == (qps > 0)


def test_run_load_reports_match_the_reference(server):
    c = _client(server)
    reports = {}
    for name, lg in GENERATORS.items():
        assert c.make_bucket(f"lg-{name}").status == 200
        reports[name] = lg.run_load(
            "127.0.0.1", server, ACCESS, SECRET, f"lg-{name}",
            concurrency=4, duration=0.6, put_fraction=0.0,
            object_bytes=4096, key_space=8, seed=3, preload=True)
    assert _schema(reports["port"]) == _schema(reports["ref"])
    for rep in reports.values():
        assert rep["requests"] > 0
        assert rep["status_counts"] == {"200": rep["requests"]}
    assert _keys(server, "lg-port") == _keys(server, "lg-ref") == \
        sorted(f"loadgen/p{r}" for r in range(8))


def test_run_load_multi_tenant_reports_match_the_reference(server):
    """Both generators drive one fleet of three buckets."""
    c = _client(server)
    for i in range(3):
        assert c.make_bucket(f"mt-{i}").status == 200
    reports = {name: lg.run_load(
        "127.0.0.1", server, ACCESS, SECRET, "mt", concurrency=3,
        duration=0.6, put_fraction=0.5, object_bytes=2048, key_space=4,
        seed=1, buckets=3, tenant_zipf_s=2.0)
        for name, lg in GENERATORS.items()}
    assert _schema(reports["port"]) == _schema(reports["ref"])
    assert set(reports["port"]["tenants"]) == {f"mt-{i}" for i in range(3)}
    for rep in reports.values():
        assert rep["status_counts"] == {"200": rep["requests"]}


def test_run_async_load_reports_match_the_reference(server):
    c = _client(server)
    reports = {}
    for name, lg in GENERATORS.items():
        assert c.make_bucket(f"fd-{name}").status == 200
        reports[name] = lg.run_async_load(
            "127.0.0.1", server, ACCESS, SECRET, f"fd-{name}",
            connections=12, duration=0.6, put_fraction=0.2,
            object_bytes=4096, key_space=8, seed=2)
    assert _schema(reports["port"]) == _schema(reports["ref"])
    for rep in reports.values():
        assert rep["established"] == 12 and rep["connect_failures"] == 0
        assert rep["errors_other"] == 0 and rep["requests"] > 0
        assert rep["status_counts"] == {"200": rep["requests"]}
    assert _keys(server, "fd-port") == _keys(server, "fd-ref") == \
        sorted(f"fdload/p{r}" for r in range(8))


def test_cli_client_imports_no_torch_and_no_jax(server):
    """``python -m minio_tpu_torch.tools.loadgen`` in a process of its own
    drives the server (the async fleet) and imports neither torch nor jax
    nor the JAX package."""
    code = (
        "import json, sys\n"
        "from minio_tpu_torch.tools import loadgen\n"
        f"sys.argv = ['loadgen', '--port', '{server}', '--access-key', "
        f"'{ACCESS}', '--secret-key', '{SECRET}', '--bucket', 'cli', "
        "'--make-bucket', '--connections', '8', '--duration', '0.5', "
        "'--put-fraction', '0.1', '--size', '4096', '--key-space', '4']\n"
        "rc = loadgen.main()\n"
        "print(json.dumps({'rc': rc, 'modules': sorted(m for m in "
        "sys.modules if m.split('.')[0] in ('torch', 'jax', 'minio_tpu'))}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    *report, last = out.stdout.strip().splitlines()
    assert json.loads(last) == {"rc": 0, "modules": []}
    rep = json.loads("\n".join(report))
    assert rep["established"] == 8 and rep["requests"] > 0
    assert rep["status_counts"] == {"200": rep["requests"]}
