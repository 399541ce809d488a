"""The port's S3 front door: its device seam, its threads and its imports.

- Select runs on the object layer's device (``layer.device``): a
  CPU-built stack serves it with ``torch.cuda`` poisoned; a card-built
  stack cannot be built without a card; ``ErasureSets`` and
  ``ErasureServerPools`` read the device back from their engines, and
  ``FSObjects`` takes one, the card by default.
- After ``stop()`` no thread that the port's server started is alive,
  on either front door. This file boots no other server, so no server
  of the port is up while the census is taken.
- Every module of the port imports with ``jax``, ``triton`` and
  ``minio_tpu`` unimportable.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from minio_tpu_torch.erasure.engine import ErasureObjects
from minio_tpu_torch.parallel.quorum import parallel_map
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.s3select.select import parse_request, run_select
from minio_tpu_torch.storage.xl import XLStorage
from test_torch_s3_server import (ACCESS, BLOCK, CSV_BODY, DOORS, DRIVES,
                                  SECRET, SELECT_CSV, SELECT_PARQUET, SMALL,
                                  boot_port, chip_parquet, serving_env)
from minio_tpu_torch.s3select import parquet as port_pq

ROOT = Path(__file__).resolve().parent.parent


def test_select_runs_on_a_cpu_stack_with_cuda_poisoned(tmp_path,
                                                       monkeypatch):
    """A CPU-built stack selects on the CPU and never asks for CUDA."""
    def poisoned(*a, **k):
        raise AssertionError("torch.cuda touched by a CPU-built stack")
    with serving_env("async"):
        side = boot_port(str(tmp_path))
        try:
            assert side.srv.layer.device == torch.device("cpu")
            side.c.make_bucket("sel")
            side.c.put_object("sel", "t.parquet", chip_parquet(port_pq))
            for name in ("is_available", "current_device", "synchronize",
                         "device_count"):
                monkeypatch.setattr(torch.cuda, name, poisoned)
            r = side.c.request("POST", "/sel/t.parquet",
                               query="select=&select-type=2",
                               body=SELECT_PARQUET)
        finally:
            monkeypatch.undo()
            side.srv.stop()
    assert r.status == 200
    assert r.body == run_select(parse_request(SELECT_PARQUET),
                                chip_parquet(port_pq), device="cpu")


def test_card_stack_cannot_be_built_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    disks = [XLStorage(str(tmp_path / f"d{i}")) for i in range(DRIVES)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ErasureObjects(disks, 2, 2, block_size=BLOCK)


def test_sets_and_pools_expose_their_engines_device(tmp_path):
    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.storage.format import init_or_load_formats
    disks = [XLStorage(str(tmp_path / f"d{i}"), device="cpu")
             for i in range(DRIVES)]
    fmt, ordered, _ = init_or_load_formats(disks, set_size=DRIVES)
    sets = ErasureSets(ordered, [DRIVES], fmt.deployment_id,
                       block_size=BLOCK, backend="cpu", device="cpu")
    pools = ErasureServerPools([sets])
    try:
        assert sets.device == pools.device == torch.device("cpu")
        assert sets.device == sets.sets[0].bitrot_device
    finally:
        pools.shutdown()


def test_fs_layer_scans_where_it_is_told(tmp_path):
    """``FSObjects`` takes a ``device`` (the card by default, as
    ``XLStorage``): on the CPU its Select scans on the CPU; on the card's
    default it raises without a card and never scans on the host."""
    from minio_tpu_torch.fs.backend import FSObjects
    with serving_env("async"):
        cpu_fs = FSObjects(str(tmp_path / "cpu"), device="cpu")
        srv = S3Server(cpu_fs, ACCESS, SECRET)
        port = srv.start()
        try:
            c = S3Client("127.0.0.1", port, ACCESS, SECRET)
            c.make_bucket("fsb")
            c.put_object("fsb", "t.csv", CSV_BODY)
            r = c.request("POST", "/fsb/t.csv",
                          query="select=&select-type=2", body=SELECT_CSV)
        finally:
            srv.stop()
        assert r.status == 200
        assert r.body == run_select(parse_request(SELECT_CSV), CSV_BODY,
                                    device="cpu")
        card_fs = FSObjects(str(tmp_path / "card"))
        assert card_fs.device == "cuda"
        if not torch.cuda.is_available():
            srv = S3Server(card_fs, ACCESS, SECRET)
            port = srv.start()
            try:
                c = S3Client("127.0.0.1", port, ACCESS, SECRET)
                c.make_bucket("fsb")
                c.put_object("fsb", "t.csv", CSV_BODY)
                r = c.request("POST", "/fsb/t.csv",
                              query="select=&select-type=2",
                              body=SELECT_CSV)
            finally:
                srv.stop()
            assert r.status == 500


# ---------------------------------------------------------------------------
# Threads


@pytest.mark.parametrize("door", DOORS)
def test_no_thread_outlives_stop(tmp_path, door):
    """Boot, serve, stop: no thread the port's server started is alive
    afterwards -- not the front door's loops and pools, the timeline
    sampler, the loop monitor, the watchdog, replication, the notifier or
    audit. The quorum pool is process-wide (warmed up first), and a
    recovery probe the sampler started may take a moment to end."""
    parallel_map([lambda: time.sleep(0.01)] * 16)
    before = set(threading.enumerate())
    with serving_env(door):
        side = boot_port(str(tmp_path))
        assert side.c.make_bucket("census").status == 200
        assert side.c.put_object("census", "o", SMALL).status == 200
        assert side.c.get_object("census", "o").body == SMALL
        assert side.c.list_objects_v2("census").status == 200
        assert side.c.request("GET", "/minio-tpu/metrics").status == 200
        side.srv.stop()
    deadline = time.monotonic() + 5
    while True:
        left = [t for t in set(threading.enumerate()) - before
                if t.is_alive() and not runs_the_reference(t)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert [t.name for t in left] == []


def runs_the_reference(t: threading.Thread) -> bool:
    """A thread whose stack is in the JAX package (a sampler or probe a
    reference server of an earlier test left running) is not the port's;
    both packages name their threads alike."""
    frame = sys._current_frames().get(t.ident)
    while frame is not None:
        parts = Path(frame.f_code.co_filename).parts
        if "minio_tpu" in parts:
            return True
        frame = frame.f_back
    return False


_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "triton", "minio_tpu"):
    sys.modules[name] = None
import minio_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    minio_tpu_torch.__path__, "minio_tpu_torch.")
    if not m.name.endswith("__main__"))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "triton", "minio_tpu")))
print(" ".join(names))
print(bad)
"""

# The modules of the S3 front door's slice, at the reference's paths.
SLICE = """s3 s3.xmlutil s3.errors s3.sigv4 s3.client utils.pubsub
utils.bandwidth utils.httpjson utils.certs obs.usage obs.slowlog
obs.loopmon obs.timeline obs.watchdog obs.incidents qos.admission rpc
rpc.transport rpc.aio iam iam.policy iam.iam iam.ldap iam.oidc crypto.kms
logger.audit bucket bucket.metadata bucket.objectlock bucket.replication
bucket.tiering event event.event event.rules event.targets event.notifier
fs fs.backend s3.formupload s3.console s3.webrpc s3.admin s3.server
s3.asyncserver""".split()


def test_every_module_imports_without_jax_triton_or_the_reference():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MTPU_LOCKTRACE",)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names, bad = out.stdout.splitlines()
    assert bad == "[]"
    assert len(SLICE) == 44
    assert {f"minio_tpu_torch.{m}" for m in SLICE} <= set(names.split())


# ---------------------------------------------------------------------------
# On the card (skip here)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("door", DOORS)
def test_http_put_get_select_on_a_card_stack(cuda_device, tmp_path, door):
    """A port server over a card-built stack: a PUT and a GET over HTTP
    launch K1 and K2, a degraded GET launches K1 to rebuild, a Select over
    HTTP launches X2, and every body equals the CPU's answer."""
    from minio_tpu_torch.ops import hh256_gpu, rs_gpu
    from minio_tpu_torch.ops import select_kernels as sk
    disks = [XLStorage(str(tmp_path / f"d{i}"), device=cuda_device)
             for i in range(DRIVES)]
    layer = ErasureObjects(disks, 2, 2, block_size=BLOCK)
    table = chip_parquet(port_pq, n=65_536)
    with serving_env(door):
        srv = S3Server(layer, ACCESS, SECRET)
        port = srv.start()
        try:
            assert srv.layer.device.type == "cuda"
            c = S3Client("127.0.0.1", port, ACCESS, SECRET)
            assert c.make_bucket("card").status == 200
            rs_gpu.gf_apply_cuda.launches = 0
            hh256_gpu.hash_chunks_cuda.launches = 0
            sk.select_scan_cuda.launches = 0
            assert c.put_object("card", "o", SMALL).status == 200
            assert c.get_object("card", "o").body == SMALL
            assert rs_gpu.gf_apply_cuda.launches > 0
            assert hh256_gpu.hash_chunks_cuda.launches > 0
            layer.mrf.start = lambda: None
            import shutil
            shutil.rmtree(tmp_path / "d0" / "card" / "o")
            before = rs_gpu.gf_apply_cuda.launches
            assert c.get_object("card", "o").body == SMALL
            assert rs_gpu.gf_apply_cuda.launches > before
            assert c.put_object("card", "t.parquet", table).status == 200
            r = c.request("POST", "/card/t.parquet",
                          query="select=&select-type=2",
                          body=SELECT_PARQUET)
            assert r.status == 200
            assert sk.select_scan_cuda.launches > 0
            assert r.body == run_select(parse_request(SELECT_PARQUET), table,
                                        device="cpu")
        finally:
            srv.stop()
