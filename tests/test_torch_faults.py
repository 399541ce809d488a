"""Faults the JAX package's own suites exposed in the port, each held to
the reference side by side (ROADMAP §C, C5 and C6), and the reference's
concurrency schedule on both packages' servers.

- C5: SelectObjectContent through the S3, Azure, GCS and HDFS gateways
  answered 500 (their layers named no device for the scan); each now
  answers the reference gateway's body, byte for byte.
- C6: K2's plain version (``hh256_gpu.hash_chunks_plain``) took about two
  hundred tensor ops a 32-byte packet, each handing the GIL over, so
  concurrent hashes convoyed (six took 4.6x the sum of their serial
  times); it now takes about thirty, counted op by op.
- The mixed PUT/GET/DELETE schedule of tests/test_concurrency.py against a
  port server and a reference server: it finishes within its own wall
  deadline (thread joins, so a regression fails instead of hanging), no
  read is torn, and both packages end with the same objects.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_cloud_gateways as _cloud
import test_s3select as _sel

ACCESS, SECRET = "faultsadm", "faultsadm-secret"


@pytest.fixture(scope="module", autouse=True)
def _cpu_plane():
    from minio_tpu_torch.ops import batching
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        batching.set_dispatch_device("cpu")
        try:
            yield
        finally:
            batching.set_dispatch_device("cuda")


# ---------------------------------------------------------------------------
# C5: Select through the gateways


def _client(pkg, port):
    if pkg == "ref":
        from minio_tpu.s3.client import S3Client
    else:
        from minio_tpu_torch.s3.client import S3Client
    return S3Client("127.0.0.1", port, ACCESS, SECRET)


def _server(pkg, layer):
    if pkg == "ref":
        from minio_tpu.s3.server import S3Server
    else:
        from minio_tpu_torch.s3.server import S3Server
    return S3Server(layer, ACCESS, SECRET)


def _gateway_layer(pkg, kind, port, meta):
    """``kind``'s gateway layer of package ``pkg``; the port's on the
    CPU."""
    if pkg == "ref":
        from minio_tpu import gateway as gw
        kw = {}
    else:
        from minio_tpu_torch import gateway as gw
        kw = {"device": "cpu"}
    if kind == "s3":
        return gw.S3Gateway("127.0.0.1", port, ACCESS, SECRET, meta,
                            **kw).new_gateway_layer()
    if kind == "azure":
        return gw.AzureGateway("127.0.0.1", port, "testacct",
                               _cloud.AZ_KEY, meta, **kw).new_gateway_layer()
    if kind == "gcs":
        return gw.GCSGateway("127.0.0.1", port, "proj", meta,
                             **kw).new_gateway_layer()
    return gw.HDFSGateway("127.0.0.1", port, meta, **kw).new_gateway_layer()


def _ref_upstream(root):
    from minio_tpu.erasure.engine import ErasureObjects
    from minio_tpu.s3.server import S3Server
    from minio_tpu.storage.xl import XLStorage
    return S3Server(ErasureObjects([XLStorage(str(root / f"d{i}"))
                                    for i in range(4)],
                                   block_size=64 * 1024), ACCESS, SECRET)


SELECTS = [
    (b"SELECT name FROM S3Object WHERE city = 'paris'",
     b"<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"),
    (b"SELECT name, age FROM S3Object s WHERE CAST(s.age AS INT) > 26",
     b"<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"),
    (b"SELECT COUNT(*) FROM S3Object",
     b"<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"),
]


@pytest.mark.parametrize("kind", ["s3", "azure", "gcs", "hdfs"])
def test_gateway_select_matches_reference(tmp_path, kind):
    """Each package's ``kind`` gateway in front of its own backend takes
    the same PUT and SelectObjectContent requests: the port's bodies are
    the reference's, byte for byte (C5: the port answered 500)."""
    stops, bodies = [], {}
    try:
        for pkg in ("ref", "port"):
            if kind == "s3":
                up = _ref_upstream(tmp_path / f"{pkg}-up")
                backend_port = up.start()
                stops.append(up.stop)
            else:
                fake = _cloud._FakeCloud(
                    {"azure": _cloud._AzureHandler, "gcs": _cloud._GCSHandler,
                     "hdfs": _cloud._HDFSHandler}[kind])
                backend_port = fake.port
                stops.append(fake.stop)
            srv = _server(pkg, _gateway_layer(pkg, kind, backend_port,
                                              str(tmp_path / f"{pkg}-meta")))
            c = _client(pkg, srv.start())
            stops.append(srv.stop)
            assert c.make_bucket("selgw").status == 200
            assert c.put_object("selgw", "people.csv",
                                _sel.CSV_DATA).status == 200
            bodies[pkg] = []
            for expr, inp in SELECTS:
                r = c.request("POST", "/selgw/people.csv",
                              query="select=&select-type=2",
                              body=_sel._req_xml(expr, inp))
                bodies[pkg].append((r.status, r.body))
        assert [s for s, _ in bodies["port"]] == [200] * len(SELECTS)
        assert bodies["port"] == bodies["ref"]
    finally:
        for stop in reversed(stops):
            stop()


def test_gateway_layers_name_the_device_they_are_given(tmp_path):
    """Every gateway layer answers ``layer.device``; the card by
    default."""
    from minio_tpu_torch import gateway as gw
    layers = [
        gw.S3Gateway("127.0.0.1", 1, ACCESS, SECRET, str(tmp_path / "s3"),
                     device="cpu").new_gateway_layer(),
        gw.AzureGateway("127.0.0.1", 1, "a", _cloud.AZ_KEY,
                        str(tmp_path / "az"), device="cpu"
                        ).new_gateway_layer(),
        gw.GCSGateway("127.0.0.1", 1, "p", str(tmp_path / "gcs"),
                      device="cpu").new_gateway_layer(),
        gw.HDFSGateway("127.0.0.1", 1, str(tmp_path / "hdfs"),
                       device="cpu").new_gateway_layer(),
    ]
    assert [layer.device for layer in layers] == ["cpu"] * 4
    assert [layer.meta_disk.device for layer in layers] == ["cpu"] * 4
    assert gw.HDFSGateway("127.0.0.1", 1, str(tmp_path / "h2")
                          ).new_gateway_layer().device == "cuda"


# ---------------------------------------------------------------------------
# C6: K2's plain version under concurrent hashes


class _AtenCount(TorchDispatchMode):
    """Counts the aten ops issued under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _plain_ops(hash_plain, packets: int) -> int:
    x = torch.from_numpy(np.random.default_rng(packets).integers(
        0, 256, (4, 32 * packets), dtype=np.uint8))
    with _AtenCount() as count:
        hash_plain(x)
    return count.n


# aten ops a 32-byte packet may cost K2's plain version: the u64 chain
# takes 30 here, the old u32-pair chain 222 (each op hands the GIL over,
# so the old chain convoyed under six threads: 32.6 s where 7.1 s ran
# serially).
PLAIN_OPS_PER_PACKET = 50


def test_hh256_plain_keeps_its_pace_under_concurrency():
    """K2's plain version issues at most PLAIN_OPS_PER_PACKET aten ops a
    packet (counted between chunks of 16 and 48 packets, so the fixed
    finalisation cancels out), and six threads hashing at once each get
    the reference's digests."""
    from minio_tpu.ops.hh256 import hh256
    from minio_tpu_torch.ops import hh256_gpu
    per_packet = (_plain_ops(hh256_gpu.hash_chunks_plain, 48)
                  - _plain_ops(hh256_gpu.hash_chunks_plain, 16)) / 32
    assert per_packet <= PLAIN_OPS_PER_PACKET, per_packet
    rng = np.random.default_rng(6)
    rows = [torch.from_numpy(rng.integers(0, 256, (4, 8192 + 37 * i),
                                          dtype=np.uint8))
            for i in range(6)]
    out: dict[int, torch.Tensor] = {}
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, hh256_gpu.hash_chunks_plain(rows[i]))) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, r in enumerate(rows):
        want = [hh256(bytes(row)) for row in r.numpy()]
        assert [bytes(d) for d in out[i].numpy()] == want


# ---------------------------------------------------------------------------
# The mixed PUT/GET/DELETE schedule on both packages' servers

KEYS = [f"obj-{i}" for i in range(4)]
BODY = 96 * 1024
DEADLINE_S = 60.0


def _engine_server(pkg, root):
    """tests/test_concurrency.py's server: four drives, 64 KiB blocks;
    the port's engine and drives under "auto" on the CPU."""
    if pkg == "ref":
        return _ref_upstream(root)
    from minio_tpu_torch.erasure.engine import ErasureObjects
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.xl import XLStorage
    disks = [XLStorage(str(root / f"d{i}"), device="auto") for i in range(4)]
    return S3Server(ErasureObjects(disks, block_size=64 * 1024,
                                   backend="auto", device="cpu"),
                    ACCESS, SECRET)


def _mixed_schedule(pkg, port) -> tuple[list[str], dict]:
    """6 writers x 12 PUTs over 4 keys, 3 readers and 1 deleter of the
    first key while they run, then one last DELETE of it. Returns the
    errors (torn reads among them) and the final objects."""
    c0 = _client(pkg, port)
    assert c0.make_bucket("stress").status in (200, 204)
    bodies = {w: bytes([w]) * BODY for w in range(6)}
    errors: list[str] = []
    stop = threading.Event()

    def writer(w):
        c = _client(pkg, port)
        for i in range(12):
            k = KEYS[(w + i) % len(KEYS)]
            r = c.put_object("stress", k, bodies[w])
            if r.status != 200:
                errors.append(f"put {k}: {r.status}")

    def reader():
        c = _client(pkg, port)
        while not stop.is_set():
            for k in KEYS:
                r = c.get_object("stress", k)
                if r.status == 404:
                    continue
                if r.status != 200:
                    errors.append(f"get {k}: {r.status}")
                elif len(set(r.body)) != 1 or len(r.body) != BODY:
                    errors.append(f"torn read {k}: len={len(r.body)}")

    def deleter():
        c = _client(pkg, port)
        while not stop.is_set():
            r = c.request("DELETE", "/stress/" + KEYS[0])
            if r.status not in (200, 204):
                errors.append(f"delete: {r.status}")

    writers = [threading.Thread(target=writer, args=(w,), daemon=True)
               for w in range(6)]
    others = [threading.Thread(target=reader, daemon=True)
              for _ in range(3)] + [threading.Thread(target=deleter,
                                                     daemon=True)]
    deadline = time.monotonic() + DEADLINE_S
    for t in writers + others:
        t.start()
    for t in writers:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    stop.set()
    for t in others:
        t.join(timeout=max(0.0, deadline + 10 - time.monotonic()))
    wedged = [t.name for t in writers + others if t.is_alive()]
    assert not wedged, f"{pkg}: {wedged} still running after " \
                       f"{DEADLINE_S} s"
    assert c0.request("DELETE", "/stress/" + KEYS[0]).status in (200, 204)
    final = {}
    for k in KEYS:
        r = c0.get_object("stress", k)
        final[k] = (r.status, sorted(set(r.body)) if r.status == 200
                    else None, len(r.body) if r.status == 200 else None)
    return errors, final


def test_mixed_ops_schedule_matches_reference(tmp_path):
    """Both servers finish the schedule within the deadline with no error
    and no torn read, and end with the same keys, each holding one
    writer's complete body."""
    results = {}
    for pkg in ("ref", "port"):
        srv = _engine_server(pkg, tmp_path / pkg)
        try:
            results[pkg] = _mixed_schedule(pkg, srv.start())
        finally:
            srv.stop()
    for pkg, (errors, final) in results.items():
        assert not errors, (pkg, errors[:10])
        assert final[KEYS[0]][0] == 404
        for k in KEYS[1:]:
            status, values, size = final[k]
            assert status == 200 and len(values) == 1 and size == BODY, \
                (pkg, k)
    shape = {pkg: {k: (s, n) for k, (s, _, n) in final.items()}
             for pkg, (_, final) in results.items()}
    assert shape["port"] == shape["ref"]


# ---------------------------------------------------------------------------
# C7: a CPU node of the port's CLI heals as the reference's does

HEAL_NODES, HEAL_DRIVES = 3, 2          # six drives: EC 3+3
HEAL_OBJECTS, HEAL_BODY = 4, 1_000_000
# How far the port's heal may trail the reference's: the reference's time
# plus this many seconds (a pinned CPU node never converged in 60 s).
HEAL_MARGIN_S = 10.0
HEAL_DEADLINE_S = 90.0


class _CliCluster:
    """``HEAL_NODES`` CLI nodes of package ``pkg`` (``python -m pkg
    server`` over one endpoint list) on the CPU, each logging to a file,
    with the new-drive monitor at 0.5 s and no probe ladder."""

    def __init__(self, pkg: str, root):
        import socket
        self.pkg, self.root = pkg, str(root)
        socks = [socket.socket() for _ in range(HEAL_NODES)]
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        self.ports = [sk.getsockname()[1] for sk in socks]
        for sk in socks:
            sk.close()
        self.endpoints = [f"http://127.0.0.1:{p}{self.root}/n{i}/d{d}"
                          for i, p in enumerate(self.ports)
                          for d in range(1, HEAL_DRIVES + 1)]
        self.procs: list = [None] * HEAL_NODES

    def drives(self, i: int) -> list[str]:
        return [f"{self.root}/n{i}/d{d}" for d in range(1, HEAL_DRIVES + 1)]

    def start(self, i: int):
        import os
        import subprocess
        import sys
        os.makedirs(self.root, exist_ok=True)
        log = f"{self.root}/node{i}.log"
        env = dict(os.environ, MINIO_ACCESS_KEY=ACCESS,
                   MINIO_SECRET_KEY=SECRET, JAX_PLATFORMS="cpu",
                   MINIO_TORCH_DEVICE="cpu", MINIO_CODEC_PROBE_ON_BOOT="off",
                   MINIO_HEAL_NEWDISK_INTERVAL="0.5",
                   MINIO_CRAWLER_INTERVAL="3600")
        with open(log, "ab") as f:
            off = f.tell()
            self.procs[i] = subprocess.Popen(
                [sys.executable, "-m", self.pkg, "server", *self.endpoints,
                 "--address", f"127.0.0.1:{self.ports[i]}"],
                stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                    __file__))))
        return log, off

    @staticmethod
    def wait_ready(proc, log: str, off: int, timeout: float = 90.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with open(log, "rb") as f:
                f.seek(off)
                if b"listening on" in f.read():
                    return
            assert proc.poll() is None, open(log, "rb").read()[-2000:]
            time.sleep(0.1)
        raise TimeoutError(f"{log}: not ready")

    def boot(self, nodes) -> None:
        started = [(i, *self.start(i)) for i in nodes]
        for i, log, off in started:
            self.wait_ready(self.procs[i], log, off)

    def kill(self, i: int) -> None:
        import signal
        self.procs[i].send_signal(signal.SIGKILL)
        self.procs[i].wait(timeout=10)

    def stop(self) -> None:
        for i, p in enumerate(self.procs):
            if p is not None and p.poll() is None:
                self.kill(i)

    def shards(self, i: int, bucket: str, key: str) -> int:
        import os
        return sum(f.startswith("part.")
                   for d in self.drives(i)
                   for _, _, files in os.walk(os.path.join(d, bucket, key))
                   for f in files)


def _wipe_and_heal(pkg: str, root) -> float:
    """Boot ``pkg``'s cluster, PUT the objects, kill node 1, wipe its
    drives, restart it: seconds until the new-drive monitor has every
    shard back on them (HEAL_DEADLINE_S if it never gets there); then
    every object reads back from both nodes."""
    import os
    import shutil
    cl = _CliCluster(pkg, root)
    rng = np.random.default_rng(7)
    bodies = {f"o{i}": rng.integers(0, 256, HEAL_BODY, np.uint8).tobytes()
              for i in range(HEAL_OBJECTS)}
    try:
        cl.boot(range(HEAL_NODES))
        c = _client("ref" if pkg == "minio_tpu" else "port", cl.ports[0])
        assert c.make_bucket("heal").status == 200
        for k, b in bodies.items():
            assert c.put_object("heal", k, b).status == 200
        cl.kill(1)
        for d in cl.drives(1):
            shutil.rmtree(d)
            os.makedirs(d)
        cl.boot([1])
        t0 = time.monotonic()
        while time.monotonic() - t0 < HEAL_DEADLINE_S:
            if all(cl.shards(1, "heal", k) == HEAL_DRIVES for k in bodies):
                break
            time.sleep(0.1)
        took = time.monotonic() - t0
        for i in range(HEAL_NODES):
            ci = _client("ref" if pkg == "minio_tpu" else "port",
                         cl.ports[i])
            for k, b in bodies.items():
                r = ci.get_object("heal", k)
                assert r.status == 200 and r.body == b, (pkg, i, k)
        return took
    finally:
        cl.stop()


def test_cpu_cli_node_heals_a_wiped_drive_as_the_reference(tmp_path):
    """The wiped drives of one node of a three-node CLI cluster on the CPU
    (EC 3+3, the reference fault harness's shape) are
    healed back to full shards by the port's nodes within the reference
    cluster's time plus HEAL_MARGIN_S (C7: a CPU node pinned its engines
    to the kernels' plain versions and fell behind)."""
    ref_s = _wipe_and_heal("minio_tpu", tmp_path / "ref")
    port_s = _wipe_and_heal("minio_tpu_torch", tmp_path / "port")
    assert ref_s < HEAL_DEADLINE_S, f"the reference never healed: {ref_s}"
    assert port_s <= ref_s + HEAL_MARGIN_S, (port_s, ref_s)

