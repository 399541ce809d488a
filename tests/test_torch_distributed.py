"""Distributed mode of the port: in-process clusters on localhost ports.

The bodies of the JAX package's ``tests/test_distributed.py`` and
``tests/test_rpc_fabric.py``, and the CLI and foreign-disk cases of
``tests/test_topology.py``, are collected here unchanged (the files are
not edited) and run against the port through ``test_torch_remap``: every
``minio_tpu`` name they reach is the port's, and every drive and erasure
set the cluster builder makes runs on the CPU (``device="cpu"``). Their
fixtures are the reference's, built from the remapped helpers.

Then the packages meet on the wire: a two-node cluster with one node of
each package, formed from one endpoint list, reads back through either
node what the other wrote, and every drive's part files equal those of an
all-JAX cluster given the same objects. Every server here boots with
``MINIO_CODEC_PROBE_ON_BOOT=off``, and the port's RPC loop stops with the
module.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

import test_distributed as _dist
import test_rpc_fabric as _fabric
import test_topology as _topo
from test_torch_remap import PortRemap, stop_rpc_loop

REMAP = PortRemap()
_DIST = REMAP.collect(_dist, "dist", globals())
_FABRIC = REMAP.collect(_fabric, "fabric", globals())
_TOPO = REMAP.namespace(_topo)
test_topo__cli_builds_pools = _TOPO["test_cli_builds_pools"]
test_topo__foreign_disk_refused = _TOPO["test_foreign_disk_refused"]


@pytest.fixture(scope="module", autouse=True)
def _no_probe_ladder():
    """No server here starts a probe ladder, and the port's RPC loop
    stops with the module, so no thread and no loop registered with the
    loop monitor outlive it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        try:
            yield
        finally:
            stop_rpc_loop()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, _no_probe_ladder):
    """``tests/test_distributed.py``'s two-node, four-drive cluster, of
    port nodes."""
    tmp = tmp_path_factory.mktemp("cluster")
    servers, ports, nodes = _DIST["_start_cluster"](tmp, n_nodes=2,
                                                    disks_per_node=2)
    yield servers, ports, nodes, tmp
    for srv, _ in servers:
        srv.stop()


@pytest.fixture()
def echo_server(_no_probe_ladder):
    srv, port, svc = _FABRIC["_start_rpc_server"]()
    yield port, svc
    srv.stop()


def test_every_reference_case_was_collected():
    names = [n for n in globals() if n.startswith(("test_dist__",
                                                   "test_fabric__",
                                                   "test_topo__"))]
    want = sum(1 for mod in (_dist, _fabric) for n in vars(mod)
               if n.startswith("test_"))
    assert len(names) == want + 2 and want >= 30


def test_cluster_metrics_report_the_ports_dispatch_counters(cluster):
    """``rpc_metrics`` answers with the port's ``STATS`` / ``HH_STATS``
    (the counters every K1 and K2 dispatch of the node moves), by the
    reference's keys."""
    from minio_tpu_torch.ops import batching
    servers, ports, nodes, tmp = cluster
    _DIST["_wire_peer_plane"](servers, nodes)
    out, _ = nodes[0].peer_service.rpc_metrics({}, b"")
    assert out["rs"] == batching.STATS.snapshot()
    assert out["bitrot"] == batching.HH_STATS.snapshot()
    assert set(out["rs"]) >= {"tpu_dispatches", "cpu_dispatches"}
    peers = nodes[0].notification.metrics_all()
    assert peers and all(v["bitrot"].keys() == out["bitrot"].keys()
                         for v in peers.values())


# ---------------------------------------------------------------------------
# One node of each package in one cluster

ACCESS, SECRET = "mixedak", "mixedsk"
BLOCK = 16 * 1024


def _boot(pkgs: tuple, root) -> tuple:
    """A cluster of one node per entry of ``pkgs`` ("ref" or "port"),
    two drives each, from one explicit endpoint list; returns (servers,
    ports, nodes, drive roots in endpoint order)."""
    from minio_tpu.rpc import cluster as ref_cluster
    from minio_tpu.rpc import transport as ref_transport
    from minio_tpu.s3 import server as ref_server
    from minio_tpu_torch.rpc import cluster as port_cluster
    from minio_tpu_torch.rpc import transport as port_transport
    from minio_tpu_torch.s3 import server as port_server
    mods = {"ref": (ref_cluster, ref_transport, ref_server),
            "port": (port_cluster, port_transport, port_server)}
    servers, ports = [], []
    for pkg in pkgs:
        cl, tr, sv = mods[pkg]
        reg = tr.RPCRegistry(cl.derive_cluster_key(ACCESS, SECRET))
        srv = sv.S3Server(None, ACCESS, SECRET, rpc_registry=reg)
        servers.append((srv, reg))
        ports.append(srv.start("127.0.0.1", 0))
    roots = [str(root / f"n{i}" / f"d{d}") for i in range(len(pkgs))
             for d in (1, 2)]
    endpoints = [f"http://127.0.0.1:{ports[i // 2]}{r}"
                 for i, r in enumerate(roots)]
    nodes, errors = [None] * len(pkgs), []

    def boot(i):
        try:
            cl = mods[pkgs[i]][0]
            kw = {"device": "cpu"} if pkgs[i] == "port" else {}
            nodes[i] = cl.build_cluster_node(
                endpoints, "127.0.0.1", ports[i], ACCESS, SECRET,
                block_size=BLOCK, registry=servers[i][1],
                format_timeout=20.0, **kw)
            servers[i][0].set_layer(nodes[i].layer)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=boot, args=(i,))
               for i in range(len(pkgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return servers, ports, nodes, roots


def _part_files(roots: list, bucket: str, obj: str) -> list:
    """Every drive's part files of ``obj`` (in endpoint order), by file
    name; the data dir's uuid differs from cluster to cluster."""
    out = []
    for r in roots:
        odir = os.path.join(r, bucket, obj)
        files = {}
        for dd in sorted(os.listdir(odir)):
            if os.path.isdir(os.path.join(odir, dd)):
                for f in sorted(os.listdir(os.path.join(odir, dd))):
                    with open(os.path.join(odir, dd, f), "rb") as fh:
                        files[f] = fh.read()
        out.append(files)
    return out


OBJECTS = {"via-ref": 3 * BLOCK + 777, "via-port": 5 * BLOCK,
           "small": 1000}


@pytest.fixture(scope="module")
def mixed(tmp_path_factory, _no_probe_ladder):
    """(mixed cluster, all-JAX cluster), each given the same objects: the
    ones named ``via-ref`` PUT through the JAX node, the rest through the
    port node (on the all-JAX cluster, through nodes 0 and 1 alike)."""
    from minio_tpu.ops.autotune import AUTOTUNE
    from minio_tpu.s3.client import S3Client
    clusters = []
    with pytest.MonkeyPatch.context() as mp:
        # A layer-less JAX server always starts its probe ladder; it has
        # nothing to measure here and must leave no thread behind.
        mp.setattr(AUTOTUNE, "_probed", True)
        try:
            for pkgs in (("ref", "port"), ("ref", "ref")):
                servers, ports, nodes, roots = _boot(
                    pkgs, tmp_path_factory.mktemp("-".join(pkgs)))
                clusters.append((servers, ports, nodes, roots))
                c = [S3Client("127.0.0.1", p, ACCESS, SECRET) for p in ports]
                assert c[1].make_bucket("mixed").status == 200
                for i, (name, size) in enumerate(OBJECTS.items()):
                    body = np.random.default_rng(i).integers(
                        0, 256, size, dtype=np.uint8).tobytes()
                    via = 0 if name == "via-ref" else 1
                    assert c[via].put_object("mixed", name,
                                             body).status == 200
            yield clusters
        finally:
            for servers, *_ in clusters:
                for srv, _ in servers:
                    srv.stop()


@pytest.mark.parametrize("name", sorted(OBJECTS))
@pytest.mark.parametrize("reader", [0, 1], ids=["ref-node", "port-node"])
def test_mixed_cluster_reads_across_packages(mixed, name, reader):
    """Either node of the mixed cluster reads back byte-exact what either
    node wrote."""
    from minio_tpu.s3.client import S3Client
    servers, ports, nodes, roots = mixed[0]
    i = list(OBJECTS).index(name)
    want = np.random.default_rng(i).integers(
        0, 256, OBJECTS[name], dtype=np.uint8).tobytes()
    r = S3Client("127.0.0.1", ports[reader], ACCESS,
                 SECRET).get_object("mixed", name)
    assert r.status == 200 and r.body == want


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_mixed_cluster_part_files_equal_an_all_jax_cluster(mixed, name):
    """Every drive of the mixed cluster holds the part files an all-JAX
    cluster holds for the same object: the port node's shards crossed the
    wire to the JAX node's drives and back as the reference frames them."""
    (_, _, _, mroots), (_, _, _, rroots) = mixed
    got = _part_files(mroots, "mixed", name)
    want = _part_files(rroots, "mixed", name)
    assert got == want
    assert all(files for files in got)


def test_rpc_loop_stops_and_starts_again(echo_server):
    """Once this module's teardown has stopped the fabric's loop (its
    thread joined, its loop off the loop monitor), the next call starts
    a fresh loop and registers it again."""
    from minio_tpu_torch.obs.loopmon import LOOPMON
    from minio_tpu_torch.rpc.aio import RPC_LOOP
    from minio_tpu_torch.rpc.transport import RPCClient
    port, _svc = echo_server
    for _ in range(2):
        cl = RPCClient("127.0.0.1", port, _FABRIC["KEY"])
        try:
            assert cl.call("test", "echo", {"x": 5})[0]["echo"] == 5
        finally:
            cl.close()
        thread = RPC_LOOP._thread
        assert thread is not None and "rpc" in LOOPMON._loops
        stop_rpc_loop()
        assert not thread.is_alive() and "rpc" not in LOOPMON._loops
