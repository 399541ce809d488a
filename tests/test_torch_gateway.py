"""The port's gateways: NAS, S3, Azure, GCS and HDFS.

The bodies of the JAX package's ``tests/test_gateway.py`` and
``tests/test_cloud_gateways.py`` are collected here unchanged and run
against the port through ``test_torch_remap`` (the NAS gateway and the
upstream's drives on the CPU). The S3 gateway's cases run twice: over an
upstream port server and over an upstream JAX server. Then each cloud
gateway of both packages takes the same S3 requests against its own fake
backend, and the blobs the fakes end up holding must be equal; the same
for what the S3 gateways of both packages leave in one JAX upstream.
"""

from __future__ import annotations

import pytest

import test_cloud_gateways as _cloud
import test_gateway as _gw
from test_torch_remap import PortRemap

REMAP = PortRemap()
_GW = REMAP.collect(_gw, "gw", globals())
_CLOUD = REMAP.collect(_cloud, "cloud", globals())
ACCESS, SECRET = _gw.ACCESS, _gw.SECRET


@pytest.fixture(scope="module", autouse=True)
def _no_probe_ladder():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        yield


def _upstream_server(pkg: str, root):
    """An erasure server of either package on four CPU drives."""
    if pkg == "port":
        from minio_tpu_torch.erasure.engine import ErasureObjects
        from minio_tpu_torch.s3.server import S3Server
        from minio_tpu_torch.storage.xl import XLStorage
        disks = [XLStorage(str(root / f"d{i}"), device="cpu")
                 for i in range(4)]
        layer = ErasureObjects(disks, block_size=64 * 1024, backend="cpu",
                               device="cpu")
    else:
        from minio_tpu.erasure.engine import ErasureObjects
        from minio_tpu.s3.server import S3Server
        from minio_tpu.storage.xl import XLStorage
        layer = ErasureObjects([XLStorage(str(root / f"d{i}"))
                                for i in range(4)], block_size=64 * 1024)
    return S3Server(layer, ACCESS, SECRET)


@pytest.fixture(scope="module", params=["port", "ref"],
                ids=["port-upstream", "jax-upstream"])
def upstream(request, tmp_path_factory, _no_probe_ladder):
    """The remote store the port's S3 gateway fronts: a port server, then
    a JAX server."""
    srv = _upstream_server(request.param,
                           tmp_path_factory.mktemp("gw-upstream"))
    port = srv.start()
    yield srv, port
    srv.stop()


@pytest.fixture(scope="module")
def gw(upstream, tmp_path_factory):
    from minio_tpu_torch.gateway import S3Gateway
    from minio_tpu_torch.s3.server import S3Server
    _, up_port = upstream
    layer = S3Gateway("127.0.0.1", up_port, ACCESS, SECRET,
                      str(tmp_path_factory.mktemp("gw-meta"))
                      ).new_gateway_layer()
    srv = S3Server(layer, ACCESS, SECRET)
    port = srv.start()
    yield srv, port
    srv.stop()


@pytest.fixture
def gclient(gw):
    from minio_tpu_torch.s3.client import S3Client
    return S3Client("127.0.0.1", gw[1], ACCESS, SECRET)


@pytest.fixture
def uclient(upstream):
    from minio_tpu_torch.s3.client import S3Client
    return S3Client("127.0.0.1", upstream[1], ACCESS, SECRET)


def test_every_reference_case_was_collected():
    for mod, tag in ((_gw, "gw"), (_cloud, "cloud")):
        want = {n[5:] for n in vars(mod) if n.startswith("test_")}
        got = {n[len(tag) + 7:] for n in globals()
               if n.startswith(f"test_{tag}__")}
        assert got == want and want


def _gateway_pair(kind: str, port: int, tmp_path):
    """The same cloud gateway layer from each package."""
    from minio_tpu.gateway import cloud as ref_cloud
    from minio_tpu_torch.gateway import cloud as port_cloud
    out = {}
    for pkg, mod in (("ref", ref_cloud), ("port", port_cloud)):
        meta = str(tmp_path / f"{pkg}-meta")
        if kind == "azure":
            gw = mod.AzureGateway("127.0.0.1", port[pkg], "testacct",
                                  _cloud.AZ_KEY, meta)
        elif kind == "gcs":
            gw = mod.GCSGateway("127.0.0.1", port[pkg], "proj", meta)
        else:
            gw = mod.HDFSGateway("127.0.0.1", port[pkg], meta)
        out[pkg] = gw.new_gateway_layer()
    return out


HANDLERS = {"azure": _cloud._AzureHandler, "gcs": _cloud._GCSHandler,
            "hdfs": _cloud._HDFSHandler}


def _scripted(client) -> list:
    """PUTs, an overwrite, a DELETE and a listing; (status, body) each."""
    out = []
    out.append(client.make_bucket("cmpb").status)
    for i, size in enumerate((0, 1, 4097, 70_000)):
        body = bytes((i * 7 + j) % 251 for j in range(size))
        out.append(client.put_object("cmpb", f"k/{i}", body).status)
    out.append(client.put_object("cmpb", "k/1", b"over").status)
    out.append(client.request("DELETE", "/cmpb/k/0").status)
    r = client.request("GET", "/cmpb", query="list-type=2&prefix=k/")
    keys = sorted(part.split(b"</Key>")[0]
                  for part in r.body.split(b"<Key>")[1:])
    out.append((r.status, keys))
    return out


@pytest.mark.parametrize("kind", sorted(HANDLERS))
def test_cloud_gateway_backend_state_matches_reference(tmp_path, kind):
    """Both packages' gateways, each over its own fake backend, answer the
    scripted requests alike and leave the same blobs behind."""
    from minio_tpu.s3.client import S3Client as RefClient
    from minio_tpu.s3.server import S3Server as RefServer
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.server import S3Server
    fakes = {pkg: _cloud._FakeCloud(HANDLERS[kind]) for pkg in ("ref",
                                                                "port")}
    servers = []
    try:
        layers = _gateway_pair(kind, {p: f.port for p, f in fakes.items()},
                               tmp_path)
        answers = {}
        for pkg, (srv_cls, cl_cls) in (("ref", (RefServer, RefClient)),
                                       ("port", (S3Server, S3Client))):
            srv = srv_cls(layers[pkg], ACCESS, SECRET)
            servers.append(srv)
            answers[pkg] = _scripted(cl_cls("127.0.0.1", srv.start(),
                                            ACCESS, SECRET))
        assert answers["port"] == answers["ref"]
        assert fakes["port"].buckets == fakes["ref"].buckets
        assert fakes["port"].buckets
    finally:
        for srv in servers:
            srv.stop()
        for f in fakes.values():
            f.stop()


def test_s3_gateways_leave_the_same_upstream_objects(tmp_path):
    """The S3 gateway of each package in front of one JAX upstream: the
    same requests give the same answers and the same upstream objects."""
    from minio_tpu.gateway import S3Gateway as RefGateway
    from minio_tpu.s3.client import S3Client as RefClient
    from minio_tpu.s3.server import S3Server as RefServer
    from minio_tpu_torch.gateway import S3Gateway
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.server import S3Server
    up = _upstream_server("ref", tmp_path / "up")
    up_port = up.start()
    servers = [up]
    try:
        answers, objects = {}, {}
        for pkg, gw_cls, srv_cls, cl_cls in (
                ("ref", RefGateway, RefServer, RefClient),
                ("port", S3Gateway, S3Server, S3Client)):
            layer = gw_cls("127.0.0.1", up_port, ACCESS, SECRET,
                           str(tmp_path / f"{pkg}-meta")).new_gateway_layer()
            srv = srv_cls(layer, ACCESS, SECRET)
            servers.append(srv)
            answers[pkg] = _scripted(cl_cls("127.0.0.1", srv.start(),
                                            ACCESS, SECRET))
            uc = RefClient("127.0.0.1", up_port, ACCESS, SECRET)
            objects[pkg] = {k: uc.get_object("cmpb", k).body
                            for k in ("k/1", "k/2", "k/3")}
            assert uc.request("DELETE", "/cmpb/k/1").status == 204
            for k in ("k/2", "k/3"):
                uc.request("DELETE", f"/cmpb/{k}")
            assert uc.delete_bucket("cmpb").status == 204
        assert answers["port"] == answers["ref"]
        assert objects["port"] == objects["ref"]
        assert objects["port"]["k/1"] == b"over"
    finally:
        for srv in servers:
            srv.stop()
