"""The JAX package's own S3 API suites, run against the port's server.

The test bodies of ``tests/test_s3_api.py``, ``test_s3_api_ext.py``,
``test_objectlock.py``, ``test_versioning.py`` and ``test_webrpc.py``
that speak only HTTP through their ``server`` / ``client`` / ``token``
fixtures are collected here unchanged (the files themselves are not
edited), with those fixtures supplied by the port: a port ``S3Server``
over four CPU drives, ``ErasureObjects(..., backend="cpu",
device="cpu")`` on ``XLStorage(root, device="cpu")``, with the codec
probe ladder off. Each suite keeps its own credentials (its module's
``ACCESS`` / ``SECRET``), so a server is booted per suite. Bodies that
build the reference's own engine or server (``layer``, ``tmp_path``,
``sink``) stay with the reference."""

from __future__ import annotations

import inspect
import os

import pytest

import test_objectlock as _objectlock
import test_s3_api as _api
import test_s3_api_ext as _api_ext
import test_versioning as _versioning
import test_webrpc as _webrpc
from minio_tpu_torch.erasure.engine import ErasureObjects
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage.xl import XLStorage

SUITES = (("api", _api), ("api_ext", _api_ext),
          ("objectlock", _objectlock), ("versioning", _versioning),
          ("webrpc", _webrpc))
HTTP_FIXTURES = {"server", "client", "token"}

for _tag, _mod in SUITES:
    for _name, _fn in sorted(vars(_mod).items()):
        if _name.startswith("test_") and inspect.isfunction(_fn) and \
                set(inspect.signature(_fn).parameters) <= HTTP_FIXTURES:
            globals()[f"test_{_tag}__{_name[5:]}"] = _fn
del _tag, _mod, _name, _fn


@pytest.fixture(scope="module")
def _servers(tmp_path_factory):
    """One port server per suite's credentials, booted on first use."""
    booted: dict = {}

    def get(access: str, secret: str):
        if (access, secret) not in booted:
            root = tmp_path_factory.mktemp("port-s3api")
            disks = [XLStorage(str(root / f"d{i}"), device="cpu")
                     for i in range(4)]
            layer = ErasureObjects(disks, block_size=8192, backend="cpu",
                                   device="cpu")
            srv = S3Server(layer, access, secret)
            booted[access, secret] = (srv, srv.start())
        return booted[access, secret]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        try:
            yield get
        finally:
            for srv, _ in booted.values():
                srv.stop()


@pytest.fixture
def server(request, _servers):
    g = request.function.__globals__
    return _servers(g["ACCESS"], g["SECRET"])


@pytest.fixture
def client(request, server):
    g = request.function.__globals__
    return S3Client("127.0.0.1", server[1], g["ACCESS"], g["SECRET"])


@pytest.fixture
def token(request, server):
    """``test_webrpc.py``'s login, against the suite's port server."""
    g = request.function.__globals__
    out = _webrpc._rpc(server[1], "Login", {"username": g["ACCESS"],
                                            "password": g["SECRET"]})
    return out["result"]["token"]


def test_every_http_body_was_collected():
    names = [n for n in globals() if "__" in n and n.startswith("test_")]
    assert len(names) >= 40
    assert os.environ.get("MINIO_CODEC_PROBE_ON_BOOT") != "on"
