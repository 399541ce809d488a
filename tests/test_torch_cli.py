"""The port's CLI, ``python -m minio_tpu_torch``, against the reference's.

Both packages' CLIs boot as subprocesses on the same layout: the
reference with ``JAX_PLATFORMS=cpu``, the port with
``MINIO_TORCH_DEVICE=cpu``. One scripted sequence of SigV4 requests goes
to each; statuses, the compared headers and the bodies (times and request
ids masked) must be equal, and so must every drive's part files. Then
SIGTERM (exit 0, no traceback) and a restart of the port's node that reads
the objects back; the port's ``server`` and ``gateway nas`` without a card
and without the CPU request (exit 1, never ``listening on``); ``gateway
nas`` of both packages; ``update --dry-run`` of both against one local
release endpoint; and the PUT and heal write-back crash points of the
JAX package's ``tests/test_crash_consistency.py`` through the port's CLI
(its bodies, run by ``test_torch_remap``).

Every node logs to a file, never to an unread pipe, runs with the codec
probe ladder off, and is stopped by its fixture.
"""

from __future__ import annotations

import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import test_crash_consistency as _crash
import test_update as _update
from test_torch_distributed import _part_files
from test_torch_remap import PortRemap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCESS, SECRET = "cliadmin", "cliadmin-secret"
BLOCK = 16 * 1024
PACKAGES = {"ref": "minio_tpu", "port": "minio_tpu_torch"}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(pkg: str, **extra) -> dict:
    env = dict(os.environ, MINIO_ACCESS_KEY=ACCESS, MINIO_SECRET_KEY=SECRET,
               MINIO_CODEC_PROBE_ON_BOOT="off",
               MINIO_CRAWLER_INTERVAL="3600",
               MINIO_HEAL_NEWDISK_INTERVAL="3600")
    env.pop("MINIO_TORCH_DEVICE", None)
    if pkg == "ref":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env["MINIO_TORCH_DEVICE"] = "cpu"
    env.update(extra)
    return env


class CLINode:
    """One ``python -m <package> <args>`` process on a fixed port, logging
    to a file; restarts keep the port, so clients survive them."""

    def __init__(self, pkg: str, root, args: list, env: dict | None = None):
        self.pkg = pkg
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.args = args
        self.env = env or _env(pkg)
        self.log = os.path.join(self.root, f"{pkg}.log")
        self.port = _free_port()
        self.proc = None
        self._off = 0

    def start(self, timeout: float = 90) -> None:
        try:
            self._off = os.path.getsize(self.log)
        except OSError:
            self._off = 0
        with open(self.log, "ab") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", PACKAGES[self.pkg], *self.args,
                 "--address", f"127.0.0.1:{self.port}"],
                stdout=log, stderr=subprocess.STDOUT, env=self.env, cwd=REPO)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if b"listening on" in self.output():
                return
            if self.proc.poll() is not None:
                raise RuntimeError(f"{self.pkg} node died during boot: rc="
                                   f"{self.proc.returncode}\n"
                                   f"{self.output()[-2000:]!r}")
            time.sleep(0.1)
        raise TimeoutError(f"{self.pkg} node not ready")

    def output(self) -> bytes:
        """What this boot of the node logged."""
        try:
            with open(self.log, "rb") as f:
                f.seek(self._off)
                return f.read()
        except FileNotFoundError:
            return b""

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def wait_dead(self, timeout: float = 60) -> int:
        return self.proc.wait(timeout=timeout)

    def terminate(self, timeout: float = 30) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=timeout)

    def kill9(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.alive():
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=10)

    def client(self):
        from minio_tpu_torch.s3.client import S3Client
        return S3Client("127.0.0.1", self.port, ACCESS, SECRET)

    def admin(self):
        from minio_tpu_torch.s3.admin_client import AdminClient
        return AdminClient("127.0.0.1", self.port, ACCESS, SECRET)


def _body(i: int, size: int) -> bytes:
    return np.random.default_rng(i).integers(0, 256, size,
                                             dtype=np.uint8).tobytes()


OBJECTS = {"empty": 0, "dir/one": 1, "blocks": 3 * BLOCK + 5,
           "tail": 2 * BLOCK - 17}
MASKS = [(rb"<LastModified>[^<]*</LastModified>", b"<LastModified/>"),
         (rb"<RequestId>[^<]*</RequestId>", b"<RequestId/>"),
         (rb"<HostId>[^<]*</HostId>", b"<HostId/>")]
HEADERS = ("etag", "content-length", "content-type", "content-range")


def _script(c) -> list:
    """The scripted requests: (status, compared headers, masked body)."""
    out = []

    def rec(r):
        body = r.body
        for pat, rep in MASKS:
            body = re.sub(pat, rep, body)
        out.append((r.status, {h: r.headers.get(h) for h in HEADERS},
                    body))

    rec(c.make_bucket("clib"))
    for i, (name, size) in enumerate(OBJECTS.items()):
        rec(c.put_object("clib", name, _body(i, size)))
    for name in OBJECTS:
        rec(c.get_object("clib", name))
    rec(c.get_object("clib", "blocks", headers={"range": "bytes=10-16400"}))
    rec(c.head_object("clib", "tail"))
    rec(c.list_objects_v2("clib"))
    rec(c.request("DELETE", "/clib/empty"))
    rec(c.get_object("clib", "empty"))
    rec(c.get_object("nosuchbucket", "x"))
    rec(c.list_objects_v2("clib"))
    return out


def _disks(root) -> list:
    return [os.path.join(str(root), f"d{i}") for i in range(1, 5)]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Each package's CLI node on its own four drives, after the
    scripted requests: {pkg: (node, script results)}."""
    nodes, out = {}, {}
    try:
        for pkg in PACKAGES:
            root = tmp_path_factory.mktemp(f"cli-{pkg}")
            nodes[pkg] = CLINode(pkg, root, [
                "server", os.path.join(str(root), "d{1...4}"),
                "--block-size", str(BLOCK)])
            nodes[pkg].start()
        for pkg, node in nodes.items():
            out[pkg] = (node, _script(node.client()))
        yield out
    finally:
        for node in nodes.values():
            node.stop()


def test_cli_announces_the_same_topology(both):
    lines = {pkg: re.search(rb"minio-tpu server: [^\n]*", n.output())
             .group(0).rsplit(b"listening on", 1)[0]
             for pkg, (n, _) in both.items()}
    assert lines["port"] == lines["ref"] == \
        b"minio-tpu server: 1 pool(s), 1 set(s), 4 disks, EC 2+2, "


def test_cli_scripted_requests_match_reference(both):
    ref, port = both["ref"][1], both["port"][1]
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, f"request {i}: port {a[:2]} != reference {b[:2]}"
    assert [s for s, _, _ in port][:5] == [200] * 5


@pytest.mark.parametrize("name", [n for n in OBJECTS if n != "empty"])
def test_cli_drive_trees_match_reference(both, name):
    trees = {pkg: _part_files(_disks(n.root), "clib", name)
             for pkg, (n, _) in both.items()}
    assert trees["port"] == trees["ref"]
    assert all(files for files in trees["port"])


def test_cli_sigterm_exits_0_and_restart_reads_back(both):
    """SIGTERM: each node exits 0 within 30 s with no traceback. The
    port's node restarts on the same drives (the format-load path) and
    serves every object byte-exact."""
    for pkg, (node, _) in both.items():
        assert node.terminate(timeout=30) == 0, node.output()[-2000:]
        assert b"Traceback" not in node.output(), pkg
    node = both["port"][0]
    node.start()
    try:
        c = node.client()
        for i, (name, size) in enumerate(OBJECTS.items()):
            r = c.get_object("clib", name)
            if name == "empty":
                assert r.status == 404
            else:
                assert r.status == 200 and r.body == _body(i, size)
        assert node.terminate(timeout=30) == 0
        assert b"Traceback" not in node.output()
    finally:
        node.stop()


@pytest.mark.parametrize("args", [
    ["server", "DISKS/d{1...4}"],
    ["server", "DISKS/fs"],
    ["gateway", "nas", "DISKS/nas"],
], ids=["erasure", "fs", "gateway-nas"])
def test_cli_without_a_card_exits_1_before_serving(tmp_path, args):
    """No card and no ``MINIO_TORCH_DEVICE=cpu``: the node prints an error
    and exits 1; it never binds its port nor prints ``listening on``."""
    port = _free_port()
    env = _env("port", CUDA_VISIBLE_DEVICES="")
    env.pop("MINIO_TORCH_DEVICE")
    r = subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch",
         *[a.replace("DISKS", str(tmp_path)) for a in args],
         "--address", f"127.0.0.1:{port}"],
        env=env, cwd=REPO, capture_output=True, timeout=120)
    assert r.returncode == 1, r.stderr[-2000:]
    assert b"listening on" not in r.stdout + r.stderr
    assert b"MINIO_TORCH_DEVICE" in r.stderr
    assert os.listdir(tmp_path) == []
    s = socket.socket()
    s.bind(("127.0.0.1", port))     # the port was never taken
    s.close()


@pytest.mark.parametrize("value", ["tpu", "cuda:x"])
def test_cli_refuses_a_device_it_cannot_name(tmp_path, value):
    r = subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch", "server",
         str(tmp_path / "d{1...4}"), "--address", "127.0.0.1:0"],
        env=_env("port", MINIO_TORCH_DEVICE=value), cwd=REPO,
        capture_output=True, timeout=120)
    assert r.returncode == 2
    assert b"MINIO_TORCH_DEVICE" in r.stderr
    assert b"listening on" not in r.stdout


def test_gateway_nas_matches_reference(tmp_path):
    """``gateway nas DIR`` of both packages answers the scripted requests
    alike, lays out the same files under DIR, and exits 0 on SIGTERM."""
    nodes, out = {}, {}
    try:
        for pkg in PACKAGES:
            nodes[pkg] = CLINode(pkg, tmp_path / pkg,
                                 ["gateway", "nas",
                                  str(tmp_path / pkg / "nas")])
            nodes[pkg].start()
            out[pkg] = _script(nodes[pkg].client())
        assert out["port"] == out["ref"]
        for i, (name, size) in enumerate(OBJECTS.items()):
            if name == "empty":
                continue
            files = {pkg: open(tmp_path / pkg / "nas" / "clib" / name,
                               "rb").read() for pkg in PACKAGES}
            assert files["port"] == files["ref"] == _body(i, size)
        for node in nodes.values():
            assert node.terminate() == 0
            assert b"Traceback" not in node.output()
    finally:
        for node in nodes.values():
            node.stop()


def test_update_dry_run_matches_reference(tmp_path):
    """``update --dry-run`` against a local release endpoint: both CLIs
    report the same newer version, exit 0 and change nothing."""
    fr = _update.FakeRelease("9.9.9")
    try:
        res = {}
        for pkg in PACKAGES:
            r = subprocess.run(
                [sys.executable, "-m", PACKAGES[pkg], "update",
                 "--endpoint", fr.endpoint, "--dry-run"],
                env=_env(pkg), cwd=REPO, capture_output=True, timeout=120)
            res[pkg] = (r.returncode, r.stdout)
        assert res["port"] == res["ref"] == (
            0, b"update available: 0.1.0 -> 9.9.9 (run without --dry-run "
               b"to apply)\n")
    finally:
        fr.stop()


# ---------------------------------------------------------------------------
# Crash points through the port's CLI: the reference's bodies

_CRASH = PortRemap().namespace(_crash)
# One point each side of the PUT's quorum, and the heal write-back's last
# point before its commit (a pinned-CPU heal hashes frame by frame on K2's
# plain version, about 20 s a heal of the 200 KB object here).
CRASH_PUT = [p for p in _crash.PUT_POINTS
             if p[0] in ("engine.put.post_stage", "engine.put.post_commit")]
CRASH_HEAL = ["engine.heal.pre_commit"]
# Small blocks keep each frame, and so each K2 call of the plain version
# (its cost grows with the frame, whatever the rows), short.
CRASH_BLOCK = 4096


def _reparametrized(fn, argnames, values, ids):
    fn.pytestmark = [pytest.mark.parametrize(argnames, values, ids=ids)]
    return fn


test_crash__fault_inject_lists_crash_point_inventory = \
    _CRASH["test_fault_inject_lists_crash_point_inventory"]
test_crash__put_crash_point = _reparametrized(
    _CRASH["test_put_crash_point"], "point,after,expect", CRASH_PUT,
    [p for p, _, _ in CRASH_PUT])
test_crash__heal_writeback_crash_point = _reparametrized(
    _CRASH["test_heal_writeback_crash_point"], "point", CRASH_HEAL,
    CRASH_HEAL)


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    """The reference harness's single node (six drives, EC 3+3), booted
    by the port's CLI on the CPU; its crash rules exit 137."""
    root = tmp_path_factory.mktemp("crash")
    n = CLINode("port", root, [
        "server", *[os.path.join(str(root), f"d{i}")
                    for i in range(1, _crash.N_DISKS + 1)],
        "--block-size", str(CRASH_BLOCK)],
        env=_env("port", MINIO_RECOVERY_TMP_AGE="1"))
    n.disks = [os.path.join(str(root), f"d{i}")
               for i in range(1, _crash.N_DISKS + 1)]
    start = n.start

    def restart(timeout: float = 90) -> None:
        if n.proc is not None:
            time.sleep(1.2)   # the staging residue's 1 s age gate
        start(timeout)
    n.start = restart
    n.start()
    assert n.client().make_bucket("crashb").status == 200
    yield n
    n.stop()
