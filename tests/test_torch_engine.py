"""The port's erasure engine (minio_tpu_torch/erasure: engine.py,
multipart.py, sets.py, pools.py) held to the JAX package's.

Both packages run here on the CPU. The port's engines run pinned to the
CPU lane (``backend="cpu"``: kernels K1 and K2 as their plain PyTorch
versions, on drives hashing on ``device="cpu"``) or under ``"auto"`` with
``device="cpu"`` (the measured plan over the CPU lanes, bitrot routed as
the reference routes it); the JAX package's engines are built as its own
tests build them. Inputs come from numpy generators with fixed seeds.
Every comparison is byte-exact: the part files that the two engines
write for the same payload and name, xl.meta as parsed FileInfo (less
the per-write ``version_id``, ``data_dir`` and ``mod_time``), objects
read back across the packages in both directions, and the reference's
engine, multipart and topology cases run on the port's classes. The
seam: a ``"gpu"`` engine raises at construction without a card, and a
``device="cpu"`` engine never touches CUDA."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from minio_tpu.erasure.engine import ErasureObjects as RefEngine
from minio_tpu.erasure.engine import ObjectNotFound as RefObjectNotFound
from minio_tpu.parallel.quorum import hash_order as ref_hash_order
from minio_tpu.storage.xl import XLStorage as RefXL
from minio_tpu.utils.siphash import sip_hash_mod as ref_sip_hash_mod
from minio_tpu_torch.erasure import bitrot
from minio_tpu_torch.erasure.codec import AutoUnavailable
from minio_tpu_torch.erasure.engine import (BucketExists, BucketNotFound,
                                            ErasureObjects, MethodNotAllowed,
                                            ObjectNotFound)
from minio_tpu_torch.erasure.multipart import (InvalidPart, PartTooSmall,
                                               UploadNotFound,
                                               multipart_etag)
from minio_tpu_torch.erasure.pools import ErasureServerPools
from minio_tpu_torch.erasure.sets import ErasureSets
from minio_tpu_torch.ops import batching
from minio_tpu_torch.parallel.quorum import QuorumError, hash_order
from minio_tpu_torch.storage import errors as serr
from minio_tpu_torch.storage.format import init_or_load_formats
from minio_tpu_torch.storage.interface import StorageAPI
from minio_tpu_torch.storage.metadata import FileInfo
from minio_tpu_torch.storage.xl import XLStorage

BACKENDS = ("cpu", "auto")
REGEN = "pm-mbr-rbt"

# Every engine a test builds, of either package: shut down after it.
_ENGINES: list = []


def shutdown_engine(e) -> None:
    """Stop what an engine started: the MRF worker and the monitors
    (``shutdown``), then the listing's write-behind persist."""
    e.shutdown()
    t = e.metacache.last_persist
    if t is not None:
        t.join(timeout=30)
        assert not t.is_alive()


@pytest.fixture(autouse=True)
def _cpu_dispatch():
    """The port's "auto" lanes plan over the CPU here; afterwards the
    dispatch device is the card again and every engine is shut down."""
    batching.set_dispatch_device("cpu")
    yield
    while _ENGINES:
        shutdown_engine(_ENGINES.pop())
    batching.set_dispatch_device("cuda")


def rand(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


class NaughtyDisk(StorageAPI):
    """Wraps a StorageAPI; raises programmed errors per method name (the
    reference's naughtyDisk, as tests/test_engine.py has it)."""

    def __init__(self, inner: StorageAPI, fail_methods: set[str] | None
                 = None):
        self.inner = inner
        self.fail_methods = fail_methods or set()
        self.offline = False

    def _maybe_fail(self, name: str):
        if self.offline:
            raise serr.DiskNotFound("offline")
        if name in self.fail_methods:
            raise serr.FaultyDisk(f"injected: {name}")

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr) or name.startswith("_"):
            return attr

        def wrapper(*a, **kw):
            self._maybe_fail(name)
            return attr(*a, **kw)
        return wrapper

    def disk_info(self): return self.__getattr__("disk_info")()
    def make_volume(self, v): return self.__getattr__("make_volume")(v)
    def list_volumes(self): return self.__getattr__("list_volumes")()
    def stat_volume(self, v): return self.__getattr__("stat_volume")(v)

    def delete_volume(self, v, force=False):
        return self.__getattr__("delete_volume")(v, force)

    def write_all(self, v, p, d):
        return self.__getattr__("write_all")(v, p, d)
    def read_all(self, v, p): return self.__getattr__("read_all")(v, p)

    def read_file(self, v, p, o, l):
        return self.__getattr__("read_file")(v, p, o, l)

    def create_file(self, v, p, d):
        return self.__getattr__("create_file")(v, p, d)

    def append_file(self, v, p, d):
        return self.__getattr__("append_file")(v, p, d)

    def delete(self, v, p, recursive=False):
        return self.__getattr__("delete")(v, p, recursive)

    def rename_file(self, sv, sp, dv, dp):
        return self.__getattr__("rename_file")(sv, sp, dv, dp)

    def list_dir(self, v, p): return self.__getattr__("list_dir")(v, p)

    def rename_data(self, sv, sp, fi, dv, dp):
        return self.__getattr__("rename_data")(sv, sp, fi, dv, dp)

    def write_metadata(self, v, p, fi):
        return self.__getattr__("write_metadata")(v, p, fi)

    def read_version(self, v, p, vid=""):
        return self.__getattr__("read_version")(v, p, vid)

    def delete_version(self, v, p, fi):
        return self.__getattr__("delete_version")(v, p, fi)

    def read_versions(self, v, p):
        return self.__getattr__("read_versions")(v, p)

    def read_parts(self, v, p, dd):
        return self.__getattr__("read_parts")(v, p, dd)

    def verify_file(self, v, p, fi):
        return self.__getattr__("verify_file")(v, p, fi)


def drive_device(backend: str) -> str:
    """Where an engine's drives hash their deep scan: with the engine."""
    return "auto" if backend == "auto" else "cpu"


def make_engine(tmp_path, n=6, k=None, m=None, block_size=8192,
                naughty=False, backend="auto", drives=None):
    """The port's counterpart of tests/test_engine.py make_engine; the
    drives hash their deep scan on ``drives`` (default: with the
    engine)."""
    disks = []
    for i in range(n):
        d = XLStorage(str(tmp_path / f"disk{i}"),
                      device=drives or drive_device(backend))
        disks.append(NaughtyDisk(d) if naughty else d)
    e = ErasureObjects(disks, k, m, block_size=block_size, backend=backend,
                       device="cpu")
    _ENGINES.append(e)
    return e


def ref_engine(root, n=6, k=None, m=None, block_size=8192):
    e = RefEngine([RefXL(str(root / f"disk{i}")) for i in range(n)], k, m,
                  block_size=block_size)
    _ENGINES.append(e)
    return e


def port_over(ref, backend="cpu"):
    """A port engine over the same drive roots as ``ref``."""
    e = ErasureObjects(
        [XLStorage(d.root, device=drive_device(backend)) for d in ref.disks],
        ref.k, ref.m, block_size=ref.block_size, backend=backend,
        device="cpu")
    _ENGINES.append(e)
    return e


def ref_over(port):
    e = RefEngine([RefXL(d.root) for d in port.disks], port.k, port.m,
                  block_size=port.block_size)
    _ENGINES.append(e)
    return e


def part_files(e, bucket: str, obj: str) -> dict:
    """{disk position: {data dir's part file name: bytes}} of every
    version's data dir of ``obj``, keyed by the version's position in
    xl.meta so that two trees with other uuids compare."""
    out = {}
    for i, d in enumerate(e.disks):
        odir = os.path.join(d.root, bucket, obj)
        doc = json.loads(open(os.path.join(odir, "xl.meta"), "rb").read())
        per = []
        for v in doc["versions"]:
            dd = v.get("data_dir") or v.get("dataDir") or ""
            files = {}
            if dd and os.path.isdir(os.path.join(odir, dd)):
                for f in sorted(os.listdir(os.path.join(odir, dd))):
                    files[f] = open(os.path.join(odir, dd, f), "rb").read()
            per.append(files)
        out[i] = per
    return out


def meta_view(e, bucket: str, obj: str) -> list:
    """Every drive's xl.meta versions as parsed FileInfo dicts, less the
    per-write version_id, data_dir and mod_time."""
    out = []
    for d in e.disks:
        fis = d.read_versions(bucket, obj)
        rows = []
        for fi in fis:
            doc = dict(vars(fi))
            doc["erasure"] = dict(vars(fi.erasure)) if fi.erasure else None
            doc["parts"] = [dict(vars(p)) for p in fi.parts]
            for key in ("version_id", "data_dir", "mod_time"):
                doc.pop(key, None)
            rows.append(json.dumps(doc, sort_keys=True, default=str))
        out.append(rows)
    return out


def shard_layout_ok(e, bucket, obj) -> None:
    """Every drive's xl.meta parses as the port's FileInfo."""
    for d in e.disks:
        assert isinstance(d.read_version(bucket, obj), FileInfo)


# ---------------------------------------------------------------------------
# Part files across packages


SIZES_4K = (0, 1, 4096, 4097, 3 * 4096 + 5)


@pytest.mark.parametrize("k,m", [(6, 2), (12, 4)])
@pytest.mark.parametrize("size", SIZES_4K)
def test_part_files_match_reference(tmp_path, k, m, size):
    """One payload and name PUT by both engines, the port's pinned to the
    CPU lane: every drive's part.1 and xl.meta are the reference's."""
    payload = rand(size, seed=size)
    p = make_engine(tmp_path / "port", n=k + m, k=k, m=m, block_size=4096,
                    backend="cpu")
    r = ref_engine(tmp_path / "ref", n=k + m, k=k, m=m, block_size=4096)
    infos = []
    for e in (p, r):
        e.make_bucket("b")
        infos.append(e.put_object("b", "dir/obj", payload,
                                  metadata={"content-type": "x/y"}))
    assert infos[0].etag == infos[1].etag == hashlib.md5(payload).hexdigest()
    assert part_files(p, "b", "dir/obj") == part_files(r, "b", "dir/obj")
    assert meta_view(p, "b", "dir/obj") == meta_view(r, "b", "dir/obj")
    shard_layout_ok(p, "b", "dir/obj")


@pytest.mark.parametrize("k,m", [(6, 2), (12, 4)])
def test_versioned_overwrite_part_files_match_reference(tmp_path, k, m):
    """Two versioned PUTs and a null overwrite of one key: every version's
    data dir holds the reference's part files."""
    p = make_engine(tmp_path / "port", n=k + m, k=k, m=m, block_size=4096,
                    backend="cpu")
    r = ref_engine(tmp_path / "ref", n=k + m, k=k, m=m, block_size=4096)
    for e in (p, r):
        e.make_bucket("b")
        e.put_object("b", "v", rand(9000, 1), versioned=True)
        e.put_object("b", "v", rand(5000, 2), versioned=True)
        e.put_object("b", "v", rand(4097, 3))
    assert part_files(p, "b", "v") == part_files(r, "b", "v")
    assert meta_view(p, "b", "v") == meta_view(r, "b", "v")


@pytest.mark.parametrize("k,m", [(4, 2), (12, 4)])
@pytest.mark.parametrize("size", [1, 8192 + 1, 3 * 8192])
def test_regen_part_files_match_reference(tmp_path, k, m, size):
    """A REGEN object (xl.meta algorithm pm-mbr-rbt) from both engines."""
    payload = rand(size, seed=7)
    p = make_engine(tmp_path / "port", n=k + m, k=k, m=m, block_size=8192,
                    backend="cpu")
    r = ref_engine(tmp_path / "ref", n=k + m, k=k, m=m, block_size=8192)
    for e in (p, r):
        e.make_bucket("b")
        e.put_object("b", "rg", payload, algorithm=REGEN)
    assert part_files(p, "b", "rg") == part_files(r, "b", "rg")
    assert meta_view(p, "b", "rg") == meta_view(r, "b", "rg")
    assert p.disks[0].read_version("b", "rg").erasure.algorithm == REGEN


# ---------------------------------------------------------------------------
# Read across, both ways


def _write_kind(e, kind: str) -> dict:
    """Objects of one kind in bucket "b"; returns what a reader must see:
    {"objects": {name: bytes}, "versions": [(name, is marker)],
    "gone": [names whose latest is a delete marker]}."""
    e.make_bucket("b")
    want = {"objects": {}, "versions": [], "gone": []}
    if kind == "plain":
        for i, size in enumerate((0, 1, 8192, 3 * 8192 + 11)):
            data = rand(size, seed=10 + i)
            e.put_object("b", f"p/{i}", data, metadata={"x-amz-meta-i": str(i)})
            want["objects"][f"p/{i}"] = data
    elif kind == "multipart":
        mp = e.multipart
        mp.min_part_size = 1024
        uid = mp.new_multipart_upload("b", "mp")
        datas = [rand(20_000, 20), rand(9_000, 21), rand(333, 22)]
        sent = [(i, mp.put_object_part("b", "mp", uid, i, d)["etag"])
                for i, d in enumerate(datas, start=1)]
        mp.complete_multipart_upload("b", "mp", uid, sent)
        want["objects"]["mp"] = b"".join(datas)
    elif kind == "versions":
        old = rand(12_000, 30)
        v1 = e.put_object("b", "v", old, versioned=True)
        e.delete_object("b", "v", versioned=True)
        e.put_object("b", "keep", rand(100, 31), versioned=True)
        want["objects"]["keep"] = rand(100, 31)
        want["version_of"] = (v1.version_id, old)
        want["gone"].append("v")
    elif kind == "regen":
        data = rand(3 * 8192 + 5, 40)
        e.put_object("b", "rg", data, algorithm=REGEN)
        want["objects"]["rg"] = data
    return want


def _check_reads(e, want: dict) -> None:
    for name, data in want["objects"].items():
        got, info = e.get_object("b", name)
        assert got == data, name
        assert info.size == len(data)
        stat = e.get_object_info("b", name)
        assert stat.size == len(data) and stat.etag == info.etag
        for off, ln in ((0, 1), (len(data) // 3, 8192), (len(data) - 1, 1)):
            if 0 <= off and off + ln <= len(data) and ln:
                assert e.get_object("b", name, offset=off,
                                    length=ln)[0] == data[off:off + ln]
    not_found = ObjectNotFound if isinstance(e, ErasureObjects) \
        else RefObjectNotFound
    for name in want["gone"]:
        with pytest.raises(not_found):
            e.get_object("b", name)
    if "version_of" in want:
        vid, data = want["version_of"]
        assert e.get_object("b", "v", version_id=vid)[0] == data
    assert [o.name for o in e.list_objects("b")] == sorted(want["objects"])


def _versions(e) -> list:
    return [(o.name, o.version_id, o.delete_marker, o.size, o.etag)
            for o in e.list_object_versions("b")]


@pytest.mark.parametrize("kind", ["plain", "multipart", "versions",
                                  "regen"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_read_across_packages(tmp_path, writer, kind):
    """Objects written by one package's engine read back byte-exact through
    the other's over the same drive roots: full and ranged GETs,
    get_object_info, listings of objects and of versions."""
    if writer == "ref":
        w = ref_engine(tmp_path, n=6, k=4, m=2)
        rd = port_over(w)
    else:
        w = make_engine(tmp_path, n=6, k=4, m=2, backend="cpu")
        rd = ref_over(w)
    want = _write_kind(w, kind)
    _check_reads(rd, want)
    _check_reads(w, want)
    assert _versions(rd) == _versions(w)


# ---------------------------------------------------------------------------
# The PUT framing route (tests/test_hh256_tpu.py:162 on the port)


@pytest.mark.parametrize("size", [1, 8192 * 2 + 7, 5 * 8192])
def test_engine_shard_files_identical_with_and_without_device(
        tmp_path, monkeypatch, size):
    """Central framing (``_frame_split``: one hash dispatch over all k+m
    shards, what a pinned engine always does) and the writer fan-out
    (``bitrot.frame_shard`` per shard, what an "auto" engine does below
    the device-hash policy) write the same part files; so does an "auto"
    engine whose policy sends the batch to the kernel lane."""
    payload = rand(size, seed=size)
    routes = []
    real = ErasureObjects._frame_split

    def spy(self, full_sm, tails, codec):
        routes.append(self.backend)
        return real(self, full_sm, tails, codec)

    monkeypatch.setattr(ErasureObjects, "_frame_split", spy)

    def put_and_slurp(sub, backend, device_hash):
        # As the reference's test forces it: a card in the census and no
        # size floor (the kernel lane is the CPU dispatch device here).
        monkeypatch.setattr(batching, "_device_present", device_hash)
        monkeypatch.setattr(bitrot, "HH_TPU_MIN_BYTES",
                            1 if device_hash else 1 << 60)
        e = make_engine(tmp_path / sub, n=6, k=4, m=2, backend=backend)
        e.make_bucket("b")
        e.put_object("b", "obj", payload)
        return part_files(e, "b", "obj")

    pinned = put_and_slurp("pinned", "cpu", False)
    assert routes == ["cpu"]
    fanout = put_and_slurp("fanout", "auto", False)
    assert routes == ["cpu"]
    central = put_and_slurp("central", "auto", True)
    assert routes == ["cpu"] + (["auto"] if size >= 8192 else [])
    assert pinned == fanout == central


# ---------------------------------------------------------------------------
# tests/test_engine.py's cases on the port


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


# Cases whose pinned-CPU run hashes hundreds of frames on K2's plain
# version (about 1 ms a 32-byte packet on the CPU) run under "auto" only;
# the pinned lane's bytes are held by the cross-package cases above.
AUTO_ONLY = pytest.mark.parametrize("backend", ["auto"])


@pytest.fixture
def engine(tmp_path, backend):
    e = make_engine(tmp_path, backend=backend)
    e.make_bucket("bucket")
    return e


def test_bucket_lifecycle(tmp_path, backend):
    e = make_engine(tmp_path, backend=backend)
    e.make_bucket("b1")
    with pytest.raises(BucketExists):
        e.make_bucket("b1")
    assert [b["name"] for b in e.list_buckets()] == ["b1"]
    e.delete_bucket("b1")
    with pytest.raises(BucketNotFound):
        e.delete_bucket("b1")


@AUTO_ONLY
def test_put_get_roundtrip_sizes(engine):
    for size in (0, 1, 100, 8192, 8193, 100_000):
        payload = rand(size, seed=size)
        info = engine.put_object("bucket", f"obj-{size}", payload)
        assert info.size == size
        got, ginfo = engine.get_object("bucket", f"obj-{size}")
        assert got == payload, size
        assert ginfo.etag == info.etag


@AUTO_ONLY
def test_get_range(engine):
    payload = bytes(range(256)) * 200  # 51200 bytes, crosses blocks
    engine.put_object("bucket", "ranged", payload)
    for off, ln in ((0, 10), (100, 1), (8000, 500), (8192, 8192),
                    (51000, 200), (0, 51200)):
        got, _ = engine.get_object("bucket", "ranged", offset=off,
                                   length=ln)
        assert got == payload[off:off + ln], (off, ln)


def test_stat_and_delete(engine):
    engine.put_object("bucket", "x/y/z", b"abc", metadata={"k": "v"})
    info = engine.get_object_info("bucket", "x/y/z")
    assert info.size == 3 and info.metadata["k"] == "v"
    engine.delete_object("bucket", "x/y/z")
    with pytest.raises(ObjectNotFound):
        engine.get_object_info("bucket", "x/y/z")
    with pytest.raises(ObjectNotFound):
        engine.delete_object("bucket", "never-existed")


def test_overwrite_replaces(engine):
    engine.put_object("bucket", "o", b"first")
    engine.put_object("bucket", "o", b"second-longer")
    got, _ = engine.get_object("bucket", "o")
    assert got == b"second-longer"


def test_list_objects(engine):
    for name in ("a/1", "a/2", "b/1", "top"):
        engine.put_object("bucket", name, b"x")
    names = [o.name for o in engine.list_objects("bucket")]
    assert names == ["a/1", "a/2", "b/1", "top"]
    names = [o.name for o in engine.list_objects("bucket", prefix="a/")]
    assert names == ["a/1", "a/2"]


@AUTO_ONLY
def test_write_tolerates_parity_failures(tmp_path, backend):
    e = make_engine(tmp_path, n=6, naughty=True, backend=backend)
    e.make_bucket("b")
    e.disks[1].fail_methods = {"create_file", "append_file"}
    e.disks[4].fail_methods = {"rename_data"}
    payload = rand(20000)
    e.put_object("b", "tolerant", payload)
    got, _ = e.get_object("b", "tolerant")
    assert got == payload


def test_write_fails_below_quorum(tmp_path, backend):
    e = make_engine(tmp_path, n=6, naughty=True, backend=backend)
    e.make_bucket("b")
    for i in (0, 2, 5):
        e.disks[i].fail_methods = {"create_file", "append_file"}
    with pytest.raises(QuorumError):
        e.put_object("b", "doomed", rand(10000))


def test_degraded_read_with_offline_disks(tmp_path, backend):
    e = make_engine(tmp_path, n=6, naughty=True, backend=backend)
    e.make_bucket("b")
    payload = rand(50000)
    e.put_object("b", "obj", payload)
    for i in (0, 3, 5):
        e.disks[i].offline = True
    got, _ = e.get_object("b", "obj")
    assert got == payload


def test_read_fails_when_too_many_offline(tmp_path, backend):
    e = make_engine(tmp_path, n=6, naughty=True, backend=backend)
    e.make_bucket("b")
    e.put_object("b", "obj", rand(10000))
    for i in range(4):
        e.disks[i].offline = True
    with pytest.raises((QuorumError, ObjectNotFound)):
        e.get_object("b", "obj")


def test_bitrot_corruption_triggers_reconstruction(tmp_path, backend):
    e = make_engine(tmp_path, n=4, block_size=4096, backend=backend)
    e.make_bucket("b")
    payload = rand(20000)
    e.put_object("b", "obj", payload)
    corrupted = 0
    for i in range(4):
        root = e.disks[i].root
        for dirpath, _, files in os.walk(os.path.join(root, "b")):
            for f in files:
                if f.startswith("part.") and corrupted < 1:
                    p = os.path.join(dirpath, f)
                    raw = bytearray(open(p, "rb").read())
                    raw[40] ^= 0xFF  # inside first data block
                    open(p, "wb").write(bytes(raw))
                    corrupted += 1
    assert corrupted == 1
    got, _ = e.get_object("b", "obj")
    assert got == payload


def test_metadata_quorum_prefers_majority(tmp_path, backend):
    e = make_engine(tmp_path, n=4, block_size=4096, backend=backend)
    e.make_bucket("b")
    e.put_object("b", "obj", b"payload-bytes")
    meta_path = os.path.join(e.disks[0].root, "b", "obj", "xl.meta")
    doc = json.loads(open(meta_path).read())
    doc["versions"][0]["size"] = 999
    open(meta_path, "w").write(json.dumps(doc))
    got, info = e.get_object("b", "obj")
    assert got == b"payload-bytes"
    assert info.size == 13


@pytest.mark.parametrize("n", [0, 1, 4, 6, 16])
def test_hash_order_matches_reference(n):
    """The port's hash_order is the reference's rotation (ref hashOrder,
    cmd/erasure-metadata-utils.go:100-114), pinned at "abc" and held to
    the JAX package's over many keys."""
    if n == 4:
        assert hash_order("abc", 4) == [4, 1, 2, 3]
    for i in range(200):
        key = f"bucket/obj-{i}"
        assert hash_order(key, n) == ref_hash_order(key, n)


def test_versioned_overwrite_preserves_old_version_data(tmp_path, backend):
    e = make_engine(tmp_path, n=4, block_size=4096, backend=backend)
    e.make_bucket("b")
    v_info = e.put_object("b", "o", b"versioned-payload", versioned=True)
    assert v_info.version_id
    e.put_object("b", "o", b"null-version-payload")
    got, _ = e.get_object("b", "o", version_id=v_info.version_id)
    assert got == b"versioned-payload"
    got, _ = e.get_object("b", "o")
    assert got == b"null-version-payload"


@AUTO_ONLY
def test_list_sees_objects_missing_on_first_disk(tmp_path, backend):
    e = make_engine(tmp_path, n=6, naughty=True, backend=backend)
    e.make_bucket("b")
    e.disks[0].fail_methods = {"create_file", "append_file", "rename_data"}
    e.put_object("b", "hidden", b"x" * 1000)
    e.disks[0].fail_methods = set()
    names = [o.name for o in e.list_objects("b")]
    assert names == ["hidden"]


def test_get_range_past_eof_raises(engine):
    engine.put_object("bucket", "small", b"abc")
    with pytest.raises(ValueError):
        engine.get_object("bucket", "small", offset=10)
    with pytest.raises(ValueError):
        engine.get_object("bucket", "small", offset=1, length=10)
    got, _ = engine.get_object("bucket", "small", offset=3)
    assert got == b""


def test_ranged_read_is_windowed(tmp_path, monkeypatch, backend):
    e = make_engine(tmp_path, n=4, naughty=True, block_size=8192,
                    backend=backend)
    e.make_bucket("b")
    payload = rand(20 * 8192)
    e.put_object("b", "big", payload)
    reads = []
    orig = XLStorage.read_file

    def spy(self, vol, path, off, ln):
        reads.append((off, ln))
        return orig(self, vol, path, off, ln)

    monkeypatch.setattr(XLStorage, "read_file", spy)
    got, _ = e.get_object("b", "big", offset=0, length=100)
    assert got == payload[:100]
    assert reads and all(ln <= 3 * 8192 for _, ln in reads)


def test_reserved_bucket_unreachable(tmp_path, backend):
    e = make_engine(tmp_path, n=4, backend=backend)
    for op in (lambda: e.make_bucket(".minio.sys"),
               lambda: e.delete_bucket(".minio.sys", force=True),
               lambda: e.put_object(".minio.sys", "tmp/x", b"junk"),
               lambda: e.get_object(".minio.sys", "config"),
               lambda: e.list_objects(".minio.sys")):
        with pytest.raises(BucketNotFound):
            op()


def test_make_bucket_exists_with_one_faulty_disk(tmp_path, backend):
    e = make_engine(tmp_path, n=4, naughty=True, backend=backend)
    e.make_bucket("b")
    e.disks[3].fail_methods = {"make_volume"}
    with pytest.raises(BucketExists):
        e.make_bucket("b")


@AUTO_ONLY
def test_failed_put_leaves_no_tmp_garbage(tmp_path, backend):
    e = make_engine(tmp_path, n=4, naughty=True, backend=backend)
    e.make_bucket("b")
    e.disks[2].fail_methods = {"rename_data"}
    e.put_object("b", "obj", rand(5000))
    e.mrf.stop()
    tmp_dir = os.path.join(e.disks[2].inner.root, ".minio.sys", "tmp")
    assert not os.path.isdir(tmp_dir) or os.listdir(tmp_dir) == []


def test_object_does_not_shadow_prefix(tmp_path, backend):
    e = make_engine(tmp_path, n=4, backend=backend)
    e.make_bucket("b")
    e.put_object("b", "a", b"object-a")
    e.put_object("b", "a/b", b"object-ab")
    names = [o.name for o in e.list_objects("b")]
    assert names == ["a", "a/b"]
    assert e.get_object("b", "a")[0] == b"object-a"
    assert e.get_object("b", "a/b")[0] == b"object-ab"


def test_delete_marker_by_version_is_method_not_allowed(tmp_path, backend):
    """GET/HEAD of a delete marker by its versionId (S3 405)."""
    e = make_engine(tmp_path, n=4, block_size=4096, backend=backend)
    e.make_bucket("b")
    e.put_object("b", "o", b"data", versioned=True)
    marker = e.delete_object("b", "o", versioned=True)
    assert marker.delete_marker
    with pytest.raises(MethodNotAllowed):
        e.get_object("b", "o", version_id=marker.version_id)
    with pytest.raises(MethodNotAllowed):
        e.get_object_info("b", "o", version_id=marker.version_id)


# ---------------------------------------------------------------------------
# tests/test_multipart.py's engine-level cases on the port


@pytest.fixture
def mp_engine(tmp_path, backend):
    e = make_engine(tmp_path, n=4, block_size=16 * 1024, backend=backend)
    e.multipart.min_part_size = 1024  # keep tests small
    e.make_bucket("b")
    return e


@AUTO_ONLY
def test_multipart_roundtrip(mp_engine):
    engine = mp_engine
    mp = engine.multipart
    uid = mp.new_multipart_upload("b", "big.bin", {"content-type": "x/y"})
    parts_data = [rand(40_000, 1), rand(50_000, 2), rand(7_000, 3)]
    sent = []
    for i, pd in enumerate(parts_data, start=1):
        p = mp.put_object_part("b", "big.bin", uid, i, pd)
        assert p["etag"] == hashlib.md5(pd).hexdigest()
        sent.append((i, p["etag"]))
    info = mp.complete_multipart_upload("b", "big.bin", uid, sent)
    want = b"".join(parts_data)
    assert info.size == len(want)
    assert info.etag == multipart_etag([e for _, e in sent])
    got, ginfo = engine.get_object("b", "big.bin")
    assert got == want
    assert len(ginfo.parts) == 3
    got, _ = engine.get_object("b", "big.bin", offset=39_990, length=100)
    assert got == want[39_990:40_090]
    with pytest.raises(UploadNotFound):
        mp.list_parts("b", "big.bin", uid)


def test_multipart_part_overwrite(mp_engine):
    mp = mp_engine.multipart
    uid = mp.new_multipart_upload("b", "o")
    mp.put_object_part("b", "o", uid, 1, b"x" * 2000)
    p = mp.put_object_part("b", "o", uid, 1, b"y" * 3000)  # re-upload
    mp.complete_multipart_upload("b", "o", uid, [(1, p["etag"])])
    got, _ = mp_engine.get_object("b", "o")
    assert got == b"y" * 3000


def test_multipart_validation(mp_engine):
    mp = mp_engine.multipart
    uid = mp.new_multipart_upload("b", "v")
    p1 = mp.put_object_part("b", "v", uid, 1, b"a" * 2000)
    p2 = mp.put_object_part("b", "v", uid, 2, b"b" * 2000)
    with pytest.raises(InvalidPart):
        mp.complete_multipart_upload("b", "v", uid,
                                     [(2, p2["etag"]), (1, p1["etag"])])
    with pytest.raises(InvalidPart):
        mp.complete_multipart_upload("b", "v", uid, [(1, "deadbeef")])
    with pytest.raises(InvalidPart):
        mp.complete_multipart_upload("b", "v", uid, [(7, p1["etag"])])
    tiny = mp.put_object_part("b", "v", uid, 2, b"tiny")
    big = mp.put_object_part("b", "v", uid, 3, b"c" * 2000)
    with pytest.raises(PartTooSmall):
        mp.complete_multipart_upload(
            "b", "v", uid, [(2, tiny["etag"]), (3, big["etag"])])


def test_multipart_abort(mp_engine):
    mp = mp_engine.multipart
    uid = mp.new_multipart_upload("b", "aborted")
    mp.put_object_part("b", "aborted", uid, 1, b"z" * 5000)
    assert mp.list_uploads("b")
    mp.abort_multipart_upload("b", "aborted", uid)
    assert mp.list_uploads("b") == []
    with pytest.raises(UploadNotFound):
        mp.put_object_part("b", "aborted", uid, 2, b"more")


@AUTO_ONLY
def test_multipart_heal(mp_engine):
    mp = mp_engine.multipart
    uid = mp.new_multipart_upload("b", "healmp")
    datas = [rand(30_000, 4), rand(20_000, 5)]
    sent = [(i, mp.put_object_part("b", "healmp", uid, i, pd)["etag"])
            for i, pd in enumerate(datas, start=1)]
    mp.complete_multipart_upload("b", "healmp", uid, sent)
    shutil.rmtree(os.path.join(mp_engine.disks[2].root, "b", "healmp"))
    r = mp_engine.healer.heal_object("b", "healmp")
    assert r.healed_disks == [2] and r.healthy
    got, _ = mp_engine.get_object("b", "healmp")
    assert got == b"".join(datas)


@AUTO_ONLY
def test_zero_byte_final_part_heals(mp_engine):
    mp = mp_engine.multipart
    uid = mp.new_multipart_upload("b", "zlast")
    p1 = mp.put_object_part("b", "zlast", uid, 1, b"d" * 5000)
    p2 = mp.put_object_part("b", "zlast", uid, 2, b"")
    mp.complete_multipart_upload("b", "zlast", uid,
                                 [(1, p1["etag"]), (2, p2["etag"])])
    got, _ = mp_engine.get_object("b", "zlast")
    assert got == b"d" * 5000
    r = mp_engine.healer.heal_object("b", "zlast")
    assert not r.dangling and r.corrupt_disks == []


@AUTO_ONLY
def test_complete_retry_after_partial_failure(tmp_path, backend):
    e = make_engine(tmp_path, n=4, naughty=True, block_size=16 * 1024,
                    backend=backend)
    e.multipart.min_part_size = 1024
    e.make_bucket("b")
    mp = e.multipart
    uid = mp.new_multipart_upload("b", "retry")
    p = mp.put_object_part("b", "retry", uid, 1, rand(30_000))
    for i in (0, 1):
        e.disks[i].fail_methods = {"rename_data"}
    with pytest.raises(QuorumError):
        mp.complete_multipart_upload("b", "retry", uid, [(1, p["etag"])])
    for i in (0, 1):
        e.disks[i].fail_methods = set()
    info = mp.complete_multipart_upload("b", "retry", uid,
                                        [(1, p["etag"])])
    assert info.size == 30_000
    got, _ = e.get_object("b", "retry")
    assert len(got) == 30_000


def test_list_parts_unions_across_disks(tmp_path, backend):
    e = make_engine(tmp_path, n=4, naughty=True, block_size=16 * 1024,
                    backend=backend)
    e.multipart.min_part_size = 1024
    e.make_bucket("b")
    mp = e.multipart
    uid = mp.new_multipart_upload("b", "u")
    e.disks[0].fail_methods = {"write_all"}
    p = mp.put_object_part("b", "u", uid, 1, b"q" * 4000)
    e.disks[0].fail_methods = set()
    parts = mp.list_parts("b", "u", uid)
    assert [x["number"] for x in parts] == [1]
    assert parts[0]["etag"] == p["etag"]


def test_multipart_part_files_match_reference(tmp_path):
    """A three-part upload through both engines: every drive's part.N and
    xl.meta are the reference's."""
    datas = [rand(20_000, 50), rand(16_384, 51), rand(3, 52)]
    p = make_engine(tmp_path / "port", n=6, k=4, m=2, block_size=4096,
                    backend="cpu")
    r = ref_engine(tmp_path / "ref", n=6, k=4, m=2, block_size=4096)
    etags = []
    for e in (p, r):
        e.make_bucket("b")
        mp = e.multipart
        mp.min_part_size = 1024
        uid = mp.new_multipart_upload("b", "mp")
        sent = [(i, mp.put_object_part("b", "mp", uid, i, d)["etag"])
                for i, d in enumerate(datas, start=1)]
        etags.append(mp.complete_multipart_upload("b", "mp", uid,
                                                  sent).etag)
    assert etags[0] == etags[1] and etags[0].endswith("-3")
    assert part_files(p, "b", "mp") == part_files(r, "b", "mp")
    assert meta_view(p, "b", "mp") == meta_view(r, "b", "mp")


# ---------------------------------------------------------------------------
# tests/test_topology.py's set and pool cases on the port


def _mk_disks(root, n, backend="auto"):
    return [XLStorage(str(root / f"d{i}"), device=drive_device(backend))
            for i in range(n)]


def _make_sets(tmp_path, n_disks=8, layout=(4, 4), block_size=8192,
               backend="auto"):
    disks = _mk_disks(tmp_path, n_disks, backend)
    fmt, ordered, _ = init_or_load_formats(disks, set_size=layout[0])
    sets = ErasureSets(ordered, list(layout), fmt.deployment_id,
                       block_size=block_size, backend=backend,
                       device="cpu")
    _ENGINES.extend(sets.sets)
    return sets


@pytest.mark.parametrize("n_sets", [1, 2, 3, 8, 16])
def test_set_for_matches_reference(n_sets):
    """Placement: the set of every key is the reference's sipHashMod of
    the name keyed by the deployment id (ref cmd/erasure-sets.go:623)."""
    from minio_tpu_torch.utils.siphash import sip_hash_mod
    rng = np.random.default_rng(n_sets)
    dep = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    for i in range(300):
        key = f"prefix-{rng.integers(1 << 30)}/obj-{i}"
        assert sip_hash_mod(key, n_sets, dep) == \
            ref_sip_hash_mod(key, n_sets, dep)


def test_sets_set_index_matches_reference(tmp_path):
    """ErasureSets.set_index of the port and of the reference over one
    format agree for every key."""
    from minio_tpu.erasure.sets import ErasureSets as RefSets
    from minio_tpu.storage.format import init_or_load_formats as ref_init
    sets = _make_sets(tmp_path / "port", n_disks=12, layout=(4, 4, 4))
    ref_disks = [RefXL(str(tmp_path / "ref" / f"d{i}")) for i in range(12)]
    fmt, ordered, _ = ref_init(ref_disks, set_size=4)
    ref = RefSets(ordered, [4, 4, 4], sets.deployment_id, block_size=8192)
    _ENGINES.extend(ref.sets)
    keys = [f"k/{i}" for i in range(500)]
    assert [sets.set_index(k) for k in keys] == \
        [ref.set_index(k) for k in keys]
    assert {sets.set_index(k) for k in keys} == {0, 1, 2}


@AUTO_ONLY
def test_sets_placement_and_roundtrip(tmp_path, backend):
    sets = _make_sets(tmp_path, backend=backend)
    sets.make_bucket("b")
    payloads = {f"obj-{i}": rand(5000 + i, i) for i in range(20)}
    for k, v in payloads.items():
        sets.put_object("b", k, v)
    assert {sets.set_index(k) for k in payloads} == {0, 1}
    for k, v in payloads.items():
        got, _ = sets.get_object("b", k)
        assert got == v
    for k in payloads:
        other = sets.sets[1 - sets.set_index(k)]
        for d in other.disks:
            assert not os.path.exists(os.path.join(d.root, "b", k))
    assert [o.name for o in sets.list_objects("b")] == sorted(payloads)


def test_sets_bucket_fanout(tmp_path, backend):
    sets = _make_sets(tmp_path, backend=backend)
    sets.make_bucket("fb")
    for s in sets.sets:
        assert s.bucket_exists("fb")
    with pytest.raises(BucketExists):
        sets.make_bucket("fb")
    sets.delete_bucket("fb")
    for s in sets.sets:
        assert not s.bucket_exists("fb")


@AUTO_ONLY
def test_sets_multipart_dispatch(tmp_path, backend):
    sets = _make_sets(tmp_path, backend=backend)
    sets.make_bucket("b")
    mp = sets.multipart
    uid = mp.new_multipart_upload("b", "mpobj")
    data = rand(40_000)
    p = mp.put_object_part("b", "mpobj", uid, 1, data)
    mp.complete_multipart_upload("b", "mpobj", uid, [(1, p["etag"])])
    got, _ = sets.get_object("b", "mpobj")
    assert got == data


def _homes(pools, name):
    homes = []
    for i, p in enumerate(pools.pools):
        try:
            p.get_object_info("b", name)
            homes.append(i)
        except ObjectNotFound:
            pass
    return homes


def test_pools_placement_and_probe(tmp_path, backend):
    pool1 = _make_sets(tmp_path / "p1", 4, (4,), backend=backend)
    pool2 = _make_sets(tmp_path / "p2", 4, (4,), backend=backend)
    pools = ErasureServerPools([pool1, pool2])
    pools.make_bucket("b")
    pools.put_object("b", "obj", b"pool data")
    assert pools.get_object("b", "obj")[0] == b"pool data"
    homes = _homes(pools, "obj")
    assert len(homes) == 1
    pools.put_object("b", "obj", b"updated")
    assert _homes(pools, "obj") == homes
    assert pools.get_object("b", "obj")[0] == b"updated"
    pools.delete_object("b", "obj")
    with pytest.raises(ObjectNotFound):
        pools.get_object("b", "obj")


@AUTO_ONLY
def test_pools_heal_and_list(tmp_path, backend):
    pool1 = _make_sets(tmp_path / "p1", 4, (4,), backend=backend)
    pool2 = _make_sets(tmp_path / "p2", 4, (4,), backend=backend)
    pools = ErasureServerPools([pool1, pool2])
    pools.make_bucket("b")
    for i in range(6):
        pools.put_object("b", f"k{i}", rand(3000, i))
    assert [o.name for o in pools.list_objects("b")] == \
        [f"k{i}" for i in range(6)]
    victim = next(f"k{i}" for i in range(6) if _homes(pools, f"k{i}") == [0])
    d = pool1.sets[0].disks[0]
    shutil.rmtree(os.path.join(d.root, "b", victim))
    r = pools.healer.heal_object("b", victim)
    assert r.healed_disks == [0] and r.healthy
    assert pools.get_object("b", victim)[0] == rand(3000, int(victim[1:]))


# ---------------------------------------------------------------------------
# The device seam


def test_gpu_engine_raises_without_a_card(tmp_path, monkeypatch):
    """A "gpu" engine (the default) on a box with no card raises at
    construction; it never encodes or hashes on the host instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    disks = _mk_disks(tmp_path, 4, "cpu")
    with pytest.raises(RuntimeError):
        ErasureObjects(disks, 2, 2, block_size=4096)
    with pytest.raises(RuntimeError):
        ErasureSets(disks, [4], "00000000-0000-4000-8000-000000000000",
                    2, 2, block_size=4096)
    with pytest.raises(ValueError):
        ErasureObjects(disks, 2, 2, block_size=4096, backend="gpu",
                       device="cpu")


def test_auto_engine_without_a_device_raises(tmp_path, monkeypatch):
    """"auto" with no card and without device="cpu" raises
    AutoUnavailable (the port implements no CPU default for "auto")."""
    batching.set_dispatch_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(AutoUnavailable):
        ErasureObjects(_mk_disks(tmp_path, 4, "cpu"), 2, 2,
                       block_size=4096, backend="auto")


@pytest.mark.parametrize("backend_", BACKENDS)
def test_cpu_engine_never_touches_cuda(tmp_path, monkeypatch, backend_):
    """With every torch.cuda entry point poisoned, a device="cpu" engine
    builds, PUTs, GETs degraded and heals; the set gets no device
    affinity."""
    def poisoned(*a, **kw):
        raise AssertionError("a device='cpu' engine touched torch.cuda")

    for name in ("is_available", "device_count", "current_device",
                 "synchronize", "current_stream", "get_device_name",
                 "set_device", "Event", "Stream"):
        monkeypatch.setattr(torch.cuda, name, poisoned)
    e = make_engine(tmp_path, n=6, k=4, m=2, block_size=4096,
                    backend=backend_, drives="auto")
    assert e.device_affinity is None and e.device == torch.device("cpu")
    assert e.bitrot_device == ("auto" if backend_ == "auto"
                               else torch.device("cpu"))
    e.make_bucket("b")
    payload = rand(4096 + 9, 3)
    e.put_object("b", "o", payload)
    shutil.rmtree(os.path.join(e.disks[1].root, "b", "o"))
    assert e.get_object("b", "o")[0] == payload
    assert e.healer.heal_object("b", "o").healed_disks == [1]
    e.shutdown()


@pytest.mark.parametrize("backend_", BACKENDS)
def test_sets_and_pools_pass_backend_and_device(tmp_path, backend_):
    """ErasureSets gives its backend and device to every set's engine, and
    they reach every codec the engine builds (its own, per-object
    geometries, REGEN) and its bitrot calls."""
    p1 = _make_sets(tmp_path / "a", 8, (4, 4), backend=backend_)
    p2 = _make_sets(tmp_path / "b", 4, (4,), backend=backend_)
    pools = ErasureServerPools([p1, p2])
    want_bitrot = "auto" if backend_ == "auto" else torch.device("cpu")
    for pool in pools.pools:
        for eng in pool.sets:
            assert (eng.backend, eng.device) == (backend_,
                                                 torch.device("cpu"))
            assert eng.bitrot_device == want_bitrot
            for codec in (eng.codec, eng.codec_for(3, 1),
                          eng.codec_for(2, 2, algorithm=REGEN)):
                assert (codec.backend, codec.device) == (
                    backend_, torch.device("cpu"))
    assert eng.codec_for(2, 2, algorithm=REGEN).is_regen
    assert not getattr(eng.codec, "is_regen", False)
