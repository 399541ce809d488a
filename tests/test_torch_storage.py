"""The port's storage layer (minio_tpu_torch/storage, obs/drivemon.py and
the drive and crash hooks of faultinject) held to the JAX package's.

Both packages run here on the CPU: the port's drives hash on
``device="cpu"`` (K2's plain version), the JAX package's as its own
tests run them. Every comparison is byte-exact: the golden xl.meta and
framed-shard pins, xl.meta documents carried across in both directions,
whole drive trees written by the same calls, the deep scan's verdicts,
the exception classes, the fault plan's fire pattern and the drive
monitor's state machine; and the storage slice as a whole over 16
drives at 12+4."""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from minio_tpu.erasure import bitrot as ref_bitrot
from minio_tpu.faultinject import FaultInjector as RefInjector
from minio_tpu.obs import drivemon as ref_dm
from minio_tpu.ops import rs_cpu as ref_rs_cpu
from minio_tpu.storage import errors as ref_serr
from minio_tpu.storage import format as ref_fmt
from minio_tpu.storage import metadata as ref_md
from minio_tpu.storage import xl as ref_xl
from minio_tpu_torch.erasure import bitrot
from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.faultinject import FAULTS, FaultInjector, \
    FaultPlanError, InjectedFault
from minio_tpu_torch.obs import drivemon as dm
from minio_tpu_torch.ops import batching
from minio_tpu_torch.storage import errors as serr
from minio_tpu_torch.storage import format as fmt
from minio_tpu_torch.storage import metadata as md
from minio_tpu_torch.storage import xl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_golden.py
XLMETA_LEN = 641
XLMETA_SHA = "a90a407905cbf26ae85d4e01d8842aabe1b1970199298e2cf7c19997638ab8e3"
FRAMED_LEN = 8256
FRAMED_DATA_SHA = \
    "fc894d69ec51feea973395d8b96f7be5cf7293f5cf0e9ebf7008157d3fc9fbb5"
FRAMED_DATA_FIRST_HASH = \
    "b2edb37d72d0a2d671c97136f0d594f5c9e68c6f6306ea8d4a8cd4fbffccb7d0"
FRAMED_PARITY_SHA = \
    "af6ef90e7d207f11e86d5f98bd73364dd2fbfaa3dc6bebdea0235e5e350d0fc9"

DD1 = "0a0a0a0a-1111-4111-8111-111111111111"
DD2 = "0b0b0b0b-2222-4222-8222-222222222222"

# The two packages' metadata modules, by package (a drive's package
# decides which XLStorage _drive makes).
PORT = {"md": md}
REF = {"md": ref_md}


def pattern(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    return ((i * 131 + 17) % 251).astype(np.uint8)


def _rand(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n).astype(
        np.uint8).tobytes()


def _drive(pkg, root):
    if pkg is PORT:
        return xl.XLStorage(str(root), device="cpu")
    return ref_xl.XLStorage(str(root))


def _tree(root) -> dict:
    """{relative path: bytes, or None for a directory} under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out[rel + "/"] = None
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def _try(fn):
    """("ok", value) or ("err", exception class name)."""
    try:
        return "ok", fn()
    except Exception as exc:  # noqa: BLE001 - the class is the result
        return "err", type(exc).__name__


# ---------------------------------------------------------------------------
# golden pins through the port


def test_golden_xlmeta_through_the_port():
    fi = md.FileInfo(
        volume="golden-bucket", name="golden/object.bin",
        version_id="11111111-2222-3333-4444-555555555555",
        data_dir="aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee",
        size=65536, mod_time=1700000000.123456,
        metadata={"content-type": "application/octet-stream",
                  "etag": "d41d8cd98f00b204e9800998ecf8427e"},
        parts=[md.ObjectPartInfo(number=1, size=65536, actual_size=65536,
                                 etag="d41d8cd98f00b204e9800998ecf8427e")],
        erasure=md.ErasureInfo(data_blocks=8, parity_blocks=4,
                               block_size=10485760, index=1,
                               distribution=list(range(1, 13)),
                               checksums=[{"part": 1,
                                           "algorithm": "highwayhash256S",
                                           "hash": ""}]),
    )
    meta = md.XLMeta()
    meta.add_version(fi)
    raw = meta.dump()
    assert len(raw) == XLMETA_LEN
    assert hashlib.sha256(raw).hexdigest() == XLMETA_SHA
    back = md.XLMeta.load(raw)
    fi2 = md.FileInfo.from_version_dict("golden-bucket", "golden/object.bin",
                                        back.find_version(fi.version_id))
    assert fi2.quorum_key() == fi.quorum_key()


@pytest.mark.parametrize("through", ["bitrot", "drive"])
def test_golden_shard_file_bitrot_framing_through_the_port(through,
                                                           tmp_path):
    """The framed shard files of tests/test_golden.py, framed by the
    port's bitrot on its CPU lane -- alone, or committed to and read back
    from a port drive whose deep scan passes them."""
    shards = ref_rs_cpu.encode_data(pattern(65536).tobytes(), 8, 4)
    framed = bitrot.encode_stream(shards[0].tobytes(), 4096, device="cpu")
    framed_p = bitrot.encode_stream(shards[8].tobytes(), 4096, device="cpu")
    if through == "drive":
        d = xl.XLStorage(str(tmp_path / "d"), device="cpu")
        d.make_volume("b")
        for n, blob in ((1, framed), (2, framed_p)):
            d.create_file(xl.MINIO_META_BUCKET, f"tmp/s/{DD1}/part.{n}",
                          blob)
        fi = md.FileInfo(volume="b", name="o", data_dir=DD1, size=8192,
                         parts=[md.ObjectPartInfo(1, 8192, 8192),
                                md.ObjectPartInfo(2, 8192, 8192)],
                         erasure=md.ErasureInfo(data_blocks=8,
                                                parity_blocks=4,
                                                block_size=8 * 4096,
                                                index=1))
        d.rename_data(xl.MINIO_META_BUCKET, "tmp/s", fi, "b", "o")
        d.verify_file("b", "o", fi)
        framed = d.read_all("b", f"o/{DD1}/part.1")
        framed_p = d.read_all("b", f"o/{DD1}/part.2")
    assert len(framed) == FRAMED_LEN
    assert hashlib.sha256(framed).hexdigest() == FRAMED_DATA_SHA
    assert framed[:32].hex() == FRAMED_DATA_FIRST_HASH
    assert hashlib.sha256(framed_p).hexdigest() == FRAMED_PARITY_SHA
    assert bitrot.decode_stream_at(framed, 0, 8192, 4096, device="cpu") == \
        shards[0].tobytes()


# ---------------------------------------------------------------------------
# xl.meta across packages


def _versions(m, case: str) -> list:
    """The FileInfo versions of one xl.meta case, built with package m."""
    ei = m.ErasureInfo
    rs = ei(data_blocks=4, parity_blocks=2, block_size=1 << 20, index=3,
            distribution=[3, 4, 5, 6, 1, 2],
            checksums=[{"part": 1, "algorithm": "highwayhash256S",
                        "hash": ""}])
    if case == "plain":
        return [m.FileInfo(volume="b", name="k/o", version_id="",
                           data_dir=DD1, size=5000, mod_time=1.5,
                           metadata={"etag": "e1"},
                           parts=[m.ObjectPartInfo(1, 5000, 5000, "e1")],
                           erasure=rs)]
    if case == "delete-marker":
        return [m.FileInfo(volume="b", name="o", version_id="v1",
                           data_dir=DD1, size=10, mod_time=1.0,
                           parts=[m.ObjectPartInfo(1, 10, 10)], erasure=rs),
                m.FileInfo(volume="b", name="o", version_id="v2",
                           deleted=True, mod_time=2.0)]
    if case == "versions":
        return [m.FileInfo(volume="b", name="o", version_id=f"v{i}",
                           data_dir=DD1 if i % 2 else DD2, size=100 * i,
                           mod_time=float(10 - i), erasure=rs,
                           parts=[m.ObjectPartInfo(1, 100 * i, 100 * i)])
                for i in range(1, 5)] + [
                    m.FileInfo(volume="b", name="o", version_id="v2",
                               size=7, mod_time=20.0)]
    if case == "multipart":
        return [m.FileInfo(
            volume="b", name="mp", version_id="u1", data_dir=DD2,
            size=3 * 5 * (1 << 20) + 17, mod_time=3.25,
            metadata={"x-internal-compression": "mtz/1",
                      "x-internal-actual-size": "99999999"},
            parts=[m.ObjectPartInfo(n, 5 * (1 << 20) if n < 4 else 17,
                                    6 * (1 << 20), f"etag-{n}")
                   for n in range(1, 5)],
            erasure=ei(data_blocks=4, parity_blocks=2, block_size=1 << 20,
                       index=1, distribution=[1, 2, 3, 4, 5, 6],
                       checksums=[{"part": n, "algorithm":
                                   "highwayhash256S", "hash": ""}
                                  for n in range(1, 5)]))]
    if case == "regen":
        return [m.FileInfo(
            volume="b", name="r", version_id="", data_dir=DD1,
            size=256 << 20, mod_time=4.0,
            metadata={"x-amz-storage-class": "REGEN"},
            parts=[m.ObjectPartInfo(1, 256 << 20, 256 << 20)],
            erasure=ei(algorithm=m.REGEN_ALGORITHM, data_blocks=12,
                       parity_blocks=4, block_size=10 << 20, index=7,
                       distribution=list(range(1, 17))))]
    assert case == "unicode"
    return [m.FileInfo(volume="b", name="ünï/cødé 😀", version_id="",
                       data_dir=DD1, size=1, mod_time=1700000000.987654,
                       metadata={"x-amz-meta-name": "naïve \"quoted\" ✓"},
                       erasure=ei(data_blocks=2, parity_blocks=2,
                                  block_size=4096, index=4,
                                  distribution=[4, 3, 2, 1],
                                  checksums=[{"part": 1, "algorithm":
                                              "sha256", "hash": "ab" * 32}]
                                  ))]


XLMETA_CASES = ["plain", "delete-marker", "versions", "multipart", "regen",
                "unicode"]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("case", XLMETA_CASES)
def test_xlmeta_parses_across_packages(case, writer):
    """An xl.meta written by one package parses in the other to the same
    FileInfo versions, re-dumps to the same bytes, and sizes its shards
    alike."""
    w, r = (md, ref_md) if writer == "port" else (ref_md, md)
    meta = w.XLMeta()
    for fi in _versions(w, case):
        meta.add_version(fi)
    raw = meta.dump()
    other = r.XLMeta()
    for fi in _versions(r, case):
        other.add_version(fi)
    assert other.dump() == raw
    back = r.XLMeta.load(raw)
    assert back.dump() == raw
    for v, want in zip(back.versions, meta.versions):
        got = r.FileInfo.from_version_dict("b", "o", v)
        ref = w.FileInfo.from_version_dict("b", "o", want)
        assert got.to_version_dict() == ref.to_version_dict()
        assert got.quorum_key() == ref.quorum_key()
        if got.erasure.data_blocks:
            assert got.erasure.shard_size() == ref.erasure.shard_size()


def test_xlmeta_rejects_a_foreign_format_alike():
    raw = b'{"format": "xl-other/9", "versions": []}'
    for m in (md, ref_md):
        with pytest.raises(ValueError, match="bad xl.meta format"):
            m.XLMeta.load(raw)


# ---------------------------------------------------------------------------
# drive trees across packages (the cases of tests/test_storage.py)


def _volume_lifecycle(d, p, root):
    d.make_volume("bucket1")
    return [d.list_volumes(), _try(lambda: d.make_volume("bucket1")),
            d.stat_volume("bucket1")["name"],
            _try(lambda: d.delete_volume("bucket1")),
            _try(lambda: d.stat_volume("bucket1"))]


def _invalid_volume_names(d, p, root):
    return [_try(lambda b=b: d.make_volume(b))
            for b in ("", ".", "..", "a/b", "a\\b", ".minio.sys")]


def _file_roundtrip(d, p, root):
    d.make_volume("v")
    d.write_all("v", "a/b/c.txt", b"hello")
    out = [d.read_all("v", "a/b/c.txt"), d.read_file("v", "a/b/c.txt", 1, 3),
           _try(lambda: d.read_all("v", "missing"))]
    d.append_file("v", "s/stream", b"one-")
    d.append_file("v", "s/stream", b"two")
    out.append(d.read_all("v", "s/stream"))
    d.delete("v", "a/b/c.txt")
    out += [_try(lambda: d.read_all("v", "a/b/c.txt")), d.list_dir("v", "")]
    return out


def _path_traversal(d, p, root):
    d.make_volume("v")
    return [_try(lambda: d.write_all("v", "../../etc/passwd", b"x")),
            _try(lambda: d.read_all("v", "../v/../../x")),
            _try(lambda: d.create_file("v", "../escape", b"x"))]


def _rename_file(d, p, root):
    d.make_volume("v")
    d.make_volume("w")
    d.write_all("v", "src.txt", b"data")
    d.rename_file("v", "src.txt", "w", "dst/deep.txt")
    return [d.read_all("w", "dst/deep.txt"),
            _try(lambda: d.read_all("v", "src.txt")),
            _try(lambda: d.rename_file("v", "gone", "w", "x"))]


def _version_merge(d, p, root):
    d.make_volume("b")
    m = p["md"]
    for vid, size, t in (("v1", 10, 1.0), ("v2", 20, 2.0), ("v2", 25, 3.0)):
        d.write_metadata("b", "o", m.FileInfo(volume="b", name="o",
                                              version_id=vid, size=size,
                                              mod_time=t))
    return [(fi.version_id, fi.size) for fi in d.read_versions("b", "o")]


def _rename_data_commit(d, p, root):
    d.make_volume("bucket")
    m = p["md"]
    d.create_file(xl.MINIO_META_BUCKET, f"tmp/stage1/{DD1}/part.1",
                  b"shard-bytes")
    d.append_file(xl.MINIO_META_BUCKET, f"tmp/stage1/{DD1}/part.2", b"ab")
    d.append_file(xl.MINIO_META_BUCKET, f"tmp/stage1/{DD1}/part.2", b"cd")
    d.create_file(xl.MINIO_META_BUCKET, f"tmp/stage1/{DD1}/part.3",
                  iter([b"streamed ", b"chunks"]))
    d.write_all(xl.MINIO_META_BUCKET, f"tmp/stage1/{xl.INTENT_FILE}", b"{}")
    fi = m.FileInfo(volume="bucket", name="obj/key", data_dir=DD1, size=11,
                    mod_time=1.0,
                    erasure=m.ErasureInfo(data_blocks=2, parity_blocks=1,
                                          block_size=1024, index=1,
                                          distribution=[1, 2, 3]))
    d.rename_data(xl.MINIO_META_BUCKET, "tmp/stage1", fi, "bucket",
                  "obj/key")
    got = d.read_version("bucket", "obj/key")
    return [got.size, got.data_dir, d.read_parts("bucket", "obj/key", DD1),
            d.read_all("bucket", f"obj/key/{DD1}/part.2"),
            d.list_dir("bucket", "obj/key"),
            d.list_dir(xl.MINIO_META_BUCKET, "tmp"),
            _try(lambda: d.read_parts("bucket", "obj/key", DD2))]


def _null_overwrite(d, p, root):
    d.make_volume("b")
    m = p["md"]
    for round_, dd in enumerate((DD1, DD2)):
        tmp = f"tmp/stage{round_}"
        d.create_file(xl.MINIO_META_BUCKET, f"{tmp}/{dd}/part.1",
                      f"data{round_}".encode())
        d.rename_data(xl.MINIO_META_BUCKET, tmp,
                      m.FileInfo(volume="b", name="o", data_dir=dd, size=5,
                                 mod_time=float(round_ + 1)), "b", "o")
    return [d.list_dir("b", "o"), d.read_version("b", "o").size]


def _delete_version(d, p, root):
    d.make_volume("b")
    m = p["md"]
    fi1 = m.FileInfo(volume="b", name="o", version_id="v1", mod_time=1.0,
                     data_dir=DD1)
    fi2 = m.FileInfo(volume="b", name="o", version_id="v2", mod_time=2.0,
                     data_dir=DD2)
    for fi, dd in ((fi1, DD1), (fi2, DD2)):
        d.write_metadata("b", "o", fi)
        d.write_all("b", f"o/{dd}/part.1", dd.encode())
    d.delete_version("b", "o", fi1)
    out = [d.read_version("b", "o").version_id, d.list_dir("b", "o")]
    d.delete_version("b", "o", fi2)
    out += [_try(lambda: d.read_version("b", "o")),
            _try(lambda: d.delete_version("b", "o2", fi1)),
            _try(lambda: d.list_dir("b", ""))]
    return out


def _verify_file(d, p, root):
    d.make_volume("b")
    m = p["md"]
    payload = _rand(7, 200)
    stream = ref_bitrot.encode_stream(payload, 64)
    d.write_all("b", f"o/{DD1}/part.1", stream)
    fi = m.FileInfo(volume="b", name="o", data_dir=DD1, size=200,
                    erasure=m.ErasureInfo(data_blocks=2, parity_blocks=1,
                                          block_size=128, index=1),
                    parts=[m.ObjectPartInfo(number=1, size=200,
                                            actual_size=200)])
    out = [_try(lambda: d.verify_file("b", "o", fi))]
    bad = bytearray(stream)
    bad[50] ^= 0xFF
    d.write_all("b", f"o/{DD1}/part.1", bytes(bad))
    out.append(_try(lambda: d.verify_file("b", "o", fi)))
    return out


TREE_CASES = {
    "volume_lifecycle": _volume_lifecycle,
    "invalid_volume_names": _invalid_volume_names,
    "file_roundtrip": _file_roundtrip,
    "path_traversal_blocked": _path_traversal,
    "rename_file": _rename_file,
    "xlmeta_version_merge": _version_merge,
    "rename_data_commit": _rename_data_commit,
    "null_version_overwrite_frees_old_datadir": _null_overwrite,
    "delete_version_lifecycle": _delete_version,
    "verify_file_detects_corruption": _verify_file,
}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_drive_trees_match_jax(case, tmp_path):
    """The same XLStorage calls on a port drive and a JAX-package drive
    return the same values and exception classes and leave identical
    file trees, byte for byte."""
    results, trees = [], []
    for pkg, name in ((PORT, "port"), (REF, "jax")):
        root = tmp_path / name
        d = _drive(pkg, root)
        results.append(TREE_CASES[case](d, pkg, root))
        trees.append(_tree(root))
    assert results[0] == results[1]
    assert trees[0] == trees[1]


# ---------------------------------------------------------------------------
# the deep scan


def _scan_stage(d, m, root, case):
    """Stage one object for a verify_file case; returns its FileInfo."""
    S = 64
    d.make_volume("b")
    p1 = ref_bitrot.encode_stream(_rand(1, 300), S)
    p2 = ref_bitrot.encode_stream(_rand(2, 129), S)
    algo = ref_bitrot.HIGHWAYHASH256S
    want = ""
    if case.startswith("whole-"):
        algo = {"whole-hh": ref_bitrot.HIGHWAYHASH256,
                "whole-hh-bad": ref_bitrot.HIGHWAYHASH256,
                "whole-sha-bad": ref_bitrot.SHA256}[case]
        p1 = _rand(1, 300)
        want = ref_bitrot.digest(algo, p1).hex()
        if case.endswith("-bad"):
            want = "00" + want[2:]
    edits = {
        "clean": lambda b: b,
        "data-frame-0": lambda b: b[:40] + bytes([b[40] ^ 1]) + b[41:],
        "hash-frame-1": lambda b: b[:96 + 5] + bytes([b[101] ^ 0x80])
        + b[102:],
        "tail-frame": lambda b: b[:-3] + bytes([b[-3] ^ 0xFF]) + b[-2:],
        "truncated": lambda b: b[:-10],
        "hash-only-tail": lambda b: b[:4 * 96] + b[4 * 96:4 * 96 + 32],
        "appended": lambda b: b + b"\0" * 7,
        "empty": lambda b: b"",
    }
    p1 = edits.get(case, lambda b: b)(p1)
    if case == "second-part":
        p2 = p2[:70] + bytes([p2[70] ^ 4]) + p2[71:]
    d.write_all("b", f"o/{DD1}/part.1", p1)
    d.write_all("b", f"o/{DD1}/part.2", p2)
    return m.FileInfo(
        volume="b", name="o", data_dir=DD1, size=429,
        parts=[m.ObjectPartInfo(1, 300, 300), m.ObjectPartInfo(2, 129, 129)],
        erasure=m.ErasureInfo(data_blocks=2, parity_blocks=2,
                              block_size=2 * S, index=1,
                              checksums=[{"part": 1, "algorithm": algo,
                                          "hash": want}]))


SCAN_CASES = {"clean": "ok", "data-frame-0": "FileCorrupt",
              "hash-frame-1": "FileCorrupt", "tail-frame": "FileCorrupt",
              "truncated": "FileCorrupt", "hash-only-tail": "FileCorrupt",
              "appended": "FileCorrupt", "empty": "ok",
              "second-part": "FileCorrupt", "whole-hh": "ok",
              "whole-hh-bad": "FileCorrupt", "whole-sha-bad": "FileCorrupt"}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_verify_file_verdicts_match_jax(case, tmp_path):
    """verify_file on the port's CPU lane passes and raises FileCorrupt on
    exactly the inputs the JAX package's does."""
    verdicts = []
    for pkg, name in ((PORT, "port"), (REF, "jax")):
        d = _drive(pkg, tmp_path / name)
        fi = _scan_stage(d, pkg["md"], tmp_path / name, case)
        verdicts.append(_try(lambda: d.verify_file("b", "o", fi)))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0] == (("ok", None) if SCAN_CASES[case] == "ok"
                           else ("err", SCAN_CASES[case]))


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_verify_file_without_a_card_raises(device, tmp_path, monkeypatch):
    """A drive on the card (the default) or on "auto" over the card's
    dispatch device raises from verify_file when no card is there; it
    never hashes on the host in the card's place."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    batching.set_dispatch_device("cuda")

    def host_hash(*a, **kw):
        raise AssertionError("hashed on the host")
    for name in ("_host_digest", "_host_digest_chunks", "_host_digest_rows",
                 "_host_digest_many"):
        monkeypatch.setattr(bitrot, name, host_hash)
    kw = {} if device == "cuda" else {"device": device}
    d = xl.XLStorage(str(tmp_path / "d"), **kw)
    assert d.device == device
    fi = _scan_stage(d, md, tmp_path / "d", "clean")
    batching.HH_STATS.reset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.verify_file("b", "o", fi)
    assert batching.HH_STATS.snapshot()["cpu_dispatches"] == 0


def test_drive_device_is_checked(tmp_path):
    for good in ("cpu", "cuda", "auto", torch.device("cpu")):
        assert xl.XLStorage(str(tmp_path / "d"), device=good).device == good
    with pytest.raises(ValueError, match="unsupported bitrot device"):
        xl.XLStorage(str(tmp_path / "d"), device="meta")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_verify_file_on_the_card_equals_the_cpu_lane(cuda_device, tmp_path):
    """K2 through verify_file on the card gives the CPU lane's verdicts."""
    for case, want in SCAN_CASES.items():
        d = xl.XLStorage(str(tmp_path / case), device=cuda_device)
        fi = _scan_stage(d, md, tmp_path / case, case)
        got = _try(lambda: d.verify_file("b", "o", fi))
        assert got == (("ok", None) if want == "ok" else ("err", want))


# ---------------------------------------------------------------------------
# errors


ERROR_CASES = {
    "path traversal": lambda d, m: d.write_all("v", "../../x", b"x"),
    "missing volume read": lambda d, m: d.read_all("nope", "x"),
    "missing volume list": lambda d, m: d.list_dir("nope", ""),
    "missing version": lambda d, m: d.read_version("v", "o", "nope"),
    "missing object": lambda d, m: d.read_version("v", "absent"),
    "missing version delete": lambda d, m: d.delete_version(
        "v", "o", m.FileInfo(version_id="nope")),
    "reserved volume delete": lambda d, m: d.delete_volume(".minio.sys"),
    "non-empty volume delete": lambda d, m: d.delete_volume("v"),
    "missing parts dir": lambda d, m: d.read_parts("v", "o", DD2),
    "corrupt xl.meta": lambda d, m: (
        d.write_all("v", "bad/xl.meta", b'{"format": "x"}'),
        d.read_version("v", "bad")),
    "missing file delete": lambda d, m: d.delete("v", "nothing"),
    "file as directory": lambda d, m: d.list_dir("v", "o/xl.meta"),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_classes_match_jax(case, tmp_path):
    got = []
    for pkg, name in ((PORT, "port"), (REF, "jax")):
        d = _drive(pkg, tmp_path / name)
        d.make_volume("v")
        d.write_metadata("v", "o", pkg["md"].FileInfo(
            volume="v", name="o", version_id="v1", mod_time=1.0))
        got.append(_try(lambda: ERROR_CASES[case](d, pkg["md"])))
    assert got[0] == got[1] and got[0][0] == "err"
    assert issubclass(getattr(serr, got[0][1]), serr.StorageError)


def test_error_taxonomy_matches_jax():
    port = {n: c for n, c in vars(serr).items() if isinstance(c, type)}
    ref = {n: c for n, c in vars(ref_serr).items() if isinstance(c, type)}
    assert sorted(port) == sorted(ref)
    for n, c in port.items():
        assert [b.__name__ for b in c.__mro__] == \
            [b.__name__ for b in ref[n].__mro__]


# ---------------------------------------------------------------------------
# fault kinds


def _fire_pattern(inj, rule: dict, calls: int = 10):
    """Run one rule over `calls` occurrences of its hook; the outcome of
    each occurrence and the rule's counters."""
    inj.load_plan({"seed": 11, "rules": [rule]})
    out = []
    kind = rule["kind"]
    for _ in range(calls):
        if kind in ("latency", "error"):
            out.append(_try(lambda: inj.disk_op("/disks/d05", "read_all")))
        elif kind == "corrupt":
            out.append(inj.filter_read("/disks/d05", "read_file",
                                       bytes(range(40))))
        elif kind == "torn_write":
            out.append(inj.filter_write("/disks/d05", "append_file",
                                        bytes(range(40))))
        elif kind in ("partition", "slow_wire"):
            out.append(inj.peer("10.0.0.2:9000"))
        elif kind == "kernel":
            out.append(_try(lambda: inj.kernel("rs_encode")))
        else:
            exits = []
            inj._exit = exits.append
            inj.crash_point("xl.rename_data.post_replace")
            out.append(list(exits))
    snap = inj.snapshot()
    inj.clear()
    return out, snap["rules"]


FAULT_RULES = {
    "latency": {"kind": "latency", "target": "d05", "op": "read",
                "latency_ms": 1, "after": 2, "count": 3},
    "error": {"kind": "error", "target": "/disks/d05", "op": "read_all",
              "after": 3, "count": 2},
    "error probability": {"kind": "error", "probability": 0.5},
    "error other op": {"kind": "error", "op": "write"},
    "corrupt": {"kind": "corrupt", "target": "d05", "op": "read",
                "after": 1, "count": 4},
    "corrupt probability": {"kind": "corrupt", "probability": 0.3},
    "torn_write": {"kind": "torn_write", "op": "append_file", "after": 4},
    "partition": {"kind": "partition", "target": "10.0.0.2", "count": 2},
    "slow_wire": {"kind": "slow_wire", "latency_ms": 30, "after": 5},
    "kernel": {"kind": "kernel", "target": "rs_", "after": 1, "count": 1},
    "crash": {"kind": "crash", "target": "post_replace", "after": 4,
              "count": 1},
    "crash other point": {"kind": "crash", "target": "pre_replace"},
}


@pytest.mark.parametrize("case", list(FAULT_RULES))
def test_fault_kinds_fire_alike(case):
    """Each kind fires after the same ``after`` / ``count`` (and the same
    seeded ``probability`` draws) in both packages, with the same
    effect: the same exceptions, bytes, wire verdicts and exits."""
    port = _fire_pattern(FaultInjector(), FAULT_RULES[case])
    ref = _fire_pattern(RefInjector(), FAULT_RULES[case])
    assert port == ref
    assert port[1][0]["seen"] == (0 if case.endswith("other op")
                                  or case.endswith("other point") else 10)


def test_injected_disk_error_is_the_ports_faulty_disk():
    inj = FaultInjector()
    inj.load_plan({"rules": [{"kind": "error"}]})
    with pytest.raises(serr.FaultyDisk, match="injected fault"):
        inj.disk_op("/d", "read_all")


def test_loop_block_is_refused_until_its_monitor_is_ported():
    # obs/loopmon.py is ported and consults the hook, so the kind is
    # accepted and both injectors know the same kinds.
    plan = {"rules": [{"kind": "loop_block", "target": "s3-0",
                       "latency_ms": 250}]}
    port, ref = FaultInjector(), RefInjector()
    port.load_plan(plan)
    ref.load_plan(plan)
    assert port.loop_block("s3-0") == ref.loop_block("s3-0") == 0.25
    assert port.loop_block("rpc") == ref.loop_block("rpc") == 0.0
    with pytest.raises(FaultPlanError, match="loop_stall"):
        FaultInjector().load_plan({"rules": [{"kind": "loop_stall"}]})
    assert set(RefInjector.validate.__globals__["KINDS"]) == \
        set(FaultInjector.validate.__globals__["KINDS"])


def test_kernel_fault_raises_injected_fault():
    inj = FaultInjector()
    inj.load_plan({"rules": [{"kind": "kernel", "target": "hh256"}]})
    inj.kernel("rs_encode")
    with pytest.raises(InjectedFault):
        inj.kernel("hh256")


def test_xl_registers_the_reference_crash_points():
    from minio_tpu.faultinject import FAULTS as REF_FAULTS
    names = [n for n in REF_FAULTS.crash_points() if n.startswith("xl.")]
    assert [n for n in FAULTS.crash_points() if n.startswith("xl.")] == \
        names == [xl.CRASH_RENAME_POST, xl.CRASH_RENAME_MID,
                  xl.CRASH_RENAME_PRE]


_CRASH_SCRIPT = textwrap.dedent('''
    import sys
    sys.path.insert(0, {root!r})
    pkg, root, point = sys.argv[1:4]
    if pkg == "port":
        from minio_tpu_torch.faultinject import FAULTS
        from minio_tpu_torch.storage import metadata as md, xl
        d = xl.XLStorage(root, device="cpu")
    else:
        from minio_tpu.faultinject import FAULTS
        from minio_tpu.storage import metadata as md, xl
        d = xl.XLStorage(root)
    d.make_volume("b")
    dd = "{dd}"
    for n in (1, 2):
        d.create_file(xl.MINIO_META_BUCKET, f"tmp/s{{n}}/{{dd}}/part.1",
                      b"v%d" % n)
        if n == 1:
            d.rename_data(xl.MINIO_META_BUCKET, "tmp/s1", md.FileInfo(
                volume="b", name="o", version_id="a", data_dir=dd,
                size=2, mod_time=1.0), "b", "o")
            dd = "{dd2}"
            FAULTS.load_plan({{"rules": [{{"kind": "crash",
                                          "target": point}}]}})
        else:
            d.rename_data(xl.MINIO_META_BUCKET, "tmp/s2", md.FileInfo(
                volume="b", name="o", version_id="b", data_dir=dd,
                size=2, mod_time=2.0), "b", "o")
    print("survived")
''')


CRASH_POINTS = ["pre_replace", "post_replace", "post_meta"]


@pytest.fixture(scope="module")
def crash_runs(tmp_path_factory):
    """Both packages' crash scripts for every point, started together:
    {point: {package: (process, drive root)}}; none outlives the
    module."""
    script = _CRASH_SCRIPT.format(root=ROOT, dd=DD1, dd2=DD2)
    env = dict(os.environ, JAX_PLATFORMS="cpu", MTPU_LOCKTRACE="0")
    base = tmp_path_factory.mktemp("crash")
    runs = {point: {pkg: (subprocess.Popen(
        [sys.executable, "-c", script, pkg, str(base / point / pkg),
         f"xl.rename_data.{point}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE), base / point / pkg)
        for pkg in ("port", "jax")} for point in CRASH_POINTS}
    yield runs
    for procs in runs.values():
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_rule_kills_the_process_at_the_same_state(point, crash_runs):
    """A fired crash rule exits the process with 137 at the named point
    of rename_data, in both packages alike, and leaves the same torn
    tree on disk."""
    procs = crash_runs[point]
    outs = {pkg: p.communicate(timeout=120)
            for pkg, (p, _) in procs.items()}
    for pkg, (p, _) in procs.items():
        assert p.returncode == 137, (pkg, outs[pkg][1][-2000:])
        assert b"survived" not in outs[pkg][0]
    trees = [_tree(procs[pkg][1]) for pkg in ("port", "jax")]
    assert trees[0] == trees[1]
    meta = trees[0]["b/o/xl.meta"]
    assert (b'"versionId": "b"' in meta) == (point == "post_meta")


# ---------------------------------------------------------------------------
# the drive monitor


OP_NAMES = sorted(ref_dm._OP_CLASS) + ["unknown_op", "", "repair_project"]


@pytest.mark.parametrize("op", OP_NAMES)
def test_op_class_matches_jax(op):
    assert dm.op_class(op) == ref_dm.op_class(op)


FAULT_EVIDENCE = ["FileNotFound", "VersionNotFound", "VolumeNotFound",
                  "VolumeExists", "DiskNotFound", "FaultyDisk", "FileCorrupt",
                  "DiskFull", "DriveQuarantined", "OSError",
                  "FileNotFoundError", "IsADirectoryError", "DeadlineExceeded",
                  None]


@pytest.mark.parametrize("as_type", [False, True])
@pytest.mark.parametrize("name", FAULT_EVIDENCE)
def test_is_drive_fault_matches_jax(name, as_type):
    builtin = {"OSError": OSError, "FileNotFoundError": FileNotFoundError,
               "IsADirectoryError": IsADirectoryError}
    other = type(str(name), (Exception,), {})

    def make(errors):
        if name is None:
            return None
        cls = getattr(errors, name, None) or builtin.get(name, other)
        return cls if as_type else cls("x")
    assert dm.is_drive_fault(make(serr)) == ref_dm.is_drive_fault(
        make(ref_serr))


def _monitor_script(mon, script: str):
    eps = [f"/disks/d{i:02d}" for i in range(4)]
    mon.register_set(eps)
    if script == "faulty":
        for i in range(64):
            mon.record(eps[1], "read_all", 1.0, error=i % 4 != 0)
            mon.record(eps[0], "write_all", 1.0)
    elif script == "suspect":
        for _ in range(3 * mon.WINDOW_OPS):
            for j, ep in enumerate(eps):
                mon.record(ep, "read_file", 50.0 if j == 2 else 1.0)
    else:
        mon.quarantine(eps[3], "test")
        for _ in range(mon.PROBATION_PASSES - 1):
            mon.probation_pass(eps[3])
        mon.probation_fail(eps[3])
        for _ in range(mon.PROBATION_PASSES):
            mon.probation_pass(eps[3])
    snap = mon.snapshot()
    for row in snap["drives"]:
        row.pop("changedAt")
    return snap, mon.counts(), mon.quarantined_endpoints()


@pytest.mark.parametrize("script", ["faulty", "suspect", "probation"])
def test_drive_monitor_state_machine_matches_jax(script):
    port = _monitor_script(dm.DriveMonitor(), script)
    ref = _monitor_script(ref_dm.DriveMonitor(), script)
    assert port == ref
    states = {r["state"] for r in port[0]["drives"]}
    assert states != {"ok"} or script == "probation"


def test_disk_ops_feed_the_drive_monitor(tmp_path):
    """A failing read on a port drive is recorded by DRIVEMON under the
    reference's op class, as drive-fault evidence."""
    d = xl.XLStorage(str(tmp_path / "d03"), device="cpu")
    d.make_volume("v")
    d.write_all("v", "x", b"1")
    dm.DRIVEMON.reset()
    FAULTS.load_plan({"rules": [{"kind": "error", "target": d.root,
                                 "op": "read"}]})
    try:
        with pytest.raises(serr.FaultyDisk):
            d.read_all("v", "x")
    finally:
        FAULTS.clear()
    assert d.read_all("v", "x") == b"1"
    row, = [r for r in dm.DRIVEMON.snapshot()["drives"]
            if r["endpoint"] == d.root]
    assert (row["opsTotal"], row["errsTotal"]) == (2, 1)
    dm.DRIVEMON.reset()


# ---------------------------------------------------------------------------
# the slice as a whole: format, commit, scan and rot over 16 drives


def _slice(pkg, root, payload: bytes, rot: tuple[int, int, int] | None):
    """Format 16 drives as one set, commit a 12+4 object with 64 KiB
    blocks to them, deep-scan every drive; rot one byte of (drive,
    frame) and scan again. Returns the verdicts and the drive trees less
    format.json."""
    k, m, bs = 12, 4, 64 * 1024
    S = -(-bs // k)
    drives = [_drive(pkg, root / f"d{i:02d}") for i in range(k + m)]
    fm = fmt if pkg is PORT else ref_fmt
    mdm = pkg["md"]
    layout, ordered, fresh = fm.init_or_load_formats(drives)
    assert (len(layout.sets), len(layout.sets[0]), fresh) == (1, 16, [])
    again = fm.init_or_load_formats(drives)
    assert again[0].sets == layout.sets and again[2] == []
    assert [fm.load_format(d).this for d in drives] == layout.sets[0]
    nfull = len(payload) // bs
    if pkg is PORT:
        codec = Erasure(k, m, block_size=bs, backend="cpu")
        full = np.zeros((nfull, k * S), dtype=np.uint8)
        full[:, :bs] = np.frombuffer(payload[:nfull * bs],
                                     np.uint8).reshape(nfull, bs)
        sm = codec.encode_blocks_batch_shardmajor(full.reshape(nfull, k, S))
        tail = codec.encode_data(payload[nfull * bs:])
        frames = bitrot.encode_stream_arrays(list(sm), device="cpu")
        tails = bitrot.encode_streams([t.tobytes() for t in tail], S,
                                      device="cpu")
        files = [f.tobytes() + t for f, t in zip(frames, tails)]
    else:
        shards = [b""] * (k + m)
        for b in range(nfull + 1):
            enc = ref_rs_cpu.encode_data(payload[b * bs:(b + 1) * bs], k, m)
            shards = [s + enc[j].tobytes() for j, s in enumerate(shards)]
        files = ref_bitrot.encode_streams(shards, S)
    verdicts = []
    for i, d in enumerate(drives):
        d.make_volume("bucket")
        d.create_file(xl.MINIO_META_BUCKET, f"tmp/put/{DD1}/part.1", files[i])
        fi = mdm.FileInfo(
            volume="bucket", name="obj", data_dir=DD1, size=len(payload),
            mod_time=1700000000.5, parts=[mdm.ObjectPartInfo(
                1, len(payload), len(payload))],
            erasure=mdm.ErasureInfo(
                data_blocks=k, parity_blocks=m, block_size=bs, index=i + 1,
                distribution=list(range(1, k + m + 1)),
                checksums=[{"part": 1, "algorithm": "highwayhash256S",
                            "hash": ""}]))
        d.rename_data(xl.MINIO_META_BUCKET, "tmp/put", fi, "bucket", "obj")
    fis = [d.read_version("bucket", "obj") for d in drives]
    verdicts.append([_try(lambda d=d, fi=fi: d.verify_file(
        "bucket", "obj", fi)) for d, fi in zip(drives, fis)])
    if rot is not None:
        drive, frame, at = rot
        path = os.path.join(drives[drive].root, "bucket", "obj", DD1,
                            "part.1")
        with open(path, "r+b") as f:
            f.seek(frame * (32 + S) + 32 + at)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0x5A]))
        verdicts.append([_try(lambda d=d, fi=fi: d.verify_file(
            "bucket", "obj", fi)) for d, fi in zip(drives, fis)])
    tree = {p: v for p, v in _tree(root).items()
            if not p.endswith("format.json")}
    return verdicts, tree, [fi.erasure.index for fi in fis]


def test_storage_slice_matches_jax(tmp_path):
    """Format, commit, scan and rot over 16 drives (12+4, 64 KiB blocks,
    5 full blocks and a tail): the port's drives hold the JAX package's
    files byte for byte, and both give the same verdicts -- every drive
    clean, then FileCorrupt on the rotted drive alone."""
    rot = (7, 3, 1000)
    payload = _rand(66, 5 * 64 * 1024 + 3001)
    port = _slice(PORT, tmp_path / "port", payload, rot)
    ref = _slice(REF, tmp_path / "jax", payload, rot)
    assert port == ref
    clean, rotted = port[0]
    assert clean == [("ok", None)] * 16
    assert rotted == [("err", "FileCorrupt") if i == rot[0] else ("ok", None)
                      for i in range(16)]
    assert port[2] == list(range(1, 17))
