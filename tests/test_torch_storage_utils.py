"""The host modules the port's storage layer brings with it, held to the
JAX package's: ``storage/format.py``, ``config/`` (kv, storageclass),
``utils/`` (siphash, compress with the native LZ block codec, streams,
dyntimeout, pipeline, phasetimer, profiler, locktrace),
``parallel/nslock.py`` and ``crypto/sse.py``.

Both packages run here on the CPU, on seeded inputs; every comparison is
byte-exact. Every test that starts a thread -- a Prefetch worker, the
sampling profiler, lock waiters -- stops and joins it, and the last test
of the file asserts that no thread it started is still running."""

from __future__ import annotations

import hashlib
import importlib.util
import io
import os
import struct
import threading
import time

import numpy as np
import pytest

from conftest import needs_crypto

from minio_tpu.config import kv as ref_kv
from minio_tpu.config import storageclass as ref_sc
from minio_tpu.crypto import sse as ref_sse
from minio_tpu.parallel import nslock as ref_nslock
from minio_tpu.storage import format as ref_fmt
from minio_tpu.storage import xl as ref_xl
from minio_tpu.utils import compress as ref_compress
from minio_tpu.utils import dyntimeout as ref_dyn
from minio_tpu.utils import phasetimer as ref_phasetimer
from minio_tpu.utils import pipeline as ref_pipeline
from minio_tpu.utils import siphash as ref_siphash
from minio_tpu.utils import streams as ref_streams
from minio_tpu_torch import native
from minio_tpu_torch.config import kv
from minio_tpu_torch.config import storageclass as sc
from minio_tpu_torch.crypto import sse
from minio_tpu_torch.parallel import nslock
from minio_tpu_torch.storage import format as fmt
from minio_tpu_torch.storage import xl
from minio_tpu_torch.utils import compress, dyntimeout, locktrace, \
    phasetimer, pipeline, profiler, siphash, streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The threads alive when this file's first test starts (module fixture).
THREADS_AT_START: set = set()
# Where the threads these tests start run their code: the port, this
# file, and the JAX package's pipeline and profiler it is compared with.
# Threads that other test files left behind run elsewhere.
OWN_THREAD_CODE = ("minio_tpu_torch.", __name__, "minio_tpu.utils.pipeline",
                   "minio_tpu.utils.profiler")


@pytest.fixture(scope="module", autouse=True)
def _thread_baseline():
    THREADS_AT_START.update(threading.enumerate())


def _try(fn):
    """("ok", value) or ("err", exception class name)."""
    try:
        return "ok", fn()
    except Exception as exc:  # noqa: BLE001 - the class is the result
        return "err", type(exc).__name__


def _rand(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n).astype(
        np.uint8).tobytes()


def _compressible(seed: int, n: int) -> bytes:
    """Seeded text-like bytes: 8-byte words of 32 kinds."""
    rng = np.random.default_rng(seed)
    words = rng.integers(97, 123, (32, 8)).astype(np.uint8)
    return words[rng.integers(0, 32, -(-n // 8))].tobytes()[:n]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# storage/format.py


@pytest.mark.parametrize("n", range(1, 65))
def test_pick_set_layout_matches_jax(n):
    assert _try(lambda: fmt.pick_set_layout(n)) == \
        _try(lambda: ref_fmt.pick_set_layout(n))


@pytest.mark.parametrize("n,size", [(32, 16), (30, 16), (12, 4), (12, 5),
                                    (64, 8), (3, 3)])
def test_pick_set_layout_with_set_size_matches_jax(n, size):
    assert _try(lambda: fmt.pick_set_layout(n, size)) == \
        _try(lambda: ref_fmt.pick_set_layout(n, size))


def _format_story(f, x, root, story: str):
    """Boot 8 drives, then one restart scenario; returns what a caller
    sees, with uuids replaced by their slot numbers."""
    drives = [x.XLStorage(str(root / f"d{i}"), **(
        {"device": "cpu"} if x is xl else {})) for i in range(8)]
    ref, ordered, fresh = f.init_or_load_formats(drives)
    slot = {u: i for i, u in enumerate(u for s in ref.sets for u in s)}
    first = ([len(s) for s in ref.sets], fresh,
             [drives.index(d) for d in ordered])
    if story == "reordered":
        drives = drives[::-1]
    elif story == "replacement":
        import shutil
        shutil.rmtree(drives[5].root)
        drives[5] = x.XLStorage(drives[5].root, **(
            {"device": "cpu"} if x is xl else {}))
    elif story == "foreign":
        alien = f.FormatErasure("another-deployment", "u", [["u"]])
        drives[2].write_all(x.MINIO_META_BUCKET, f.FORMAT_FILE,
                            alien.to_bytes())
    elif story == "duplicate":
        drives[3].write_all(x.MINIO_META_BUCKET, f.FORMAT_FILE,
                            drives[4].read_all(x.MINIO_META_BUCKET,
                                               f.FORMAT_FILE))
    elif story == "wrong-count":
        drives = drives[:7]
    got = _try(lambda: f.init_or_load_formats(drives))
    if got[0] == "ok":
        ref2, ordered2, fresh2 = got[1]
        got = ("ok", ref2.sets == ref.sets, fresh2,
               [slot[f.load_format(d).this] for d in ordered2],
               [drives.index(d) for d in ordered2])
    return first, got


@pytest.mark.parametrize("story", ["restart", "reordered", "replacement",
                                   "foreign", "duplicate", "wrong-count"])
def test_init_or_load_formats_matches_jax(story, tmp_path):
    assert _format_story(fmt, xl, tmp_path / "port", story) == \
        _format_story(ref_fmt, ref_xl, tmp_path / "jax", story)


def test_format_json_parses_across_packages():
    a = fmt.FormatErasure("dep", "u2", [["u1", "u2"], ["u3", "u4"]])
    raw = a.to_bytes()
    assert raw == ref_fmt.FormatErasure("dep", "u2", [["u1", "u2"],
                                                      ["u3", "u4"]]).to_bytes()
    b = ref_fmt.FormatErasure.from_bytes(raw)
    assert (b.deployment_id, b.this, b.sets, b.find("u3")) == \
        (a.deployment_id, a.this, a.sets, a.find("u3")) == \
        ("dep", "u2", [["u1", "u2"], ["u3", "u4"]], (1, 0))
    bad = raw.replace(b"xl-tpu", b"xl-xxx")
    assert _try(lambda: fmt.FormatErasure.from_bytes(bad)) == \
        ("err", "FileCorrupt") == \
        _try(lambda: ref_fmt.FormatErasure.from_bytes(bad))


# ---------------------------------------------------------------------------
# config/kv.py


class _Store:
    """The quorum config store's interface over a dict (the engine's
    ConfigStore is ported with the engine)."""

    def __init__(self):
        self.docs = {}

    def load(self, path):
        return self.docs.get(path)

    def save(self, path, doc):
        self.docs[path] = doc

    def delete(self, path):
        self.docs.pop(path, None)

    def list(self, prefix):
        return [p for p in self.docs if p.startswith(prefix + "/")]


KV_LINES = [
    'compression enable=on extensions=".txt,.log"',
    "audit_webhook:t1 endpoint=http://x",
    "compression justakey",
    "",
    '  scanner   delay=3  max_wait="5s"  ',
    'alerts rules=[{"a":1}] webhook_endpoint="http://h/p q"',
    'api requests_max=7 cors_allow_origin="a b c"',
    "x:y:z k=v=w",
]


@pytest.mark.parametrize("line", KV_LINES)
def test_parse_kv_line_matches_jax(line):
    assert _try(lambda: kv.parse_kv_line(line)) == \
        _try(lambda: ref_kv.parse_kv_line(line))


def _config_story(k, story: str):
    store, env, seen = _Store(), {}, []
    cfg = k.ConfigSys(store, env=env)
    cfg.on_change(lambda c: seen.append(c.get("scanner", "delay")))
    out = []
    if story == "precedence":
        out.append(cfg.get("compression", "enable"))
        cfg.set_kv("compression enable=on")
        out.append(cfg.get("compression", "enable"))
        env["MINIO_COMPRESSION_ENABLE"] = "off"
        out.append(cfg.get("compression", "enable"))
        out += [_try(lambda: cfg.get("nope", "enable")),
                _try(lambda: cfg.get("compression", "nope")),
                _try(lambda: cfg.set_kv("nope a=b")),
                _try(lambda: cfg.set_kv("compression nope=1"))]
    elif story == "persistence":
        cfg.set_kv("scanner delay=42")
        cfg.set_kv("audit_webhook:t1 endpoint=http://x")
        again = k.ConfigSys(store, env={})
        out += [again.get("scanner", "delay"), again.dump()]
    elif story == "history":
        cfg.set_kv("scanner delay=1")
        cfg.set_kv("scanner delay=2")
        ids = cfg.history_ids()
        cfg.restore(ids[-1])
        out += [len(ids), cfg.get("scanner", "delay")]
        cfg.del_kv("scanner")
        out += [cfg.get("scanner", "delay"), _try(lambda: cfg.restore("x"))]
    elif story == "bounded":
        for i in range(15):
            cfg.set_kv(f"scanner delay={i}")
        out.append(len(cfg.history_ids()))
    else:
        def veto(subsys, target, kvs):
            if kvs.get("delay") == "bad":
                raise ValueError("delay must be a number")
        cfg.validators.append(veto)
        out += [_try(lambda: cfg.set_kv("scanner delay=bad")),
                cfg.get("scanner", "delay"), cfg.get_subsys("heal")]
        cfg.on_change(lambda c: 1 / 0)
        cfg.set_kv("scanner delay=9")
    return out, seen, sorted(p.split("/")[1] for p in store.docs)


@pytest.mark.parametrize("story", ["precedence", "persistence", "history",
                                   "bounded", "validators"])
def test_config_sys_matches_jax(story):
    assert _config_story(kv, story) == _config_story(ref_kv, story)


def test_config_defaults_match_jax():
    assert kv.DEFAULT_KVS == ref_kv.DEFAULT_KVS
    assert (kv.CONFIG_PATH, kv.HISTORY_PREFIX, kv.MAX_HISTORY) == \
        (ref_kv.CONFIG_PATH, ref_kv.HISTORY_PREFIX, ref_kv.MAX_HISTORY)


# ---------------------------------------------------------------------------
# config/storageclass.py


EC_VALUES = ["", "EC:0", "EC:2", "EC:4", "EC:8", "EC:16", "EC:", "EC:x",
             "ec:2", "RS:2", "EC:2.5", "EC:-1"]


@pytest.mark.parametrize("value", EC_VALUES)
def test_storage_class_values_match_jax(value):
    env = {"MINIO_STORAGE_CLASS_STANDARD": value,
           "MINIO_STORAGE_CLASS_RRS": value,
           "MINIO_STORAGE_CLASS_REGEN_BUCKETS": " a, b ,,c "}
    got = _try(lambda: sc.StorageClassConfig.from_env(env))
    want = _try(lambda: ref_sc.StorageClassConfig.from_env(env))
    assert got == want or (got[0] == want[0] == "ok"
                           and vars(got[1]) == vars(want[1]))
    if got[0] == "err":
        assert got[1] == "InvalidStorageClass"
        return
    for cls in ("", sc.STANDARD, sc.RRS, sc.REGEN, "GLACIER"):
        for n, default in ((16, 4), (6, 3), (4, 2), (2, 1)):
            assert _try(lambda: got[1].parity_for(cls, n, default)) == \
                _try(lambda: want[1].parity_for(cls, n, default))
    for cls, bucket in (("", "a"), ("", "z"), (sc.STANDARD, "b"),
                        (sc.REGEN, "z")):
        assert got[1].use_regen(cls, bucket) == \
            want[1].use_regen(cls, bucket)


# ---------------------------------------------------------------------------
# utils/siphash.py


@pytest.mark.parametrize("n", list(range(16)) + [63, 64, 1000])
def test_siphash_matches_jax(n):
    key = bytes(range(16))
    msg = bytes(i % 256 for i in range(n))
    assert siphash.siphash24(key, msg) == ref_siphash.siphash24(key, msg)


def test_siphash_published_vectors():
    """SipHash-2-4 paper, appendix A (key 00..0f, message 00..0e), and
    the first entry of its reference vectors (empty message)."""
    key = bytes(range(16))
    assert siphash.siphash24(key, bytes(range(15))) == 0xa129ca6149be45e5
    assert siphash.siphash24(key, b"") == 0x726fdb47dd0e0e31
    with pytest.raises(ValueError):
        siphash.siphash24(b"short", b"x")


@pytest.mark.parametrize("card", [0, 1, 3, 16, 64])
def test_sip_hash_mod_matches_jax(card):
    dep = hashlib.md5(b"deployment").digest()
    for key in ("a", "bucket/object", "ünï/ßø", "x" * 300):
        assert siphash.sip_hash_mod(key, card, dep) == \
            ref_siphash.sip_hash_mod(key, card, dep)


# ---------------------------------------------------------------------------
# utils/compress.py and the native LZ block codec


@pytest.mark.parametrize("n", [16, 100, 4096, 300_000])
def test_lzb_matches_jax_native(n):
    from minio_tpu.native import lzb_compress_native as ref_c
    from minio_tpu.native import lzb_decompress_native as ref_d
    for data in (_compressible(n, n), _rand(n, n)):
        blob = native.lzb_compress_native(data)
        assert blob == ref_c(data)
        if blob is not None:
            assert native.lzb_decompress_native(blob, len(data)) == data
            assert ref_d(blob, len(data)) == data


def test_lzb_rejects_corrupt_and_declines_tiny():
    data = _compressible(1, 50_000)
    blob = native.lzb_compress_native(data)
    with pytest.raises(ValueError, match="corrupt"):
        native.lzb_decompress_native(b"\xff\xff" + blob[:10], len(data))
    assert native.lzb_compress_native(b"") is None
    assert native.lzb_compress_native(b"abc") is None


STREAM_SIZES = [0, 1, 100, compress.BLOCK - 1, compress.BLOCK,
                compress.BLOCK + 1, 3 * compress.BLOCK + 17]


@pytest.mark.parametrize("n", STREAM_SIZES)
def test_compress_stream_matches_jax(n):
    data = _compressible(n, n)
    blob = compress.compress_stream(data)
    assert blob == ref_compress.compress_stream(data)
    assert compress.decompress_stream(blob) == data
    r = compress.CompressingReader(streams.BytesReader(data), meta={},
                                   block=compress.BLOCK)
    assert streams.read_exactly(r, len(blob) + 5) == blob
    assert r.etag() == hashlib.md5(blob).hexdigest()


def test_compress_mixed_blocks_match_jax():
    data = (_compressible(1, compress.BLOCK) + _rand(2, compress.BLOCK)
            + _compressible(3, compress.BLOCK))
    blob = compress.compress_stream(data)
    assert blob == ref_compress.compress_stream(data)
    flags, off = [], 4
    while off < len(blob):
        flag, _, csize = struct.unpack_from("<BII", blob, off)
        flags.append(flag)
        off += 9 + csize
    assert flags == [compress.F_LZB, compress.F_RAW, compress.F_LZB]
    assert ref_compress.decompress_stream(blob) == data


RANGES = [(0, 10), (compress.BLOCK - 5, 10), (3 * compress.BLOCK + 100,
                                                2 * compress.BLOCK),
          (5 * compress.BLOCK + 283, 50), (0, 5 * compress.BLOCK + 333),
          (2 * compress.BLOCK, 0)]


@pytest.mark.parametrize("off,ln", RANGES)
def test_compress_range_matches_jax(off, ln):
    data = _compressible(3, 5 * compress.BLOCK + 333)
    blob = ref_compress.compress_stream(data)
    ln = min(ln, len(data) - off)
    got = compress.decompress_range(blob, off, ln)
    assert got == data[off:off + ln] == \
        ref_compress.decompress_range(blob, off, ln)
    chunks = [blob[i:i + 70_000] for i in range(0, len(blob), 70_000)]
    assert b"".join(compress.iter_decompress_range(chunks, off, ln)) == got


@pytest.mark.parametrize("blob", [b"XXXX", b"MTZ1\x01\x00", b"MTZ1" + struct.pack(
    "<BII", 9, 4, 4) + b"abcd", b"MTZ1" + struct.pack("<BII", 0, 4, 9) + b"ab"])
def test_compress_malformed_streams_match_jax(blob):
    assert _try(lambda: compress.decompress_stream(blob)) == \
        _try(lambda: ref_compress.decompress_stream(blob))


def test_compress_eligibility_matches_jax():
    for key, ct, size in (("a.txt", "text/plain", 10_000),
                          ("a.txt", "text/plain", 100),
                          ("movie.MP4", "", 1 << 20),
                          ("x.bin", "image/png", 1 << 20),
                          ("data.json", "application/json", 5000)):
        assert compress.is_compressible(key, ct, size) == \
            ref_compress.is_compressible(key, ct, size)


def test_compress_pin_of_the_chip_phase():
    """chip_smoke.py phase 17 compresses compressible_block(10 MiB) on
    the chip's native lane and holds it to COMPRESS_PIN: the JAX
    package's bytes, and the port's here."""
    cs = _chip_smoke()
    block = cs.compressible_block(np, 10 << 20).tobytes()
    want = hashlib.sha256(ref_compress.compress_stream(block)).hexdigest()
    assert want == cs.COMPRESS_PIN
    blob = compress.compress_stream(block)
    assert hashlib.sha256(blob).hexdigest() == cs.COMPRESS_PIN
    assert compress.decompress_stream(blob) == block


# ---------------------------------------------------------------------------
# utils/streams.py


def _stream_story(s, story: str):
    if story == "readers":
        r = s.IterReader(iter([b"ab", b"", b"cdef", b"g"]))
        b = s.BytesReader(b"hello world")
        return [r.read(3), r.read(10), r.read(1), b.read(5), b.read(100),
                b.read(1), s.read_exactly(s.ensure_reader(
                    io.BytesIO(b"xyz" * 10)), 25)]
    if story == "limit":
        r = s.LimitReader(io.BytesIO(b"0123456789"), 7)
        return [r.read(3), r.remaining(), r.read(10), r.read(1),
                r.remaining()]
    if story == "pushback":
        r = s.PushbackReader(b"xy", s.BytesReader(b"z123"))
        return [r.read(1), r.read(5), r.read(5)]
    if story == "batches":
        data = _rand(5, 10_000)
        return [s.batch_size(1000, 4096),
                [len(c) for c in s.iter_batches(s.BytesReader(data), 1000,
                                                4096)],
                b"".join(s.iter_batches(s.BytesReader(data), 1000,
                                        4096)) == data,
                list(s.iter_batches(s.BytesReader(b""), 10))]
    if story.startswith("hashing"):
        body = b"payload" * 100
        md5 = hashlib.md5(body).digest()
        sha = hashlib.sha256(body).hexdigest()
        cases = {"hashing ok": (md5, sha, len(body)),
                 "hashing bad md5": (b"\0" * 16, "", -1),
                 "hashing bad sha": (None, "0" * 64, -1),
                 "hashing short": (None, "", len(body) + 1),
                 "hashing long": (None, "", 10)}
        want_md5, want_sha, size = cases[story]
        r = s.HashingReader(s.BytesReader(body), want_md5, want_sha, size)
        read = _try(lambda: s.read_exactly(r, 10_000))
        return [read[0], _try(r.verify), r.etag(), r.size]
    chunked = {"chunked ok": b"5;ext=1\r\nhello\r\n6\r\n world\r\n0\r\n"
               b"T: v\r\n\r\n",
               "chunked bad size": b"zz\r\nhello\r\n0\r\n\r\n",
               "chunked no crlf": b"5\r\nhelloXX6\r\n world\r\n0\r\n\r\n",
               "chunked eof": b"5\r\nhel",
               "chunked too large": b"5\r\nhello\r\n6\r\n world\r\n0\r\n"
               b"\r\n"}[story]
    r = s.ChunkedTEReader(io.BytesIO(chunked),
                          max_decoded=8 if "large" in story else -1)
    out = []
    for _ in range(6):
        got = _try(lambda: r.read(4))
        out.append(got)
        if got[0] == "err" or got[1] == b"":
            break
    return out + [r.remaining()]


STREAM_STORIES = ["readers", "limit", "pushback", "batches", "hashing ok",
                  "hashing bad md5", "hashing bad sha", "hashing short",
                  "hashing long", "chunked ok", "chunked bad size",
                  "chunked no crlf", "chunked eof", "chunked too large"]


@pytest.mark.parametrize("story", STREAM_STORIES)
def test_streams_match_jax(story):
    assert _stream_story(streams, story) == \
        _stream_story(ref_streams, story)


# ---------------------------------------------------------------------------
# utils/dyntimeout.py


def _timeout_story(d, story: str):
    rng = np.random.default_rng(len(story))
    t = d.DynamicTimeout(1.0, 0.1, 4.0)
    out = []
    for window in range(6):
        for i in range(d.LOG_SIZE):
            if story == "failing" and i % 2:
                t.log_failure()
            elif story == "mixed" and rng.random() < 0.3 + 0.1 * window:
                t.log_failure()
            else:
                t.log_success(float(rng.random()) * (0.02 if story == "fast"
                                                     else 0.9))
        out.append(t.timeout)
    b = d.PercentileBudget(multiplier=3.0, floor=0.01, ceiling=1.0)
    for i in range(300):
        b.observe(float(rng.random()) * (0.05 if i < 200 else 0.5))
        if i % 50 == 49:
            out.append(b.budget())
    b.reset()
    return out + [b.budget()]


@pytest.mark.parametrize("story", ["fast", "failing", "mixed", "steady"])
def test_dyntimeout_matches_jax(story):
    assert _timeout_story(dyntimeout, story) == \
        _timeout_story(ref_dyn, story)


# ---------------------------------------------------------------------------
# parallel/nslock.py


def _lock_story(n, story: str):
    locks = n.LocalNSLock()
    events = []
    if story == "timeouts":
        with locks.write_locked("b", "o"):
            events.append(_try(lambda: locks.read_locked(
                "b", "o", timeout=0.05).__enter__()))
            with locks.read_locked("b", "other"):
                events.append("other key free")
        with locks.read_locked("b", "o"):
            with locks.read_locked("b", "o"):
                events.append("readers share")
            events.append(_try(lambda: locks.write_locked(
                "b", "o", timeout=0.05).__enter__()))
        events.append(len(locks._locks))
        return events
    # Writers exclude each other and readers: a counter bumped
    # non-atomically under the write lock loses no update.
    box = {"n": 0, "max_readers": 0, "readers": 0}
    mu = threading.Lock()

    def writer():
        for _ in range(50):
            with locks.write_locked("b", "o"):
                v = box["n"]
                time.sleep(0)
                box["n"] = v + 1

    def reader():
        for _ in range(50):
            with locks.read_locked("b", "o"):
                with mu:
                    box["readers"] += 1
                    box["max_readers"] = max(box["max_readers"],
                                             box["readers"])
                time.sleep(0)
                with mu:
                    box["readers"] -= 1
    threads = [threading.Thread(target=writer) for _ in range(4)] + \
        [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return [box["n"], box["readers"], len(locks._locks)]


@pytest.mark.parametrize("story", ["timeouts", "contention"])
def test_nslock_matches_jax(story):
    assert _lock_story(nslock, story) == _lock_story(ref_nslock, story)


# ---------------------------------------------------------------------------
# utils/pipeline.py, phasetimer.py, profiler.py, locktrace.py


def _joined(pf) -> None:
    """Close a Prefetch and join its worker (close() only waits a short
    grace)."""
    pf.close()
    if pf._thread is not None:
        pf._thread.join(timeout=10)
        assert not pf._thread.is_alive()


def _pipeline_story(p, story: str):
    if story == "order":
        pf = p.Prefetch((i * 7 for i in range(100)), depth=3, name="t")
        got = list(pf)
    elif story == "error":
        def src():
            yield 1
            yield 2
            raise KeyError("mid-stream")
        pf = p.Prefetch(src(), depth=2, name="t")
        got = []
        try:
            for v in pf:
                got.append(v)
        except KeyError as exc:
            got.append(repr(exc))
    elif story == "serial":
        pf = p.Prefetch(iter("abc"), depth=1, name="t")
        got = [pf._thread, list(pf)]
    elif story == "close":
        done = threading.Event()

        def src():
            try:
                yield from range(1000)
            finally:
                done.set()
        pf = p.Prefetch(src(), depth=2, name="t")
        got = [next(pf)]
        _joined(pf)
        got.append(done.wait(5.0))
    else:
        p.PIPE_STATS.reset()
        with p.Prefetch(iter(range(6)), depth=2, name="t-stats") as pf:
            got = list(pf)
        snap = p.PIPE_STATS.snapshot()["t-stats"]
        got += [snap["runs"], snap["items"],
                p.PipelineStats.overlap_factor(None, {"x": {
                    "items": 2, "wall_s": 2.0, "produce_s": 1.5,
                    "consume_s": 1.5}}, "x")]
    _joined(pf)
    return got


@pytest.mark.parametrize("story", ["order", "error", "serial", "close",
                                   "stats"])
def test_prefetch_matches_jax(story):
    assert _pipeline_story(pipeline, story) == \
        _pipeline_story(ref_pipeline, story)


def test_phase_timer_matches_jax():
    snaps = []
    for mod in (phasetimer, ref_phasetimer):
        t = mod.PhaseTimer()
        for ms in (1.0, 3.0, 2.0, 10.0):
            t.record("encode", ms)
        with t.phase("write"):
            pass
        snap = t.snapshot()
        snap["write"].pop("p50_ms")
        snap["write"].pop("max_ms")
        snaps.append(snap)
        t.reset()
        assert t.snapshot() == {}
    assert snaps[0] == snaps[1]
    assert snaps[0]["encode"] == {"count": 4, "p50_ms": 2.5, "max_ms": 10.0}


def test_sampling_profiler_samples_and_joins():
    prof = profiler.SamplingProfiler(interval=0.001)
    prof.start()
    with pytest.raises(RuntimeError, match="already running"):
        prof.start()
    deadline = time.time() + 5
    while prof.samples < 3 and time.time() < deadline:
        sum(range(10_000))
    thread = prof._thread
    report = prof.stop()
    assert not thread.is_alive() and prof._thread is None
    assert report["samples"] >= 3 and report["self"]
    here = [s for s in profiler.sample_stacks()
            if any(k[2] == "test_sampling_profiler_samples_and_joins"
                   for k in s)]
    assert here and profiler.frame_label(here[0][0]).endswith(")")


def test_locktrace_finds_a_lock_order_cycle():
    """The port's sanitizer, on raw locks of its own in an isolated graph:
    the session's tracer (tests/conftest.py) never sees this cycle."""
    import _thread
    with locktrace.isolated() as lt:
        a = locktrace._TracedLock(_thread.allocate_lock(), "site-a")
        b = locktrace._TracedLock(_thread.allocate_lock(), "site-b")
        with a, b:
            pass
        assert lt.cycles() == []
        with b, a:
            pass
        assert lt.cycles() == [["site-a", "site-b"]]
        assert "cycle: site-a -> site-b -> site-a" in lt.report()
    plain = threading.Lock()
    assert locktrace.transaction_lock(plain) is plain


# ---------------------------------------------------------------------------
# crypto/sse.py


@needs_crypto
@pytest.mark.parametrize("n", [0, 1, sse.PKG_SIZE - 1, sse.PKG_SIZE,
                               3 * sse.PKG_SIZE + 5])
def test_sse_streams_cross_decrypt(n):
    """A DARE stream sealed by one package opens in the other, its size
    is the same, and tampering fails both alike."""
    key = hashlib.sha256(b"object key").digest()
    data = _rand(n, n)
    for enc, dec in ((sse, ref_sse), (ref_sse, sse)):
        blob = enc.encrypt_stream(data, key)
        assert len(blob) == sse.ciphertext_size(n) == \
            ref_sse.ciphertext_size(n)
        assert dec.decrypt_stream(blob, key) == data
        if n:
            bad = blob[:20] + bytes([blob[20] ^ 1]) + blob[21:]
            with pytest.raises(dec.SSEError):
                dec.decrypt_stream(bad, key)
    r = sse.EncryptingReader(streams.BytesReader(data), key, meta={})
    blob = streams.read_exactly(r, 1 << 30)
    assert ref_sse.decrypt_stream(blob, key) == data


@needs_crypto
def test_sse_keys_and_ranges_cross_packages():
    master = bytes(range(32))
    obj_key = sse.new_object_key()
    sealed = sse.seal_key(master, obj_key, sse.SSE_S3, "b", "o")
    assert ref_sse.unseal_key(master, sealed, sse.SSE_S3, "b", "o") == obj_key
    with pytest.raises(ref_sse.KeyMismatch):
        ref_sse.unseal_key(master, sealed, sse.SSE_S3, "b", "other")
    assert sse.derive_part_key(obj_key, 3) == \
        ref_sse.derive_part_key(obj_key, 3)
    data = _rand(9, 4 * sse.PKG_SIZE + 77)
    blob = ref_sse.encrypt_stream(data, obj_key)

    def read(off, ln):
        return len(blob) if off is None else blob[off:off + ln]
    for off, ln in ((0, 10), (sse.PKG_SIZE - 3, 9), (len(data) - 5, 5)):
        assert sse.decrypt_range(read, obj_key, off, ln) == \
            data[off:off + ln]
    key = os.urandom(32)
    import base64
    headers = {sse.H_SSEC_ALGO: "AES256",
               sse.H_SSEC_KEY: base64.b64encode(key).decode(),
               sse.H_SSEC_KEY_MD5: base64.b64encode(
                   hashlib.md5(key).digest()).decode()}
    assert sse.parse_ssec_key(headers) == ref_sse.parse_ssec_key(headers)
    for broken in ({**headers, sse.H_SSEC_ALGO: "AES128"},
                   {**headers, sse.H_SSEC_KEY_MD5: "x"}):
        assert _try(lambda: sse.parse_ssec_key(broken)) == \
            _try(lambda: ref_sse.parse_ssec_key(broken))


# ---------------------------------------------------------------------------
# no thread outlives the tests above


def _runs_own_code(thread) -> bool:
    module = getattr(getattr(thread, "_target", None), "__module__", "")
    return (module or "").startswith(OWN_THREAD_CODE)


def test_no_thread_outlives_these_tests():
    """Every Prefetch worker, profiler sampler and lock waiter the tests
    of this file started has been joined: no thread running the port's
    code, or this file's, is alive that was not alive before them."""
    assert THREADS_AT_START
    left = [t for t in threading.enumerate()
            if t not in THREADS_AT_START and t.is_alive()
            and _runs_own_code(t)]
    assert left == []
    leak = threading.Thread(target=_lock_story, args=(nslock, "x"))
    assert _runs_own_code(leak)
