"""The port's listing and cache layers (minio_tpu_torch/scanner/tracker.py,
listing/merge.py, listing/metacache.py, cache/hotcache.py) held to the
JAX package's.

Both packages run here on the CPU; the port's engines under ``"auto"``
with ``device="cpu"``, as in tests/test_torch_engine.py. The pure parts
are compared with the reference on the same seeded inputs: the update
tracker's bloom filters (their wire bytes), ``merge_resolve`` on random
per-disk walks, and listings of one drive tree through both packages'
metacache. The reference's metacache, tracker and hot-cache cases that
need no server run on the port's classes; the hot cache is reset and
disabled around every test, and every engine is shut down after it."""

from __future__ import annotations

import json
import random
import threading
import time

import numpy as np
import pytest

from minio_tpu.erasure.engine import ErasureObjects as RefEngine
from minio_tpu.listing.merge import merge_resolve as ref_merge_resolve
from minio_tpu.scanner.tracker import BloomFilter as RefBloom
from minio_tpu.scanner.tracker import DataUpdateTracker as RefTracker
from minio_tpu.storage.xl import XLStorage as RefXL
from minio_tpu_torch.cache.hotcache import HOTCACHE
from minio_tpu_torch.erasure.engine import ErasureObjects, ObjectNotFound
from minio_tpu_torch.listing.merge import merge_resolve
from minio_tpu_torch.listing.metacache import MetacacheManager
from minio_tpu_torch.obs.metrics2 import METRICS2
from minio_tpu_torch.scanner.tracker import BloomFilter, DataUpdateTracker
from minio_tpu_torch.storage.xl import XLStorage
from tests.test_torch_engine import _ENGINES, _cpu_dispatch  # noqa: F401

BLOCK = 64 * 1024


def port_engine(disks, k=None, m=None, block_size=8192):
    e = ErasureObjects(disks, k, m, block_size=block_size, backend="auto",
                       device="cpu")
    _ENGINES.append(e)
    return e


def drives(tmp_path, n, prefix="d"):
    return [XLStorage(str(tmp_path / f"{prefix}{i}"), device="auto")
            for i in range(n)]


@pytest.fixture
def engine(tmp_path):
    return port_engine(drives(tmp_path, 4))


# ---------------------------------------------------------------------------
# scanner/tracker.py


class TestTracker:
    def test_bloom(self):
        f = BloomFilter()
        f.add("bucket/a")
        assert "bucket/a" in f
        assert "bucket/b" not in f
        g = BloomFilter()
        g.add("bucket/c")
        f.merge(g)
        assert "bucket/c" in f
        h = BloomFilter.from_wire(f.to_wire())
        assert "bucket/a" in h and "bucket/c" in h

    def test_counters_and_cycles(self):
        t = DataUpdateTracker()
        assert t.bucket_counter("b") == 0
        t.mark("b", "x")
        t.mark("b", "y")
        assert t.bucket_counter("b") == 2
        assert t.changed_since(0, "b/x")
        done = t.advance_cycle()
        assert "b/x" in done
        assert t.cycle == 1
        assert t.changed_since(1, "b/x")
        assert not t.changed_since(0, "b/x")


@pytest.mark.parametrize("n_keys", [1, 50, 2000])
def test_bloom_wire_matches_reference(n_keys):
    """The same keys give the reference's filter bytes, and each package
    reads the other's wire form with the same membership answers."""
    rng = random.Random(n_keys)
    keys = [f"bucket-{rng.randrange(9)}/obj-{rng.randrange(1 << 30)}"
            for _ in range(n_keys)]
    f, g = BloomFilter(), RefBloom()
    for k in keys:
        f.add(k)
        g.add(k)
    assert f.to_wire() == g.to_wire()
    probes = keys[:20] + [f"absent/{i}" for i in range(200)]
    a = RefBloom.from_wire(f.to_wire())
    b = BloomFilter.from_wire(g.to_wire())
    assert [p in a for p in probes] == [p in b for p in probes] == \
        [p in f for p in probes]


def test_tracker_matches_reference():
    """The same marks and cycle advances: the same counters, cycle
    histories and change answers."""
    rng = random.Random(3)
    t, r = DataUpdateTracker(), RefTracker()
    probes = []
    for cycle in range(4):
        for _ in range(30):
            b, o = f"b{rng.randrange(3)}", f"o{rng.randrange(40)}"
            t.mark(b, o)
            r.mark(b, o)
            probes.append(f"{b}/{o}")
        assert t.advance_cycle().to_wire() == r.advance_cycle().to_wire()
    for b in ("b0", "b1", "b2", "b9"):
        assert t.bucket_counter(b) == r.bucket_counter(b)
    for since in range(5):
        for p in probes[::7] + ["b0/none"]:
            assert t.changed_since(since, p) == r.changed_since(since, p)


# ---------------------------------------------------------------------------
# listing/merge.py


class TestMergeResolve:
    def _e(self, name, vid, mt, kind="object"):
        return {"name": name,
                "versions": [{"type": kind, "versionId": vid,
                              "modTime": mt}]}

    def test_quorum_drop(self):
        streams = [[self._e("only-one", "v1", 5.0)], [], [], []]
        assert merge_resolve(streams, 2) == []

    def test_quorum_keep_and_merge_order(self):
        a = self._e("aaa", "v1", 1.0)
        b = self._e("bbb", "v2", 2.0)
        out = merge_resolve([[a, b], [a, b], [b], None], 2)
        assert [e["name"] for e in out] == ["aaa", "bbb"]

    def test_version_newest_first(self):
        e = {"name": "k", "versions": [
            {"type": "object", "versionId": "old", "modTime": 1.0},
            {"type": "object", "versionId": "new", "modTime": 9.0},
        ]}
        out = merge_resolve([[e], [e]], 2)
        assert [v["versionId"] for v in out[0]["versions"]] == \
            ["new", "old"]


@pytest.mark.parametrize("seed", range(12))
def test_merge_resolve_matches_reference(seed):
    """Random per-disk walks (missing entries, offline disks, divergent
    versions, delete markers): the reference's merged listing."""
    rng = random.Random(seed)
    n_disks = rng.choice([2, 4, 6, 16])
    names = sorted({f"k{rng.randrange(60):03d}/{rng.choice('abc')}"
                    for _ in range(40)})
    streams = []
    for _ in range(n_disks):
        if rng.random() < 0.15:
            streams.append(None)
            continue
        walk = []
        for name in names:
            if rng.random() < 0.2:
                continue
            vers = [{"type": rng.choice(["object", "object",
                                         "delete-marker"]),
                     "versionId": f"v{rng.randrange(3)}",
                     "modTime": float(rng.randrange(5))}
                    for _ in range(rng.randrange(1, 3))]
            walk.append({"name": name, "versions": vers})
        streams.append(walk)
    for quorum in (1, n_disks // 2 + 1, n_disks):
        assert merge_resolve(streams, quorum) == \
            ref_merge_resolve(streams, quorum)


# ---------------------------------------------------------------------------
# listing/metacache.py


class TestWalkDir:
    def test_walk_sorted_with_versions(self, engine):
        engine.make_bucket("wb")
        for name in ["z", "a/deep/key", "a/b", "mid"]:
            engine.put_object("wb", name, b"data-" + name.encode())
        entries = engine.disks[0].walk_dir("wb")
        names = [e["name"] for e in entries]
        assert names == sorted(names)
        assert set(names) == {"z", "a/deep/key", "a/b", "mid"}
        for e in entries:
            assert e["versions"], e
            assert "modTime" in e["versions"][0]

    def test_walk_prefix_pruning(self, engine):
        engine.make_bucket("wb")
        for name in ["a/1", "a/2", "ab", "b/1"]:
            engine.put_object("wb", name, b"x")
        got = [e["name"] for e in engine.disks[0].walk_dir("wb", "a/")]
        assert got == ["a/1", "a/2"]
        got = [e["name"] for e in engine.disks[0].walk_dir("wb", "a")]
        assert got == ["a/1", "a/2", "ab"]

    def test_walk_skips_data_dirs(self, engine):
        engine.make_bucket("wb")
        engine.put_object("wb", "obj", b"payload" * 100)
        assert [e["name"] for e in engine.disks[0].walk_dir("wb")] == \
            ["obj"]


class TestMetacache:
    def test_cache_hit_until_write(self, engine):
        engine.make_bucket("mb")
        engine.put_object("mb", "one", b"1")
        mc = engine.metacache
        assert [o.name for o in engine.list_objects("mb")] == ["one"]
        scans = mc.scans
        engine.list_objects("mb")
        engine.list_objects("mb", prefix="o")
        assert mc.scans == scans
        engine.put_object("mb", "two", b"2")
        assert [o.name for o in engine.list_objects("mb")] == \
            ["one", "two"]
        assert mc.scans == scans + 1

    def test_delete_invalidates(self, engine):
        engine.make_bucket("mb")
        engine.put_object("mb", "gone", b"x")
        assert [o.name for o in engine.list_objects("mb")] == ["gone"]
        engine.delete_object("mb", "gone")
        assert engine.list_objects("mb") == []

    def test_versions_view_with_delete_marker(self, engine):
        engine.make_bucket("mb")
        engine.put_object("mb", "k", b"v1", versioned=True)
        engine.put_object("mb", "k", b"v2", versioned=True)
        engine.delete_object("mb", "k", versioned=True)
        assert engine.list_objects("mb") == []
        vers = engine.list_object_versions("mb")
        assert len(vers) == 3
        assert vers[0].delete_marker
        assert not vers[1].delete_marker

    def test_marker_pagination(self, engine):
        engine.make_bucket("mb")
        for i in range(10):
            engine.put_object("mb", f"k{i:02d}", b"x")
        page1 = engine.list_objects("mb", max_keys=4)
        assert [o.name for o in page1] == ["k00", "k01", "k02", "k03"]
        page2 = engine.list_objects("mb", max_keys=4,
                                    marker=page1[-1].name)
        assert [o.name for o in page2] == ["k04", "k05", "k06", "k07"]

    def test_blocks_persisted_and_loadable(self, engine):
        engine.make_bucket("mb")
        for i in range(7):
            engine.put_object("mb", f"p/{i}", b"x")
        engine.list_objects("mb", prefix="p/")
        engine.metacache.last_persist.join(timeout=10)
        found = None
        for d in engine.disks:
            try:
                ids = d.list_dir(".minio.sys", "buckets/mb/.metacache")
            except Exception:  # noqa: BLE001 - no cache on this drive
                continue
            for cid in ids:
                cid = cid.rstrip("/")
                try:
                    info = json.loads(d.read_all(
                        ".minio.sys",
                        f"buckets/mb/.metacache/{cid}/info.json"))
                except Exception:  # noqa: BLE001 - torn or absent
                    continue
                found = (d, cid, info)
                break
            if found:
                break
        assert found, "no persisted metacache blocks"
        d, cid, info = found
        entries = MetacacheManager.load_persisted(d, "mb", cid)
        assert len(entries) == info["entries"] == 7
        assert entries[0]["name"] == "p/0"

    def test_persisted_blocks_replaced_not_accumulated(self, engine):
        engine.make_bucket("mb")
        for round_ in range(3):
            engine.put_object("mb", f"g{round_}", b"x")
            engine.list_objects("mb")
            engine.metacache.last_persist.join(timeout=10)
        ids = set()
        for d in engine.disks:
            try:
                ids.update(x.rstrip("/") for x in d.list_dir(
                    ".minio.sys", "buckets/mb/.metacache"))
            except Exception:  # noqa: BLE001 - no cache on this drive
                continue
        assert len(ids) <= 1, f"stale cache ids left behind: {ids}"

    def test_quorum_listing_with_offline_disk(self, engine):
        engine.make_bucket("mb")
        engine.put_object("mb", "survivor", b"x")
        engine.disks[0].walk_dir = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("disk down"))
        engine.update_tracker.mark("mb")
        assert [o.name for o in engine.list_objects("mb")] == ["survivor"]


def test_walk_dir_iter_order_and_resume(engine):
    engine.make_bucket("ob")
    names = ["ab-x", "ab/c", "ab/d/e", "abc", "a", "z/9"]
    for n in names:
        engine.put_object("ob", n, b"x")
    disk = engine.disks[0]
    got = [e["name"] for e in disk.walk_dir_iter("ob")]
    assert got == sorted(names)
    assert got == [e["name"] for e in disk.walk_dir("ob")]
    for i, cut in enumerate(got):
        resumed = [e["name"] for e in disk.walk_dir_iter("ob", after=cut)]
        assert resumed == got[i + 1:], cut


def test_peer_fetch_counter_commits_only_after_forced_page():
    """_entries_for records the tracker counter only after the owner has
    served the first forced page (never-iterated listings, transport
    failures and empty pages included)."""

    class _Tracker:
        counter = 1
        cycle = 0

        def bucket_counter(self, bucket):
            return self.counter

    class _Eng:
        update_tracker = _Tracker()
        disks = []
        k = 1

    class _Share:
        def __init__(self):
            self.fetches = []
            self.fail_next = False
            self.entries = [{"name": "a", "versions": []}]

        def owner_key(self, bucket, root):
            return "peer-1"

        def fetch_entries(self, owner, share_id, bucket, root,
                          after="", force=False):
            self.fetches.append(bool(force))
            if self.fail_next:
                self.fail_next = False
                raise ConnectionError("owner down")
            yield from self.entries

    mgr = MetacacheManager(_Eng())
    share = _Share()
    mgr.peer_share = share
    mgr._entries_local = lambda bucket, root: []
    gen = mgr._entries_for("mb", "")
    del gen
    assert share.fetches == []
    assert list(mgr._entries_for("mb", "")) == share.entries
    assert share.fetches == [True]
    assert list(mgr._entries_for("mb", "")) == share.entries
    assert share.fetches == [True, False]
    _Eng.update_tracker.counter = 2
    share.fail_next = True
    assert list(mgr._entries_for("mb", "")) == []
    assert share.fetches == [True, False, True]
    assert list(mgr._entries_for("mb", "")) == share.entries
    assert share.fetches == [True, False, True, True]
    assert list(mgr._entries_for("mb", "")) == share.entries
    assert share.fetches[-1] is False
    _Eng.update_tracker.counter = 3
    share.entries = []
    assert list(mgr._entries_for("mb", "")) == []
    assert share.fetches[-1] is True
    assert list(mgr._entries_for("mb", "")) == []
    assert share.fetches[-1] is False


def _listing_view(e, prefix=""):
    return ([(o.name, o.size, o.etag, o.version_id, o.delete_marker)
             for o in e.list_objects("lb", prefix=prefix)],
            [(o.name, o.size, o.etag, o.version_id, o.delete_marker)
             for o in e.list_object_versions("lb", prefix=prefix)])


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("prefix", ["", "a/", "a", "z"])
def test_metacache_listing_matches_reference(tmp_path, writer, prefix):
    """One drive tree, written by either package (versions, delete
    markers, nested prefixes, a key missing on one drive), listed through
    both packages' metacache: the same objects and versions."""
    rng = random.Random(5)
    port = port_engine(drives(tmp_path, 6), 4, 2, block_size=4096)
    ref = RefEngine([RefXL(d.root) for d in port.disks], 4, 2,
                    block_size=4096)
    _ENGINES.append(ref)
    w = port if writer == "port" else ref
    w.make_bucket("lb")
    for i in range(25):
        name = rng.choice(["a/", "a-", "ab/", "z/", ""]) + f"k{i:02d}"
        w.put_object("lb", name, b"x" * rng.randrange(1, 9000),
                     versioned=rng.random() < 0.3)
        if rng.random() < 0.2:
            w.delete_object("lb", name, versioned=True)
    assert _listing_view(port, prefix) == _listing_view(ref, prefix)


# ---------------------------------------------------------------------------
# cache/hotcache.py (tests/test_hotcache.py's cases that need no server)


@pytest.fixture
def hot():
    """Every hot-cache test starts and ends with the port's process-wide
    cache empty and DISABLED (its default)."""
    HOTCACHE.reset()
    HOTCACHE.peer_notify = None
    yield
    HOTCACHE.configure(enable=False, mem_bytes=128 << 20,
                       disk_bytes=1 << 30, dirs=[], min_hits=1,
                       max_object_bytes=32 << 20, revalidate_s=1.0)
    HOTCACHE.reset()
    HOTCACHE.peer_notify = None


def _enable(**over):
    cfg = dict(enable=True, mem_bytes=64 << 20, disk_bytes=1 << 30,
               dirs=[], min_hits=1, max_object_bytes=8 << 20,
               revalidate_s=3600.0)
    cfg.update(over)
    HOTCACHE.configure(**cfg)


class _Disk:
    """Delegating disk wrapper: records read calls into a shared list
    and optionally gates read_file on an event."""

    def __init__(self, inner, calls: list, gate=None, entered=None):
        self._inner = inner
        self._calls = calls
        self._gate = gate
        self._entered = entered

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in ("read_file", "read_version") and callable(attr):
            def wrapped(*a, _name=name, _attr=attr, **kw):
                self._calls.append(_name)
                if _name == "read_file":
                    if self._entered is not None:
                        self._entered.set()
                    if self._gate is not None and not self._gate.wait(20):
                        raise RuntimeError("test gate timed out")
                return _attr(*a, **kw)
            return wrapped
        return attr

    def __repr__(self):
        return repr(self._inner)


def _engine(tmp_path, calls=None, gate=None, entered=None, n=6, k=4):
    disks = drives(tmp_path, n)
    if calls is not None:
        disks = [_Disk(d, calls, gate, entered) for d in disks]
    eng = port_engine(disks, k, n - k, block_size=BLOCK)
    eng.hedge_enabled = False
    return eng


def _wait(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


class _MDelta:
    def __init__(self, name, labels=None):
        self._name, self._labels = name, labels
        self._base = METRICS2.get(name, labels)

    def value(self):
        return METRICS2.get(self._name, self._labels) - self._base


def _start(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def test_mem_hit_serves_without_any_disk_io(tmp_path, hot):
    calls: list = []
    eng = _engine(tmp_path, calls)
    _enable()
    eng.make_bucket("b")
    body = b"H" * (BLOCK * 2 + 777)
    eng.put_object("b", "hot", body)
    data, info = eng.get_object("b", "hot")
    assert data == body
    before = len(calls)
    data, info2 = eng.get_object("b", "hot")
    assert data == body and info2.etag == info.etag
    assert len(calls) == before
    assert eng.get_object_info("b", "hot").etag == info.etag
    assert len(calls) == before
    snap = HOTCACHE.snapshot()
    assert snap["counters"]["hit_mem"] >= 1
    assert snap["counters"]["fill"] == 1


def test_range_hit_served_from_mem_slice(tmp_path, hot):
    calls: list = []
    eng = _engine(tmp_path, calls)
    _enable()
    eng.make_bucket("b")
    body = bytes(range(256)) * (BLOCK // 128)
    eng.put_object("b", "r", body)
    eng.get_object("b", "r")
    before = len(calls)
    data, _ = eng.get_object("b", "r", offset=100, length=5000)
    assert data == body[100:5100]
    assert len(calls) == before


def test_disabled_cache_is_inert(tmp_path, hot):
    calls: list = []
    eng = _engine(tmp_path, calls)
    eng.make_bucket("b")
    eng.put_object("b", "k", b"x" * BLOCK)
    r1 = calls.count("read_file")
    assert eng.get_object("b", "k")[0] == b"x" * BLOCK
    assert eng.get_object("b", "k")[0] == b"x" * BLOCK
    assert calls.count("read_file") >= r1 + 8
    assert HOTCACHE.snapshot()["counters"]["fill"] == 0


def test_concurrent_cold_gets_pay_exactly_one_erasure_read(tmp_path, hot):
    calls: list = []
    gate, entered = threading.Event(), threading.Event()
    eng = _engine(tmp_path, calls, gate, entered)
    _enable()
    eng.make_bucket("b")
    body = b"Z" * (BLOCK + 13)
    gate.set()
    eng.put_object("b", "one", body)
    calls.clear()
    gate.clear()
    results: list = []
    errors: list = []

    def get():
        try:
            results.append(eng.get_object("b", "one")[0])
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    t1 = _start(get)
    _wait(lambda: entered.is_set(), msg="filler to reach read_file")
    _wait(lambda: HOTCACHE.snapshot()["fillsInFlight"] == 1,
          msg="fill registration")
    rest = [_start(get) for _ in range(7)]
    _wait(lambda: HOTCACHE.snapshot()["counters"]["coalesced"] == 7,
          msg="7 coalesced waiters")
    gate.set()
    for t in [t1] + rest:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors
    assert results == [body] * 8
    assert calls.count("read_file") == 4
    snap = HOTCACHE.snapshot()
    assert snap["counters"]["coalesced"] == 7
    assert snap["counters"]["fill"] == 1
    before = len(calls)
    assert eng.get_object("b", "one")[0] == body
    assert len(calls) == before


def test_waiter_falls_back_when_filler_abandons(tmp_path, hot):
    eng = _engine(tmp_path)
    _enable()
    eng.make_bucket("b")
    body = b"W" * (BLOCK * 3)
    eng.put_object("b", "k", body)
    aband = _MDelta("minio_tpu_v2_cache_fills_total",
                    {"result": "abandoned"})
    fallb = _MDelta("minio_tpu_v2_cache_fills_total",
                    {"result": "waiter_fallback"})
    info, stream = eng.get_object_stream("b", "k")
    assert HOTCACHE.snapshot()["fillsInFlight"] == 1
    got: list = []
    t = _start(lambda: got.append(eng.get_object("b", "k")[0]))
    _wait(lambda: HOTCACHE.snapshot()["counters"]["coalesced"] == 1,
          msg="waiter join")
    stream.close()
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == [body]
    assert aband.value() == 1
    assert fallb.value() == 1


def test_overwrite_then_delete_invalidate(tmp_path, hot):
    eng = _engine(tmp_path)
    _enable()
    eng.make_bucket("b")
    eng.put_object("b", "k", b"v1" * BLOCK)
    assert eng.get_object("b", "k")[0] == b"v1" * BLOCK
    assert eng.get_object("b", "k")[0] == b"v1" * BLOCK
    eng.put_object("b", "k", b"v2" * BLOCK)
    assert eng.get_object("b", "k")[0] == b"v2" * BLOCK
    eng.delete_object("b", "k")
    with pytest.raises(ObjectNotFound):
        eng.get_object("b", "k")
    assert HOTCACHE.snapshot()["counters"]["invalidate"] >= 2


def test_invalidation_during_fill_discards_entry(tmp_path, hot):
    calls: list = []
    gate, entered = threading.Event(), threading.Event()
    eng = _engine(tmp_path, calls, gate, entered)
    _enable()
    eng.make_bucket("b")
    body = b"OLD" * BLOCK
    gate.set()
    eng.put_object("b", "k", body)
    gate.clear()
    inval = _MDelta("minio_tpu_v2_cache_fills_total",
                    {"result": "invalidated"})
    out: list = []
    t = _start(lambda: out.append(eng.get_object("b", "k")[0]))
    _wait(lambda: entered.is_set() and
          HOTCACHE.snapshot()["fillsInFlight"] == 1, msg="fill in flight")
    HOTCACHE.invalidate("b", "k", propagate=False, source="peer")
    gate.set()
    t.join(timeout=30)
    assert out == [body]
    assert inval.value() == 1
    before = calls.count("read_file")
    assert eng.get_object("b", "k")[0] == body
    assert calls.count("read_file") > before


def test_disable_mid_fill_never_admits(tmp_path, hot):
    calls: list = []
    gate, entered = threading.Event(), threading.Event()
    eng = _engine(tmp_path, calls, gate, entered)
    _enable()
    eng.make_bucket("b")
    body = b"off" * BLOCK
    gate.set()
    eng.put_object("b", "k", body)
    gate.clear()
    out: list = []
    t = _start(lambda: out.append(eng.get_object("b", "k")[0]))
    _wait(lambda: entered.is_set() and
          HOTCACHE.snapshot()["fillsInFlight"] == 1, msg="fill in flight")
    _enable(enable=False)
    gate.set()
    t.join(timeout=30)
    assert out == [body]
    snap = HOTCACHE.snapshot()
    assert snap["memEntries"] == 0 and snap["memBytesUsed"] == 0, snap


def test_delete_during_coalesced_wait(tmp_path, hot):
    calls: list = []
    gate, entered = threading.Event(), threading.Event()
    eng = _engine(tmp_path, calls, gate, entered)
    _enable()
    eng.make_bucket("b")
    body = b"D" * (BLOCK * 2)
    gate.set()
    eng.put_object("b", "k", body)
    gate.clear()
    out: list = []
    errs: list = []

    def get():
        try:
            out.append(eng.get_object("b", "k")[0])
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    t1 = _start(get)
    _wait(lambda: entered.is_set(), msg="filler blocked in read")
    t2 = _start(get)
    _wait(lambda: HOTCACHE.snapshot()["counters"]["coalesced"] == 1,
          msg="coalesced waiter")
    deleted = threading.Event()
    t3 = _start(lambda: (eng.delete_object("b", "k"), deleted.set()))
    time.sleep(0.1)
    assert not deleted.is_set()
    gate.set()
    for t in (t1, t2, t3):
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errs, errs
    assert out == [body, body]
    with pytest.raises(ObjectNotFound):
        eng.get_object("b", "k")


def test_lost_peer_invalidation_caught_by_etag_revalidation(tmp_path, hot,
                                                            monkeypatch):
    stale = _MDelta("minio_tpu_v2_cache_stale_total", {"tier": "mem"})
    disks = drives(tmp_path, 6)
    a = port_engine(disks, 4, 2, block_size=BLOCK)
    b = port_engine(disks, 4, 2, block_size=BLOCK)
    a.hedge_enabled = b.hedge_enabled = False
    _enable(revalidate_s=3600.0)
    a.make_bucket("b")
    v1, v2 = b"one" * BLOCK, b"two" * BLOCK
    a.put_object("b", "k", v1)
    assert a.get_object("b", "k")[0] == v1
    assert a.get_object("b", "k")[0] == v1
    with monkeypatch.context() as mp:
        mp.setattr(HOTCACHE, "invalidate", lambda *args, **kw: None)
        b.put_object("b", "k", v2)
    assert a.get_object("b", "k")[0] == v1
    _enable(revalidate_s=0.0)
    assert a.get_object("b", "k")[0] == v2
    assert stale.value() == 1


def test_multipart_complete_invalidates(tmp_path, hot):
    eng = _engine(tmp_path)
    _enable()
    eng.make_bucket("b")
    eng.put_object("b", "k", b"plain" * BLOCK)
    assert eng.get_object("b", "k")[0] == b"plain" * BLOCK
    assert eng.get_object("b", "k")[0] == b"plain" * BLOCK
    up = eng.multipart.new_multipart_upload("b", "k", {})
    part_body = b"mp" * BLOCK
    part = eng.multipart.put_object_part("b", "k", up, 1, part_body)
    eng.multipart.complete_multipart_upload("b", "k", up,
                                            [(1, part["etag"])])
    assert eng.get_object("b", "k")[0] == part_body


def test_invalidation_notifies_peers(tmp_path, hot):
    """The engine's local invalidation pushes (bucket, key, epoch) to the
    peer hook; a peer-sourced invalidation drops the entry."""
    eng = _engine(tmp_path)
    _enable()
    pushed: list = []
    HOTCACHE.peer_notify = lambda b, k, e: pushed.append((b, k, e))
    eng.make_bucket("b")
    eng.put_object("b", "k", b"x" * BLOCK)
    assert eng.get_object("b", "k")[0] == b"x" * BLOCK
    eng.put_object("b", "k", b"y" * BLOCK)
    assert pushed and pushed[-1][:2] == ("b", "k") and pushed[-1][2] >= 1
    assert eng.get_object("b", "k")[0] == b"y" * BLOCK
    assert eng.get_object("b", "k")[0] == b"y" * BLOCK
    assert HOTCACHE.snapshot()["memEntries"] == 1
    HOTCACHE.invalidate("b", "k", propagate=False, source="peer")
    assert HOTCACHE.snapshot()["memEntries"] == 0
    assert METRICS2.get("minio_tpu_v2_cache_invalidations_total",
                        {"source": "peer"}) >= 1


def test_background_lane_neither_fills_nor_counts(tmp_path, hot):
    from minio_tpu_torch.qos.scheduler import background_lane
    eng = _engine(tmp_path)
    _enable()
    eng.make_bucket("b")
    body = b"bg" * BLOCK
    eng.put_object("b", "k", body)
    with background_lane():
        assert eng.get_object("b", "k")[0] == body
        assert eng.get_object("b", "k")[0] == body
    snap = HOTCACHE.snapshot()
    assert snap["counters"]["fill"] == 0
    assert snap["memEntries"] == 0
    assert eng.get_object("b", "k")[0] == body
    assert HOTCACHE.snapshot()["counters"]["fill"] == 1


def test_min_hits_admission_floor(tmp_path, hot):
    eng = _engine(tmp_path)
    _enable(min_hits=3)
    unc = _MDelta("minio_tpu_v2_cache_fills_total", {"result": "uncached"})
    eng.make_bucket("b")
    body = b"m" * BLOCK
    eng.put_object("b", "k", body)
    for _ in range(2):
        assert eng.get_object("b", "k")[0] == body
    assert HOTCACHE.snapshot()["memEntries"] == 0
    assert unc.value() == 2
    assert eng.get_object("b", "k")[0] == body
    assert HOTCACHE.snapshot()["memEntries"] == 1


def test_scan_cannot_flush_the_hot_set(tmp_path, hot):
    calls: list = []
    eng = _engine(tmp_path, calls)
    _enable(mem_bytes=int(BLOCK * 2.5))
    eng.make_bucket("b")
    hot_body = b"h" * BLOCK
    eng.put_object("b", "hot", hot_body)
    for _ in range(6):
        assert eng.get_object("b", "hot")[0] == hot_body
    for i in range(20):
        eng.put_object("b", f"scan-{i}", b"s" * BLOCK)
        eng.get_object("b", f"scan-{i}")
    before = len(calls)
    assert eng.get_object("b", "hot")[0] == hot_body
    assert len(calls) == before, "the scan flushed the hot entry"


def test_disk_tier_demotion_range_pread_and_revalidation(tmp_path, hot):
    calls: list = []
    eng = _engine(tmp_path, calls)
    cdir = tmp_path / "cachedir"
    dhit = _MDelta("minio_tpu_v2_cache_hits_total", {"tier": "disk"})
    _enable(mem_bytes=int(BLOCK * 1.5), dirs=[str(cdir)])
    eng.make_bucket("b")
    b1, b2 = b"1" * BLOCK, b"2" * BLOCK
    eng.put_object("b", "k1", b1)
    eng.put_object("b", "k2", b2)
    assert eng.get_object("b", "k1")[0] == b1
    assert eng.get_object("b", "k2")[0] == b2
    snap = HOTCACHE.snapshot()
    assert snap["diskEntries"] == 1 and snap["memEntries"] == 1
    files = list((cdir / "mtpu-cache").rglob("*"))
    assert any(f.is_file() and not f.name.endswith(".meta") for f in files)
    reads_before = calls.count("read_file")
    meta_before = calls.count("read_version")
    data, _ = eng.get_object("b", "k1", offset=17, length=4096)
    assert data == b1[17:17 + 4096]
    assert calls.count("read_file") == reads_before
    assert calls.count("read_version") > meta_before
    assert dhit.value() == 1


def test_eviction_under_concurrent_reader_pins_entry(tmp_path, hot):
    eng = _engine(tmp_path)
    cdir = tmp_path / "cachedir"
    big = BLOCK * 8
    _enable(mem_bytes=BLOCK, dirs=[str(cdir)], max_object_bytes=big * 2)
    eng.make_bucket("b")
    body = bytes(range(256)) * (big // 256)
    eng.put_object("b", "big", body)
    eng.get_object("b", "big")
    _wait(lambda: HOTCACHE.snapshot()["diskEntries"] == 1,
          msg="disk demotion")
    path = next(f for f in (cdir / "mtpu-cache").rglob("*")
                if f.is_file() and not f.name.endswith(".meta"))
    info, stream = eng.get_object_stream("b", "big")
    first = next(stream)
    assert body.startswith(first)
    HOTCACHE.invalidate("b", "big", propagate=False)
    assert path.exists(), "pinned entry must not be unlinked"
    assert first + b"".join(stream) == body
    _wait(lambda: not path.exists(), msg="deferred unlink")
    assert HOTCACHE.snapshot()["diskEntries"] == 0


def test_unhealthy_dir_gets_no_placement(tmp_path, hot):
    from minio_tpu_torch.obs import drivemon as dm
    eng = _engine(tmp_path)
    cdir = tmp_path / "d0" / "cache"
    _enable(mem_bytes=BLOCK, dirs=[str(cdir)], max_object_bytes=4 << 20)
    eng.make_bucket("b")
    body = b"q" * (BLOCK * 2)
    eng.put_object("b", "k", body)
    ep = eng.endpoints[0]
    assert str(tmp_path / "d0") in ep
    dm.DRIVEMON.quarantine(ep, "test")
    try:
        HOTCACHE._dir_eps.clear()
        assert eng.get_object("b", "k")[0] == body
        assert HOTCACHE.snapshot()["diskEntries"] == 0
    finally:
        dm.DRIVEMON.reset()


@pytest.mark.parametrize("size", [1, BLOCK - 1, BLOCK * 3 + 5])
def test_cached_bytes_match_reference_engine(tmp_path, hot, size):
    """A hot GET (memory tier) of an object the reference wrote serves
    its bytes, full and ranged."""
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    eng = _engine(tmp_path)
    ref = RefEngine([RefXL(d.root) for d in eng.disks], 4, 2,
                    block_size=BLOCK)
    _ENGINES.append(ref)
    ref.make_bucket("b")
    ref.put_object("b", "k", payload)
    _enable()
    assert eng.get_object("b", "k")[0] == payload
    assert eng.get_object("b", "k")[0] == payload
    assert HOTCACHE.snapshot()["counters"]["hit_mem"] >= 1
    off = size // 3
    assert eng.get_object("b", "k", offset=off, length=size - off)[0] == \
        payload[off:]
