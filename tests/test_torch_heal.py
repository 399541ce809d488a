"""The port's heal path (minio_tpu_torch/erasure/heal.py, mrfjournal.py,
regen/repair.py) and boot recovery (storage/recovery.py) held to the JAX
package's, and the engine slice as a whole.

Both packages run here on the CPU, as in tests/test_torch_engine.py: the
port's engines under ``"auto"`` with ``device="cpu"`` where a case
re-hashes many frames, pinned to the CPU lane (K1 and K2 as their plain
versions) where it stays small. Degraded reads and heals run on two
trees that hold the same payload under the same name and take the same
damage; the port's healed part files and xl.meta must be the
reference's. The MRF worker is held back where a case compares heal
results, so that the heal front, not the worker, does the heal. Every
engine is shut down after its test and no test leaves a thread
running."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import uuid as uuidlib

import pytest

from minio_tpu_torch.erasure.engine import ErasureObjects
from minio_tpu_torch.erasure.mrfjournal import (MRF_LOG_PATH, MRFJournal,
                                                parse_journal)
from minio_tpu_torch.erasure.pools import ErasureServerPools
from minio_tpu_torch.erasure.regen.codec import RegenErasure
from minio_tpu_torch.erasure.regen.repair import REPAIR_BYTES
from minio_tpu_torch.erasure.sets import ErasureSets
from minio_tpu_torch.obs.metrics2 import METRICS2
from minio_tpu_torch.storage import errors as serr
from minio_tpu_torch.storage.format import (FormatErasure,
                                            init_or_load_formats,
                                            load_format, save_format)
from minio_tpu_torch.storage.recovery import sweep_engine, sweep_layer
from minio_tpu_torch.storage.xl import INTENT_FILE, XLStorage
from tests.test_torch_engine import (_ENGINES,  # noqa: F401
                                     _cpu_dispatch, make_engine,
                                     meta_view, part_files, rand,
                                     ref_engine, shutdown_engine)

REGEN = "pm-mbr-rbt"


def _no_worker(eng):
    """Pin the MRF worker off so queued entries stay queued (add()'s
    lazy start becomes a no-op; drain() still heals synchronously)."""
    eng.mrf.start = lambda: None


def _shard_file(disk_root: str, bucket: str, obj: str) -> str:
    obj_dir = os.path.join(disk_root, bucket, obj)
    for entry in os.listdir(obj_dir):
        p = os.path.join(obj_dir, entry)
        if os.path.isdir(p):
            return os.path.join(p, "part.1")
    raise FileNotFoundError(obj_dir)


def _root(d) -> str:
    return d.inner.root if hasattr(d, "inner") else d.root


def _disk_files_snapshot(e, bucket, obj):
    out = {}
    for i, d in enumerate(e.disks):
        try:
            out[i] = open(_shard_file(_root(d), bucket, obj), "rb").read()
        except (FileNotFoundError, NotADirectoryError):
            out[i] = None
    return out


def _rot(root: str, bucket: str, obj: str, at: int) -> None:
    p = _shard_file(root, bucket, obj)
    raw = bytearray(open(p, "rb").read())
    raw[at] ^= 0x55
    open(p, "wb").write(bytes(raw))


def _heal_view(r) -> tuple:
    return (sorted(r.healed_disks), r.corrupt_disks, r.missing_disks,
            r.before_ok, r.after_ok, r.dangling)


# ---------------------------------------------------------------------------
# Degraded reads and heal across packages


# (erasure shards, 0-based, whose drives lose the object; the shard whose
# drive gets a byte of frame 2 rotted, always one the GET reads)
DAMAGE = {
    "one-lost": ((1,), None),
    "two-lost": ((0, 3), None),
    "rotted": ((), 2),
    "lost-and-rotted": ((0,), 4),
}


@pytest.mark.parametrize("k,m", [(4, 2), (12, 4)])
@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_degraded_get_and_heal_match_reference(tmp_path, k, m, damage):
    """The same payload on two trees, the same drives lost and the same
    frame rotted: both GETs give the payload, and the port's heal gives
    the reference's HealResult and healed tree (the PUT's own files)."""
    lost, rot = DAMAGE[damage]
    payload = rand(5 * 4096 + 17, seed=k)
    p = make_engine(tmp_path / "port", n=k + m, k=k, m=m, block_size=4096)
    r = ref_engine(tmp_path / "ref", n=k + m, k=k, m=m, block_size=4096)
    for e in (p, r):
        _no_worker(e)
        e.make_bucket("b")
        e.put_object("b", "obj", payload)
    clean = part_files(p, "b", "obj")
    assert clean == part_files(r, "b", "obj")
    for e in (p, r):
        disk_of = {d.read_version("b", "obj").erasure.index - 1: d
                   for d in e.disks}
        for j in lost:
            shutil.rmtree(os.path.join(disk_of[j].root, "b", "obj"))
        if rot is not None:
            _rot(disk_of[rot].root, "b", "obj",
                 2 * (32 + -(-4096 // k)) + 40)
        assert e.get_object("b", "obj")[0] == payload
    assert p.mrf.depth() == r.mrf.depth() == (1 if rot is not None else 0)
    results = [e.healer.heal_object("b", "obj") for e in (p, r)]
    assert _heal_view(results[0]) == _heal_view(results[1])
    assert results[0].healthy
    assert part_files(p, "b", "obj") == part_files(r, "b", "obj") == clean
    assert meta_view(p, "b", "obj") == meta_view(r, "b", "obj")
    for e in (p, r):
        e.mrf.drain()
        assert e.mrf.depth() == 0


def test_degraded_get_and_heal_pinned_cpu_match_reference(tmp_path):
    """The same, with the port's engine pinned to the CPU lane: K1's and
    K2's plain versions rebuild and re-frame the lost and the rotted shard
    (the drives' deep scan, held in tests/test_torch_storage.py, hashes
    on the host here)."""
    payload = rand(4096 + 5, seed=9)
    p = make_engine(tmp_path / "port", n=6, k=4, m=2, block_size=4096,
                    backend="cpu", drives="auto")
    r = ref_engine(tmp_path / "ref", n=6, k=4, m=2, block_size=4096)
    for e in (p, r):
        _no_worker(e)
        e.make_bucket("b")
        e.put_object("b", "obj", payload)
    clean = part_files(r, "b", "obj")
    for e in (p, r):
        shutil.rmtree(os.path.join(e.disks[0].root, "b", "obj"))
        _rot(e.disks[3].root, "b", "obj", 40)
        assert e.get_object("b", "obj")[0] == payload
    results = [e.healer.heal_object("b", "obj") for e in (p, r)]
    assert _heal_view(results[0]) == _heal_view(results[1])
    assert sorted(results[0].healed_disks) == [0, 3]
    assert part_files(p, "b", "obj") == clean


@pytest.mark.parametrize("k,m", [(4, 2), (12, 4)])
def test_mrf_path_matches_reference(tmp_path, k, m):
    """heal_object_or_queue on a lost drive and the MRF drain of what a
    rotted frame's GET queued leave the reference's tree."""
    payload = rand(3 * 4096 + 1, seed=m)
    p = make_engine(tmp_path / "port", n=k + m, k=k, m=m, block_size=4096)
    r = ref_engine(tmp_path / "ref", n=k + m, k=k, m=m, block_size=4096)
    views = []
    for e in (p, r):
        _no_worker(e)
        e.make_bucket("b")
        e.put_object("b", "a", payload)
        e.put_object("b", "z", payload[::-1])
        shutil.rmtree(os.path.join(e.disks[1].root, "b", "a"))
        res = e.healer.heal_object_or_queue("b", "a")
        _rot(e.disks[2].root, "b", "z", 50)
        assert e.get_object("b", "z")[0] == payload[::-1]
        assert e.mrf.depth() == 1 and ("b", "z") in e.mrf._queued
        e.mrf.drain()
        views.append((_heal_view(res), e.mrf.depth(),
                      e.mrf.journal.backlog()))
    assert views[0] == views[1] == (([1], [], [1], k + m - 1, k + m,
                                     False), 0, 0)
    for name in ("a", "z"):
        assert part_files(p, "b", name) == part_files(r, "b", name)


@pytest.mark.parametrize("k,m", [(2, 2), (6, 2)])
def test_new_disk_monitor_tick_matches_reference(tmp_path, k, m):
    """NewDiskMonitor.tick on a wiped drive sweeps it back to the
    reference's tree."""
    trees = []
    for pkg, e in (("port", make_engine(tmp_path / "port", n=k + m, k=k,
                                        m=m, block_size=4096)),
                   ("ref", ref_engine(tmp_path / "ref", n=k + m, k=k, m=m,
                                      block_size=4096))):
        e.make_bucket("b")
        for i in range(3):
            e.put_object("b", f"o{i}", rand(5000 + i, seed=i))
        wiped = e.disks[1].root
        shutil.rmtree(wiped)
        os.makedirs(wiped)
        assert e.new_disk_monitor.tick() == [1], pkg
        trees.append({f"o{i}": (part_files(e, "b", f"o{i}"),
                                meta_view(e, "b", f"o{i}"))
                      for i in range(3)})
    assert trees[0] == trees[1]


# ---------------------------------------------------------------------------
# tests/test_heal.py's cases on the port


@pytest.fixture
def engine(tmp_path):
    e = make_engine(tmp_path, n=6, block_size=8192)
    e.make_bucket("b")
    return e


def test_heal_noop_on_healthy_object(engine):
    engine.put_object("b", "fine", rand(30000))
    r = engine.healer.heal_object("b", "fine")
    assert r.before_ok == 6
    assert r.healed_disks == [] and not r.dangling


def test_heal_after_shard_deletion(engine):
    payload = rand(50000)
    engine.put_object("b", "obj", payload)
    before = _disk_files_snapshot(engine, "b", "obj")
    for i in (1, 4):
        shutil.rmtree(os.path.join(engine.disks[i].root, "b", "obj"))
    r = engine.healer.heal_object("b", "obj")
    assert sorted(r.healed_disks) == [1, 4]
    assert _disk_files_snapshot(engine, "b", "obj") == before
    got, _ = engine.get_object("b", "obj")
    assert got == payload


def test_heal_after_bitrot_corruption(engine):
    engine.put_object("b", "rotten", rand(30000))
    before = _disk_files_snapshot(engine, "b", "rotten")
    _rot(engine.disks[2].root, "b", "rotten", 100)
    r = engine.healer.heal_object("b", "rotten")
    assert r.corrupt_disks == [2]
    assert r.healed_disks == [2]
    assert _disk_files_snapshot(engine, "b", "rotten") == before


def test_heal_dangling_object(engine):
    engine.put_object("b", "gone", rand(10000))
    for i in range(4):
        shutil.rmtree(os.path.join(engine.disks[i].root, "b", "gone"))
    r = engine.healer.heal_object("b", "gone")
    assert r.dangling
    assert r.healed_disks == []


def test_heal_dry_run_changes_nothing(engine):
    engine.put_object("b", "dry", rand(10000))
    root = engine.disks[0].root
    shutil.rmtree(os.path.join(root, "b", "dry"))
    r = engine.healer.heal_object("b", "dry", dry_run=True)
    assert r.missing_disks == [0]
    assert not os.path.exists(os.path.join(root, "b", "dry"))


def test_heal_bucket(engine):
    shutil.rmtree(os.path.join(engine.disks[3].root, "b"))
    assert engine.healer.heal_bucket("b") == [3]
    assert os.path.isdir(os.path.join(engine.disks[3].root, "b"))


def test_heal_fresh_disk_full_sweep(tmp_path):
    e = make_engine(tmp_path, n=4, block_size=4096)
    e.make_bucket("b")
    payloads = {f"o{i}": rand(6000 + i * 1000, i) for i in range(5)}
    for name, p in payloads.items():
        e.put_object("b", name, p)
    wiped = e.disks[1].root
    shutil.rmtree(wiped)
    os.makedirs(wiped)
    e.healer.heal_bucket("b")
    e.healer.heal_disk(1)
    for name, p in payloads.items():
        got, _ = e.get_object("b", name)
        assert got == p
        assert os.path.exists(os.path.join(wiped, "b", name, "xl.meta"))


def test_new_disk_monitor_auto_sweeps(tmp_path):
    e = make_engine(tmp_path, n=4, block_size=4096)
    e.make_bucket("b")
    payloads = {f"o{i}": rand(5000 + i, i) for i in range(3)}
    for name, p in payloads.items():
        e.put_object("b", name, p)
    mon = e.new_disk_monitor
    assert mon.tick() == []
    wiped = e.disks[2].root
    shutil.rmtree(wiped)
    os.makedirs(wiped)
    assert mon.tick() == [2]
    assert mon.sweeps == 1
    for name in payloads:
        assert os.path.exists(os.path.join(wiped, "b", name, "xl.meta"))
    assert mon.tick() == []
    shutil.rmtree(wiped)
    os.makedirs(wiped)
    assert mon.tick() == [2]
    assert mon.sweeps == 2


def test_deleted_bucket_not_resurrected_by_stale_disk(tmp_path):
    e = make_engine(tmp_path, n=4, naughty=True, block_size=4096)
    e.make_bucket("keep")
    e.make_bucket("gone")
    e.put_object("keep", "o", rand(3000))
    e.disks[3].offline = True
    e.delete_bucket("gone")
    e.disks[3].offline = False
    assert [b["name"] for b in e.list_buckets()] == ["keep"]
    assert e.new_disk_monitor.tick() == []
    for i in range(3):
        assert not os.path.isdir(os.path.join(e.disks[i].inner.root,
                                              "gone"))


def test_mrf_heals_partial_write(tmp_path):
    e = make_engine(tmp_path, n=4, naughty=True, block_size=4096)
    e.make_bucket("b")
    e.disks[3].fail_methods = {"create_file", "append_file"}
    payload = rand(20000)
    e.put_object("b", "partial", payload)
    e.disks[3].fail_methods = set()
    root = e.disks[3].inner.root
    deadline = time.time() + 10
    while time.time() < deadline:
        e.mrf.drain()
        if os.path.exists(os.path.join(root, "b", "partial", "xl.meta")):
            break
        time.sleep(0.05)
    assert os.path.exists(os.path.join(root, "b", "partial", "xl.meta"))
    r = e.healer.heal_object("b", "partial")
    assert r.before_ok == 4
    assert r.healthy


def test_get_queues_heal_on_bitrot(engine):
    payload = rand(30000)
    engine.put_object("b", "selfheal", payload)
    target = next(d for d in engine.disks if json.loads(open(os.path.join(
        d.root, "b", "selfheal", "xl.meta")).read())[
            "versions"][0]["erasure"]["index"] == 1)
    _rot(target.root, "b", "selfheal", 50)
    got, _ = engine.get_object("b", "selfheal")
    assert got == payload
    deadline = time.time() + 10
    while time.time() < deadline:
        engine.mrf.drain()
        r = engine.healer.heal_object("b", "selfheal")
        if r.corrupt_disks == [] and r.healthy:
            break
        time.sleep(0.05)
    assert r.corrupt_disks == [] and r.healthy


def test_heal_zero_byte_and_metadata_only(engine):
    engine.put_object("b", "empty", b"")
    shutil.rmtree(os.path.join(engine.disks[5].root, "b", "empty"))
    r = engine.healer.heal_object("b", "empty")
    assert r.healed_disks == [5]
    got, _ = engine.get_object("b", "empty")
    assert got == b""


def test_monitor_restamps_format_on_hot_swap(tmp_path):
    e = make_engine(tmp_path, n=4, block_size=4096)
    e.make_bucket("fb")
    e.put_object("fb", "obj", rand(9000))
    dep = str(uuidlib.uuid4())
    row = [str(uuidlib.uuid4()) for _ in e.disks]
    for d, u in zip(e.disks, row):
        save_format(d, FormatErasure(dep, u, [row]))
    target = e.disks[1]
    shutil.rmtree(target.root)
    os.makedirs(target.root)
    assert load_format(target) is None
    assert e.new_disk_monitor.tick() == [1]
    fmt = load_format(target)
    assert fmt is not None
    assert (fmt.deployment_id, fmt.this, fmt.sets) == (dep, row[1], [row])
    assert os.path.exists(os.path.join(target.root, "fb", "obj", "xl.meta"))


def test_quarantine_probe_round_trip(tmp_path):
    """The probation probe of a quarantined drive stages a framed blob,
    reads it back and verifies it on the engine's bitrot device."""
    from minio_tpu_torch.obs.drivemon import DRIVEMON
    e = make_engine(tmp_path, n=4, block_size=4096, backend="cpu")
    assert e.quarantine_prober._probe(e.disks[0])
    ep = e.endpoints[1]
    DRIVEMON.quarantine(ep, "test")
    try:
        assert DRIVEMON.is_quarantined(ep)
        assert e.quarantine_prober.tick() == []
        assert e.quarantine_prober.probes == 1
    finally:
        DRIVEMON.reinstate(ep)


def test_engine_registers_the_reference_crash_points():
    """The engine's PUT, heal and multipart commits register the
    reference's crash points, beside xl.py's."""
    import minio_tpu.erasure.heal  # noqa: F401
    import minio_tpu.erasure.multipart  # noqa: F401
    import minio_tpu_torch.erasure.heal  # noqa: F401
    import minio_tpu_torch.erasure.multipart  # noqa: F401
    from minio_tpu.faultinject import FAULTS as REF_FAULTS
    from minio_tpu_torch.faultinject import FAULTS
    assert sorted(FAULTS.crash_points()) == \
        sorted(REF_FAULTS.crash_points())
    assert len([n for n in FAULTS.crash_points()
                if n.startswith("engine.")]) == 7


# ---------------------------------------------------------------------------
# tests/test_recovery.py's cases on the port (MRF journal, boot sweep)


def _journal_files(eng):
    return [p for d in eng.disks
            for p in [os.path.join(d.root, ".minio.sys", MRF_LOG_PATH)]
            if os.path.exists(p)]


def test_mrf_add_dedups_queued_objects(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    for _ in range(50):
        eng.mrf.add("b", "hot")
    assert eng.mrf.depth() == 1
    eng.mrf.add("b", "other")
    assert eng.mrf.depth() == 2
    for p in _journal_files(eng):
        assert parse_journal(open(p, "rb").read()) == [
            ("b", "hot"), ("b", "other")]
    assert len(_journal_files(eng)) == 4


def test_mrf_heal_completion_retires_dedup_and_journal(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    eng.make_bucket("b")
    eng.mrf.add("b", "gone")
    assert eng.mrf.depth() == 1
    eng.mrf.drain()
    assert eng.mrf.depth() == 0
    assert eng.mrf.journal.backlog() == 0
    assert _journal_files(eng) == []
    eng.mrf.add("b", "gone")
    assert eng.mrf.depth() == 1


def test_journal_survives_restart_and_replays(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    eng.mrf.add("b", "k1")
    eng.mrf.add("b", "k2")
    eng.mrf.add("b2", "k3")
    assert eng.mrf.journal.backlog() == 3
    eng.shutdown()
    eng2 = make_engine(tmp_path, n=4)
    _no_worker(eng2)
    assert eng2.mrf.depth() == 0
    assert eng2.mrf.replay_journal() == 3
    assert eng2.mrf.depth() == 3
    assert METRICS2.get("minio_tpu_v2_mrf_queue_depth") == 3
    eng2.mrf.add("b", "k1")
    assert eng2.mrf.depth() == 3
    for p in _journal_files(eng2):
        assert len(parse_journal(open(p, "rb").read())) == 3


def test_journal_matches_reference_bytes(tmp_path):
    """The port's mrf.log is the reference's, line for line."""
    from minio_tpu.erasure.mrfjournal import MRFJournal as RefJournal
    from minio_tpu.storage.xl import XLStorage as RefXL
    a = MRFJournal([XLStorage(str(tmp_path / "p"), device="cpu")])
    b = RefJournal([RefXL(str(tmp_path / "r"))])
    for j in (a, b):
        for i in range(5):
            j.record("bkt", f"dir/obj-{i}")
        j.record("bkt", "dir/obj-1")
        j.complete("bkt", "dir/obj-3")
    raw = [open(os.path.join(tmp_path / s, ".minio.sys", MRF_LOG_PATH),
                "rb").read() for s in ("p", "r")]
    assert raw[0] == raw[1]
    assert a.replay() == b.replay()


def test_journal_size_cap_counts_drops(tmp_path):
    disks = [XLStorage(str(tmp_path / "d0"), device="cpu")]
    j = MRFJournal(disks)
    j.MAX_BYTES = 256
    accepted = dropped = 0
    for i in range(40):
        if j.record("bucket", f"object-{i:04d}"):
            accepted += 1
        else:
            dropped += 1
    assert dropped > 0 and accepted > 0
    assert j.drops == dropped
    p = os.path.join(disks[0].root, ".minio.sys", MRF_LOG_PATH)
    assert os.path.getsize(p) <= 256 + 64
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-7])
    assert len(MRFJournal(disks).replay()) >= accepted - 1


def test_journal_parse_tolerates_garbage():
    good = b'{"b":"x","o":"y"}\n'
    assert parse_journal(
        good + b"not json\n" + b'{"nope":1}\n' + good + b'{"b":"x"'
    ) == [("x", "y")]


def _stage_orphan(disk_root, name, intent=None, age_s=120.0):
    d = os.path.join(disk_root, ".minio.sys", "tmp", name)
    os.makedirs(os.path.join(d, "datadir-x"), exist_ok=True)
    with open(os.path.join(d, "datadir-x", "part.1"), "wb") as f:
        f.write(b"orphaned shard bytes")
    if intent is not None:
        with open(os.path.join(d, INTENT_FILE), "wb") as f:
            f.write(json.dumps(intent).encode())
    old = time.time() - age_s
    for sub in (os.path.join(d, "datadir-x"), d):
        os.utime(sub, (old, old))
    return d


def test_sweep_gcs_orphans_but_spares_young_stages(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    old = _stage_orphan(eng.disks[0].root, "dead-stage")
    young = _stage_orphan(eng.disks[0].root, "live-stage", age_s=0.0)
    report = sweep_engine(eng, age_s=60.0)
    assert not os.path.exists(old)
    assert os.path.exists(young)
    assert report["found"] == 1 and report["cleaned"] == 1
    assert report["requeued"] == []
    assert eng.recovery_report is report


def test_sweep_requeues_partially_committed_object(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    eng.make_bucket("b")
    body = rand(40_000)
    eng.put_object("b", "torn", body)
    victim = eng.disks[2].root
    shutil.rmtree(os.path.join(victim, "b", "torn"))
    _stage_orphan(victim, "crashed-commit",
                  intent={"bucket": "b", "object": "torn"})
    report = sweep_engine(eng, age_s=60.0)
    assert report["requeued"] == ["b/torn"]
    assert eng.mrf.depth() == 1
    eng.mrf.drain()
    assert os.path.exists(os.path.join(victim, "b", "torn", "xl.meta"))
    assert eng.get_object("b", "torn")[0] == body


def test_sweep_requeues_torn_overwrite_via_datadir_hint(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    eng.make_bucket("b")
    eng.put_object("b", "ow", b"v1" * 5000)
    new = rand(30_000)
    eng.put_object("b", "ow", new)
    victim = eng.disks[1].root
    meta_path = os.path.join(victim, "b", "ow", "xl.meta")
    doc = json.loads(open(meta_path).read())
    new_dd = doc["versions"][0]["dataDir"]
    shutil.rmtree(os.path.join(victim, "b", "ow", new_dd))
    doc["versions"][0]["dataDir"] = "0f0e0d0c-0000-4000-8000-00000000000f"
    open(meta_path, "w").write(json.dumps(doc))
    _stage_orphan(victim, "torn-overwrite",
                  intent={"bucket": "b", "object": "ow", "dataDir": new_dd})
    report = sweep_engine(eng, age_s=60.0)
    assert report["requeued"] == ["b/ow"], report
    eng.mrf.drain()
    assert eng.get_object("b", "ow")[0] == new


def test_sweep_skips_requeue_for_uncommitted_and_fully_present(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    eng.make_bucket("b")
    eng.put_object("b", "whole", b"x" * 1000)
    _stage_orphan(eng.disks[0].root, "gc-leftover",
                  intent={"bucket": "b", "object": "whole"})
    _stage_orphan(eng.disks[1].root, "uncommitted",
                  intent={"bucket": "b", "object": "never-was"})
    report = sweep_engine(eng, age_s=60.0)
    assert report["found"] == 2 and report["cleaned"] == 2
    assert report["requeued"] == []
    assert eng.mrf.depth() == 0


def test_sweep_gcs_torn_multipart_stage_files(tmp_path):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    base = os.path.join(eng.disks[0].root, ".minio.sys", "mpu", "hash",
                        "upload-1")
    os.makedirs(base, exist_ok=True)
    stage = os.path.join(base, "part.1.deadbeef.stage")
    keep = os.path.join(base, "part.1")
    for p in (stage, keep):
        with open(p, "wb") as f:
            f.write(b"bytes")
    old = time.time() - 120
    os.utime(stage, (old, old))
    os.utime(keep, (old, old))
    report = sweep_engine(eng, age_s=60.0)
    assert not os.path.exists(stage)
    assert os.path.exists(keep)
    assert report["stageFiles"] == 1


def test_put_stages_carry_intent_breadcrumbs(tmp_path, monkeypatch):
    eng = make_engine(tmp_path, n=4)
    _no_worker(eng)
    eng.make_bucket("b")
    seen = {}
    orig = XLStorage.rename_data

    def spy(self, src_volume, src_path, fi, dst_volume, dst_path):
        ip = os.path.join(self.root, ".minio.sys", src_path, INTENT_FILE)
        if os.path.exists(ip):
            seen[self.root] = json.loads(open(ip, "rb").read())
        return orig(self, src_volume, src_path, fi, dst_volume, dst_path)

    monkeypatch.setattr(XLStorage, "rename_data", spy)
    eng.put_object("b", "k", rand(30_000))
    assert len(seen) == 4
    dd = next(iter(seen.values()))["dataDir"]
    assert all(d == {"bucket": "b", "object": "k", "versionId": "",
                     "dataDir": dd} for d in seen.values())
    for d in eng.disks:
        assert os.listdir(os.path.join(d.root, ".minio.sys", "tmp")) == []


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_sweep_report_matches_reference(tmp_path, pkg):
    """The same residue on both packages' drives: the same report."""
    from minio_tpu.storage.recovery import sweep_engine as ref_sweep
    e = (make_engine if pkg == "port" else ref_engine)(tmp_path, n=4)
    _no_worker(e)
    e.make_bucket("b")
    e.put_object("b", "torn", rand(9000))
    shutil.rmtree(os.path.join(e.disks[3].root, "b", "torn"))
    _stage_orphan(e.disks[3].root, "s1",
                  intent={"bucket": "b", "object": "torn"})
    _stage_orphan(e.disks[0].root, "s2")
    report = (sweep_engine if pkg == "port" else ref_sweep)(e, age_s=60.0)
    assert {k: report[k] for k in ("localDisks", "found", "cleaned",
                                   "stageFiles", "requeued",
                                   "journalReplayed")} == {
        "localDisks": 4, "found": 2, "cleaned": 2, "stageFiles": 0,
        "requeued": ["b/torn"], "journalReplayed": 0}


# ---------------------------------------------------------------------------
# REGEN repair (tests/test_rs_regen.py's engine cases on the port)


class CountingDisk:
    """Counts bytes served through the storage READ API per method."""

    def __init__(self, inner):
        self.inner = inner
        self.bytes_by_method = {"read_all": 0, "read_file": 0,
                                "repair_project": 0}
        self.part_read_alls = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def read_all(self, volume, path):
        data = self.inner.read_all(volume, path)
        self.bytes_by_method["read_all"] += len(data)
        if "/part." in path:
            self.part_read_alls += 1
        return data

    def read_file(self, volume, path, offset, length):
        data = self.inner.read_file(volume, path, offset, length)
        self.bytes_by_method["read_file"] += len(data)
        return data

    def repair_project(self, volume, path, ranges):
        data = self.inner.repair_project(volume, path, ranges)
        self.bytes_by_method["repair_project"] += len(data)
        return data


def make_regen_engine(tmp_path, n=6, block_size=8192, counting=False,
                      backend="auto"):
    disks = []
    for i in range(n):
        d = XLStorage(str(tmp_path / f"disk{i}"),
                      device="auto" if backend == "auto" else "cpu")
        disks.append(CountingDisk(d) if counting else d)
    e = ErasureObjects(disks, n - 2, 2, block_size=block_size,
                       backend=backend, device="cpu")
    _ENGINES.append(e)
    e.make_bucket("b")
    return e


def test_engine_put_get_regen_and_mixed_bucket(tmp_path):
    eng = make_regen_engine(tmp_path)
    payload = rand(50_000)
    eng.put_object("b", "rs-obj", payload)
    eng.put_object("b", "regen-obj", payload, algorithm=REGEN)
    assert eng.disks[0].read_version("b", "regen-obj").erasure.algorithm \
        == REGEN
    assert eng.disks[0].read_version("b", "rs-obj").erasure.algorithm \
        != REGEN
    for key in ("rs-obj", "regen-obj"):
        assert eng.get_object("b", key)[0] == payload
    got, _ = eng.get_object("b", "regen-obj", offset=6000, length=20_000)
    assert got == payload[6000:26_000]


def test_engine_degraded_get_regen(tmp_path):
    eng = make_regen_engine(tmp_path)
    payload = rand(40_000)
    eng.put_object("b", "obj", payload, algorithm=REGEN)
    for i in (1, 3):
        shutil.rmtree(os.path.join(eng.disks[i].root, "b", "obj"))
    assert eng.get_object("b", "obj")[0] == payload


def test_regen_heal_never_reads_k_full_shards(tmp_path):
    eng = make_regen_engine(tmp_path, counting=True)
    payload = rand(100_000)
    eng.put_object("b", "obj", payload, algorithm=REGEN)
    shutil.rmtree(os.path.join(eng.disks[2].inner.root, "b", "obj"))
    for d in eng.disks:
        d.bytes_by_method = {k: 0 for k in d.bytes_by_method}
        d.part_read_alls = 0
    REPAIR_BYTES.reset()
    res = eng.healer.heal_object("b", "obj")
    assert res.healed_disks and res.healthy
    one_shard = RegenErasure(4, 2, block_size=8192,
                             backend="cpu").shard_file_size(len(payload))
    proj = sum(d.bytes_by_method["repair_project"] for d in eng.disks)
    ranged = sum(d.bytes_by_method["read_file"] for d in eng.disks)
    assert proj > 0
    assert proj + ranged <= one_shard
    assert proj + ranged < len(payload) // 2
    assert sum(d.part_read_alls for d in eng.disks) == 0
    snap = REPAIR_BYTES.snapshot()
    assert snap["regen"]["disk"] == snap["regen"]["net"] == proj
    assert eng.get_object("b", "obj")[0] == payload


def test_regen_heal_falls_back_when_helper_down(tmp_path):
    eng = make_regen_engine(tmp_path, counting=True)
    payload = rand(60_000)
    eng.put_object("b", "obj", payload, algorithm=REGEN)
    before = _disk_files_snapshot(eng, "b", "obj")
    shutil.rmtree(os.path.join(eng.disks[2].inner.root, "b", "obj"))
    calls = {"n": 0}
    victim = eng.disks[4]
    orig = victim.inner.repair_project

    def flaky(volume, path, ranges):
        calls["n"] += 1
        raise serr.FaultyDisk("injected helper outage")

    victim.inner.repair_project = flaky
    try:
        res = eng.healer.heal_object("b", "obj")
    finally:
        victim.inner.repair_project = orig
    assert calls["n"] >= 1
    assert res.healed_disks and res.healthy
    assert _disk_files_snapshot(eng, "b", "obj")[2] == before[2]
    assert eng.get_object("b", "obj")[0] == payload


def test_regen_repair_failed_when_below_k(tmp_path):
    eng = make_regen_engine(tmp_path)
    eng.put_object("b", "obj", rand(30_000), algorithm=REGEN)
    for i in (0, 2, 4):
        shutil.rmtree(os.path.join(eng.disks[i].root, "b", "obj"))
    res = eng.healer.heal_object("b", "obj")
    assert res.dangling or not res.healed_disks
    assert issubclass(serr.RegenRepairFailed, serr.StorageError)


@pytest.mark.parametrize("lost", [(2,), (1, 4)])
def test_regen_heal_matches_reference(tmp_path, lost):
    """A REGEN object healed by both packages, the port pinned to the CPU
    lane: repair by transfer for one lost node, the any-k decode and
    re-encode for two; the same healed files."""
    payload = rand(4096 + 100, seed=len(lost))
    p = make_engine(tmp_path / "port", n=6, k=4, m=2, block_size=4096,
                    backend="cpu", drives="auto")
    r = ref_engine(tmp_path / "ref", n=6, k=4, m=2, block_size=4096)
    for e in (p, r):
        _no_worker(e)
        e.make_bucket("b")
        e.put_object("b", "rg", payload, algorithm=REGEN)
    clean = part_files(r, "b", "rg")
    results = []
    for e in (p, r):
        for i in lost:
            shutil.rmtree(os.path.join(e.disks[i].root, "b", "rg"))
        assert e.get_object("b", "rg")[0] == payload
        results.append(_heal_view(e.healer.heal_object("b", "rg")))
    assert results[0] == results[1]
    assert part_files(p, "b", "rg") == clean


# ---------------------------------------------------------------------------
# Threads, and the slice as a whole


def test_engine_cycle_leaves_no_thread(tmp_path):
    """PUT -> degraded GET (its rotted frame starts the MRF worker) -> MRF
    heal -> shutdown: threading.enumerate() holds no thread it did not
    hold before. The parallel_map pool of parallel/quorum.py (threads
    ``quorum_*``) is process-wide, not the engine's: it is warmed up
    before the first snapshot and may grow, but it is no engine thread."""
    warm = make_engine(tmp_path / "warm", n=6, k=4, m=2, block_size=4096)
    warm.make_bucket("b")
    warm.put_object("b", "o", rand(20_000))
    warm.get_object("b", "o")
    shutdown_engine(warm)
    _ENGINES.remove(warm)
    before = set(threading.enumerate())

    e = make_engine(tmp_path / "e", n=6, k=4, m=2, block_size=4096)
    e.make_bucket("b")
    payload = rand(20_000, seed=3)
    e.put_object("b", "o", payload)
    e.list_objects("b")
    shutil.rmtree(os.path.join(e.disks[0].root, "b", "o"))
    _rot(e.disks[1].root, "b", "o", 100)
    assert e.get_object("b", "o")[0] == payload
    deadline = time.time() + 20
    while time.time() < deadline and (e.mrf.depth() or e.mrf._queued):
        time.sleep(0.02)
    assert e.mrf._thread is not None
    assert e.healer.heal_object("b", "o").healthy
    shutdown_engine(e)
    _ENGINES.remove(e)
    assert [t.name for t in set(threading.enumerate()) - before
            if not t.name.startswith("quorum_")] == []


def test_engine_slice_matches_reference(tmp_path):
    """chip_smoke.py phase 18's steps at a CPU size, on both packages:
    16 drives formatted as one set, ErasureSets at 12+4 with 64 KiB
    blocks in one pool; PUT of a 1 MiB + 3 B object, GET, ranged GET and
    listing; shards 0 and 5 lost and frame 3 of shard 7 rotted, degraded
    GET; heal through the pools' heal front and the MRF drain; a
    three-part multipart upload; the recovery sweep; shutdown. The part
    files, GET bytes and heal outcomes are the reference's."""
    from minio_tpu.erasure.pools import ErasureServerPools as RefPools
    from minio_tpu.erasure.sets import ErasureSets as RefSets
    from minio_tpu.storage.format import init_or_load_formats as ref_init
    from minio_tpu.storage.recovery import sweep_layer as ref_sweep_layer
    from minio_tpu.storage.xl import XLStorage as RefXL

    bs, size = 64 * 1024, (1 << 20) + 3
    payload = rand(size, seed=1)
    parts = (160 * 1024, 128 * 1024, 5 * 1024 + 3)
    runs = {}
    for pkg in ("port", "ref"):
        root = tmp_path / pkg
        if pkg == "port":
            drives = [XLStorage(str(root / f"d{i:02d}"), device="auto")
                      for i in range(16)]
            fmt, ordered, fresh = init_or_load_formats(drives)
            sets = ErasureSets(ordered, [16], fmt.deployment_id, 12, 4,
                               block_size=bs, backend="auto", device="cpu")
            pools = ErasureServerPools([sets])
            sweep = sweep_layer
        else:
            drives = [RefXL(str(root / f"d{i:02d}")) for i in range(16)]
            fmt, ordered, fresh = ref_init(drives)
            sets = RefSets(ordered, [16], fmt.deployment_id, 12, 4,
                           block_size=bs)
            pools = RefPools([sets])
            sweep = ref_sweep_layer
        eng = sets.sets[0]
        _ENGINES.append(eng)
        assert fresh == [] and len(eng.disks) == 16
        out = runs[pkg] = {}
        pools.make_bucket("bucket")
        out["etag"] = pools.put_object("bucket", "obj", payload).etag
        out["put_files"] = part_files(eng, "bucket", "obj")
        out["get"] = pools.get_object("bucket", "obj")[0] == payload
        off = 7 * bs - 3 * bs // 2
        out["ranged"] = pools.get_object(
            "bucket", "obj", offset=off, length=3 * bs)[0]
        out["names"] = [o.name for o in pools.list_objects("bucket")]
        _no_worker(eng)
        index_of = {d.read_version("bucket", "obj").erasure.index: i
                    for i, d in enumerate(eng.disks)}
        S = -(-bs // 12)
        for j in (0, 5):
            shutil.rmtree(os.path.join(eng.disks[index_of[j + 1]].root,
                                       "bucket", "obj"))
        _rot(eng.disks[index_of[8]].root, "bucket", "obj",
             3 * (32 + S) + 32 + 1000)
        out["degraded"] = pools.get_object("bucket", "obj")[0] == payload
        out["queued"] = (eng.mrf.depth(), sorted(eng.mrf._queued))
        out["heal"] = _heal_view(pools.healer.heal_object("bucket", "obj"))
        eng.mrf.drain()
        out["healed_files"] = part_files(eng, "bucket", "obj")
        out["healed_meta"] = meta_view(eng, "bucket", "obj")
        mp = pools.multipart
        for s in sets.sets:
            s.multipart.min_part_size = 1024
        uid = mp.new_multipart_upload("bucket", "mpu")
        at, sent = 0, []
        for n, psize in enumerate(parts, 1):
            sent.append((n, mp.put_object_part(
                "bucket", "mpu", uid, n, payload[at:at + psize])["etag"]))
            at += psize
        out["mpu_etag"] = mp.complete_multipart_upload(
            "bucket", "mpu", uid, sent).etag
        out["mpu"] = pools.get_object("bucket", "mpu")[0] == payload[:at]
        out["mpu_files"] = part_files(eng, "bucket", "mpu")
        for i in (2, 9):
            _stage_orphan(eng.disks[i].root, f"orphan-{i}", age_s=3600)
        reports = sweep(pools, age_s=60)
        out["sweep"] = [(r["found"], r["cleaned"]) for r in reports]
        pools.shutdown()
    port, ref = runs["port"], runs["ref"]
    assert port["etag"] == hashlib.md5(payload).hexdigest()
    assert port["get"] and port["degraded"] and port["mpu"]
    assert port["ranged"] == payload[7 * bs - 3 * bs // 2:
                                     7 * bs + 3 * bs // 2]
    assert port["names"] == ["obj"]
    assert port["queued"] == (1, [("bucket", "obj")])
    assert port["heal"][0] == sorted(port["heal"][0]) and \
        len(port["heal"][0]) == 3 and port["heal"][4] == 16
    assert port["healed_files"] == port["put_files"]
    assert port["mpu_etag"].endswith("-3")
    assert port["sweep"] == [(2, 2)]
    for key in port:
        assert port[key] == ref[key], key


def test_sets_and_pools_sweep_every_set(tmp_path):
    """sweep_layer visits every set of every pool."""
    disks = [XLStorage(str(tmp_path / f"d{i}"), device="auto")
             for i in range(8)]
    fmt, ordered, _ = init_or_load_formats(disks, set_size=4)
    sets = ErasureSets(ordered, [4, 4], fmt.deployment_id,
                       block_size=4096, backend="auto", device="cpu")
    _ENGINES.extend(sets.sets)
    for s in sets.sets:
        _no_worker(s)
        _stage_orphan(s.disks[0].root, "x")
    reports = sweep_layer(ErasureServerPools([sets]), age_s=60)
    assert [(r["found"], r["cleaned"]) for r in reports] == [(1, 1), (1, 1)]
    assert all(s.recovery_report is r for s, r in zip(sets.sets, reports))
