"""The modules the port's boot reaches, side by side with the reference.

The bodies of the JAX package's ``tests/test_ellipses.py``,
``test_lifecycle.py`` (the rules and the data crawler), ``test_federation.py``
(bucket DNS over a fake etcd), ``test_admin_client.py``,
``test_event_brokers.py`` (the broker wire protocols against fake sockets)
and ``test_update.py`` run against the port through ``test_torch_remap``,
with their own fixtures rebound. Then both packages take the same seeded
inputs: ellipses, lifecycle decisions, the etcd records bucket DNS writes,
the bytes each broker sink delivers, the admin client's answers, the update
check, and the crawler's ``crawl_once`` (the usage tree, lifecycle expiry
and the sampled heal, whose rebuilt part files must be the reference's).

Also here: the port's heal logs under ``minio_tpu_torch.heal`` and nothing
under ``minio_tpu.*``; every module of the JAX package has its counterpart
in the port; a loaded fault plan leaves a pinned engine's PUT writing
(its frames are uint8 arrays, which the torn-write filter now takes); and
a pinned engine's K1 and K2 dispatches reach the kernel metrics that the
cluster metrics endpoint merges, one for one with its dispatch counters.
"""

from __future__ import annotations

import io
import json
import logging
import os
import tarfile
import time
from pathlib import Path

import numpy as np
import pytest

import test_admin_client as _admin
import test_ellipses as _ellipses
import test_event_brokers as _brokers
import test_federation as _federation
import test_lifecycle as _lifecycle
import test_update as _update
from test_torch_remap import PortRemap

REMAP = PortRemap()
REMAP.collect(_ellipses, "ellipses", globals())
REMAP.collect(_lifecycle, "lifecycle", globals(), fixtures=True)
REMAP.collect(_federation, "federation", globals(), fixtures=True)
REMAP.collect(_admin, "admin", globals(), fixtures=True)
REMAP.collect(_brokers, "brokers", globals())
# The reference's update archive carries minio_tpu/, which the port's
# update refuses by design; its port counterpart is below.
REMAP.collect(_update, "update", globals(),
              skip={"test_check_and_apply": "archive of the other package"})

ROOT = Path(__file__).resolve().parent.parent
DAY = 24 * 3600.0


@pytest.fixture(scope="module", autouse=True)
def _no_probe_ladder():
    with pytest.MonkeyPatch.context() as mp, REMAP.life:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        yield


@pytest.fixture(autouse=True)
def _module_life(request):
    REMAP.life.enter(request.node.name)


@pytest.mark.parametrize("tag", ["lifecycle", "federation", "admin"])
def test_no_thread_outlives_its_module(tag):
    assert REMAP.life.census.get(tag, []) == []


def test_every_reference_case_was_collected():
    for mod, tag, left in ((_ellipses, "ellipses", 0),
                           (_lifecycle, "lifecycle", 0),
                           (_federation, "federation", 0),
                           (_admin, "admin", 0), (_brokers, "brokers", 0),
                           (_update, "update", 1)):
        want = [n for n in vars(mod) if n.startswith("test_")]
        got = [n for n in globals() if n.startswith(f"test_{tag}__")]
        assert len(got) == len(want) - left and want


# ---------------------------------------------------------------------------
# Pure functions, seeded, both packages

ELLIPSES = ["/d{1...4}", "/d{01...12}", "/n{1...2}/d{1...3}",
            "http://h{1...3}:9000/data/d{1...2}", "/plain", "/d{3...1}",
            "/d{a...c}", "/d{1...}", "{1...2}{1...2}"]


@pytest.mark.parametrize("arg", ELLIPSES)
def test_ellipses_match_reference(arg):
    from minio_tpu.utils import ellipses as ref
    from minio_tpu_torch.utils import ellipses as port

    def run(mod):
        try:
            return mod.has_ellipses(arg), mod.expand(arg), \
                mod.expand_all([arg, "/x"])
        except Exception as e:  # noqa: BLE001 - the error is the answer
            return type(e).__name__, str(e)
    assert run(port) == run(ref)


RULES = """<LifecycleConfiguration>
<Rule><ID>days</ID><Status>Enabled</Status><Prefix>logs/</Prefix>
  <Expiration><Days>30</Days></Expiration></Rule>
<Rule><ID>tagged</ID><Status>Enabled</Status><Filter><And><Prefix>p/</Prefix>
  <Tag><Key>tier</Key><Value>tmp</Value></Tag></And></Filter>
  <Expiration><Date>2020-01-01</Date></Expiration></Rule>
<Rule><ID>nc</ID><Status>Enabled</Status><Prefix>v/</Prefix>
  <NoncurrentVersionExpiration><NoncurrentDays>3</NoncurrentDays>
  </NoncurrentVersionExpiration>
  <Expiration><ExpiredObjectDeleteMarker>true</ExpiredObjectDeleteMarker>
  </Expiration></Rule>
<Rule><ID>tier</ID><Status>Enabled</Status><Prefix>cold/</Prefix>
  <Transition><Days>10</Days><StorageClass>GLACIER</StorageClass>
  </Transition></Rule>
<Rule><ID>off</ID><Status>Disabled</Status><Prefix></Prefix>
  <Expiration><Days>1</Days></Expiration></Rule>
</LifecycleConfiguration>"""


def test_lifecycle_decisions_match_reference():
    """Every rule kind over 400 seeded versions (names, ages, tags,
    latest/noncurrent, delete markers): the same (action, tier)."""
    from minio_tpu.bucket import lifecycle as ref
    from minio_tpu_torch.bucket import lifecycle as port
    rng = np.random.default_rng(9)
    lcs = (port.Lifecycle.parse(RULES), ref.Lifecycle.parse(RULES))
    now = 1.9e9
    prefixes = ["logs/", "p/", "v/", "cold/", "other/", ""]
    seen = set()
    for _ in range(400):
        name = prefixes[rng.integers(len(prefixes))] + f"o{rng.integers(9)}"
        kw = dict(is_latest=bool(rng.integers(2)),
                  delete_marker=bool(rng.integers(4) == 0),
                  tags={"tier": "tmp"} if rng.integers(2) else {},
                  sole_version=bool(rng.integers(2)), now=now)
        mod_time = now - float(rng.integers(0, 60)) * DAY
        got = [lc.compute_with_tier(name, mod_time, **kw) for lc in lcs]
        assert got[0] == got[1], (name, mod_time, kw)
        seen.add(got[0][0])
    assert seen == {port.NONE, port.DELETE, port.DELETE_VERSION,
                    port.DELETE_MARKER, port.TRANSITION}
    assert port.parse_tags("a=1&b=2") == ref.parse_tags("a=1&b=2")


def test_bucket_dns_writes_the_reference_records():
    """Both packages' bucket DNS over one fake etcd each: the same
    records after the same registrations, and the same lookups."""
    from minio_tpu.bucket import federation as ref
    from minio_tpu_torch.bucket import federation as port
    fakes = [_federation.FakeEtcd(), _federation.FakeEtcd()]
    try:
        out = []
        for mod, fe in zip((port, ref), fakes):
            dns = mod.BucketDNS(mod.EtcdClient(f"127.0.0.1:{fe.port}"))
            dns.register("alpha", "10.0.0.1", 9000)
            dns.register("beta", "10.0.0.2", 9001)
            dns.register("alpha", "10.0.0.3", 9002)
            dns.unregister("beta")
            records = {k: {f: v for f, v in json.loads(raw).items()
                           if f != "creation"}
                       for k, raw in fe.kv.items()}
            out.append((records, dns.list_buckets(),
                        dns.lookup("alpha"), dns.lookup("beta")))
        assert out[0] == out[1]
        env = {"MINIO_ETCD_ENDPOINTS": f"http://127.0.0.1:{fakes[0].port}",
               "MINIO_DOMAIN": "example.com"}
        assert (port.BucketDNS.from_env(env) is None) == \
            (ref.BucketDNS.from_env(env) is None)
        assert port.BucketDNS.from_env({}) is None
    finally:
        for fe in fakes:
            fe.stop()


BROKERS = {"NATS": _brokers._nats_handler, "NSQ": _brokers._nsq_handler,
           "MQTT": _brokers._mqtt_handler, "REDIS": _brokers._redis_handler,
           "ELASTICSEARCH": _brokers._es_handler,
           "KAFKA": _brokers._kafka_handler,
           "AMQP": _brokers._amqp_handler,
           "POSTGRES": _brokers._pg_handler,
           "MYSQL": _brokers._mysql_handler}


@pytest.mark.parametrize("sink", sorted(BROKERS))
def test_broker_sink_delivers_the_reference_bytes(sink):
    """The sink ``targets_from_env`` builds for ``MINIO_NOTIFY_<SINK>_*``
    delivers what the reference's delivers, by the fake broker's decode."""
    from minio_tpu.event import brokers as ref
    from minio_tpu_torch.event import brokers as port
    got = []
    for mod in (port, ref):
        fb = _brokers.FakeBroker(BROKERS[sink])
        try:
            env = {f"MINIO_NOTIFY_{sink}_ENABLE": "on",
                   f"MINIO_NOTIFY_{sink}_ADDRESS": f"127.0.0.1:{fb.port}",
                   "MINIO_NOTIFY_ELASTICSEARCH_URL":
                       f"http://127.0.0.1:{fb.port}"}
            targets = mod.targets_from_env(env)
            assert [t.env_name for t in targets] == [sink]
            targets[0].send(_brokers.EVENT)
            _brokers._wait_delivered(fb.got)
            got.append(list(fb.got))
        finally:
            fb.stop()
    assert got[0] == got[1] and got[0]


def test_update_check_matches_reference():
    from minio_tpu.utils import update as ref
    from minio_tpu_torch.utils import update as port
    fr = _update.FakeRelease("9.9.9")
    try:
        assert port.check_update(fr.endpoint) == \
            ref.check_update(fr.endpoint)
    finally:
        fr.stop()


def _release(tree: str, version: str) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, body in ((f"{tree}/__init__.py",
                            f'__version__ = "{version}"\n'.encode()),
                           (f"{tree}/newmod.py", b"VALUE = 42\n")):
            info = tarfile.TarInfo(name)
            info.size = len(body)
            tf.addfile(info, io.BytesIO(body))
    return buf.getvalue()


def test_update_swaps_only_the_port_tree(tmp_path):
    """The port's update installs an archive's ``minio_tpu_torch/`` over the
    installed ``minio_tpu_torch/`` (old tree kept as ``.bak``); an archive
    that carries only ``minio_tpu/`` is refused, and a ``minio_tpu/`` tree
    beside the package is never touched."""
    from minio_tpu_torch.utils import update as up
    pkg = tmp_path / "minio_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text('__version__ = "0.1.0"\n')
    (pkg / "oldmod.py").write_text("OLD = 1\n")
    ref = tmp_path / "minio_tpu"
    ref.mkdir()
    (ref / "__init__.py").write_text("REF = 1\n")
    wrong = tmp_path / "wrong.tar.gz"
    wrong.write_bytes(_release("minio_tpu", "9.9.9"))
    with pytest.raises(up.UpdateError, match="minio_tpu_torch/"):
        up.apply_update(str(wrong), package_dir=str(pkg))
    assert (pkg / "oldmod.py").exists()
    good = tmp_path / "good.tar.gz"
    good.write_bytes(_release("minio_tpu_torch", "9.9.9"))
    assert up.apply_update(str(good), package_dir=str(pkg)) == str(pkg)
    assert "9.9.9" in (pkg / "__init__.py").read_text()
    assert (pkg / "newmod.py").exists() and not (pkg / "oldmod.py").exists()
    assert (tmp_path / "minio_tpu_torch.bak" / "oldmod.py").exists()
    assert (ref / "__init__.py").read_text() == "REF = 1\n"
    assert sorted(os.listdir(ref)) == ["__init__.py"]


def test_admin_client_answers_match_reference(tmp_path):
    """Both packages' ``AdminClient`` against one port server: the same
    users, policies, config and quota answers."""
    from minio_tpu.s3.admin_client import AdminClient as RefAdmin
    from minio_tpu_torch.erasure.engine import ErasureObjects
    from minio_tpu_torch.iam.iam import ConfigStore, IAMSys
    from minio_tpu_torch.s3.admin_client import AdminClient
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.xl import XLStorage
    ak, sk = "sbsadmin", "sbsadmin-secret"
    disks = [XLStorage(str(tmp_path / f"d{i}"), device="cpu")
             for i in range(4)]
    srv = S3Server(ErasureObjects(disks, block_size=8192, backend="cpu",
                                  device="cpu"), ak, sk,
                   iam=IAMSys(ConfigStore(disks), ak, sk))
    port = srv.start()
    try:
        assert S3Client("127.0.0.1", port, ak, sk).make_bucket(
            "quotab").status == 200
        out = []
        for cls in (AdminClient, RefAdmin):
            adm = cls("127.0.0.1", port, ak, sk)
            adm.add_user("sbsuser", "user-secret-1234",
                         policies=["readonly"])
            adm.set_bucket_quota("quotab", 1 << 20)
            out.append((adm.list_users(), adm.get_bucket_quota("quotab"),
                        sorted(adm.get_config()), adm.list_policies()))
            adm.remove_user("sbsuser")
        assert out[0] == out[1]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# The data crawler's crawl_once, both packages

def _engines(root, n=4, block=4096):
    """A port engine pinned to the CPU and a reference engine, each on
    its own n drives under ``root``."""
    from minio_tpu.erasure.engine import ErasureObjects as RefEngine
    from minio_tpu.storage.xl import XLStorage as RefXL
    from minio_tpu_torch.erasure.engine import ErasureObjects
    from minio_tpu_torch.storage.xl import XLStorage
    port = ErasureObjects([XLStorage(str(root / "port" / f"d{i}"),
                                     device="cpu") for i in range(n)],
                          block_size=block, backend="cpu", device="cpu")
    ref = RefEngine([RefXL(str(root / "ref" / f"d{i}")) for i in range(n)],
                    block_size=block)
    for e in (port, ref):
        e.mrf.start = lambda: None   # heals run in the foreground only
    return port, ref


def _crawler(pkg, layer, **kw):
    if pkg == "port":
        from minio_tpu_torch.bucket.metadata import BucketMetadataSys
        from minio_tpu_torch.scanner.crawler import DataCrawler
    else:
        from minio_tpu.bucket.metadata import BucketMetadataSys
        from minio_tpu.scanner.crawler import DataCrawler
    bm = BucketMetadataSys.for_layer(layer)
    return bm, DataCrawler(layer, bm, **kw)


def _strip_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items()
                if "time" not in k.lower() and k not in ("lastUpdate",)}
    if isinstance(doc, list):
        return [_strip_times(v) for v in doc]
    return doc


def test_crawl_once_usage_and_expiry_match_reference(tmp_path):
    """The same buckets, objects, versions and lifecycle rules in both
    packages' engines: ``crawl_once`` eight days on builds the same usage
    tree and expires the same versions."""
    engines = _engines(tmp_path)
    usage, left = [], []
    try:
        for pkg, layer in zip(("port", "ref"), engines):
            bm, cr = _crawler(pkg, layer, heal_sample=10**9)
            layer.make_bucket("u1")
            layer.make_bucket("u2")
            rng = np.random.default_rng(4)
            for i in range(12):
                size = int(rng.integers(0, 3 * 4096))
                layer.put_object("u1" if i % 3 else "u2",
                                 f"{'old/' if i % 2 else 'keep/'}{i}",
                                 rng.integers(0, 256, size,
                                              dtype=np.uint8).tobytes())
            bm.update("u1", lifecycle_xml="""<LifecycleConfiguration><Rule>
                <Status>Enabled</Status><Prefix>old/</Prefix>
                <Expiration><Days>7</Days></Expiration>
                </Rule></LifecycleConfiguration>""")
            usage.append(_strip_times(cr.crawl_once(
                now=time.time() + 8 * DAY)))
            left.append({b: sorted(o.name for o in layer.list_objects(b))
                         for b in ("u1", "u2")})
        assert usage[0] == usage[1]
        assert left[0] == left[1]
        assert not [n for n in left[0]["u1"] if n.startswith("old/")]
        assert [n for n in left[0]["u2"] if n.startswith("old/")]
    finally:
        for e in engines:
            e.shutdown()


def test_crawl_once_sampled_heal_rebuilds_the_reference_shard(tmp_path):
    """One drive loses an object's part file in both packages' engines;
    a crawl that samples every object heals it, and the rebuilt part file
    (K1 and K2's plain versions in the port) is the reference's."""
    engines = _engines(tmp_path)
    payload = np.random.default_rng(5).integers(
        0, 256, 2 * 4096 + 100, dtype=np.uint8).tobytes()
    healed, files = [], []
    try:
        for pkg, layer in zip(("port", "ref"), engines):
            _, cr = _crawler(pkg, layer, heal_sample=1)
            layer.make_bucket("hb")
            layer.put_object("hb", "obj", payload)
            odir = Path(layer.disks[1].root) / "hb" / "obj"
            (part,) = odir.glob("*/part.1")
            want = part.read_bytes()
            part.unlink()
            cr.crawl_once()
            healed.append(cr.healed)
            files.append((want, part.read_bytes()))
            assert layer.get_object("hb", "obj")[0] == payload
        assert healed[0] == healed[1] == [("hb", "obj")]
        assert files[0][1] == files[0][0] == files[1][1] == files[1][0]
    finally:
        for e in engines:
            e.shutdown()


# ---------------------------------------------------------------------------
# Heal's logger, module parity, the torn-write filter


def test_port_heal_logs_under_its_own_package(tmp_path, caplog, monkeypatch):
    """A failed object in a port heal sweep logs under
    ``minio_tpu_torch.heal``; nothing of the port logs under
    ``minio_tpu.*``. The reference logs the same event under
    ``minio_tpu.heal``."""
    engines = _engines(tmp_path)
    try:
        for layer in engines:
            layer.make_bucket("lb")
            layer.put_object("lb", "o", b"x" * 100)

            def boom(*a, **kw):
                raise RuntimeError("injected")
            monkeypatch.setattr(layer.healer, "heal_object_or_queue", boom)
        with caplog.at_level(logging.WARNING):
            engines[0].healer.heal_disk(0)
        names = {r.name for r in caplog.records}
        assert "minio_tpu_torch.heal" in names
        assert not [n for n in names if n == "minio_tpu"
                    or n.startswith("minio_tpu.")]
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            engines[1].healer.heal_disk(0)
        assert "minio_tpu.heal" in {r.name for r in caplog.records}
    finally:
        for e in engines:
            e.shutdown()


# The reference's kernel modules and their counterparts in the port.
KERNEL_MODULES = {"ops/rs_pallas.py": "ops/rs_gpu.py",
                  "ops/rs_tpu.py": "ops/rs_gpu.py",
                  "ops/hh256_tpu.py": "ops/hh256_gpu.py"}


def test_every_reference_module_has_its_port():
    ref_root, port_root = ROOT / "minio_tpu", ROOT / "minio_tpu_torch"
    rel = sorted(str(p.relative_to(ref_root))
                 for p in ref_root.rglob("*.py"))
    missing = [r for r in rel if not (port_root / KERNEL_MODULES.get(
        r, r)).is_file()]
    assert not missing
    assert len(rel) > 130
    assert "__main__.py" in rel and "gateway/__init__.py" in rel


def test_torn_write_filter_takes_a_pinned_engines_frames(tmp_path):
    """With a fault plan loaded (a rule for another drive), a PUT through
    a pinned CPU engine writes: its frames reach ``append_file`` as uint8
    arrays. The part files are the reference's, and a torn-write rule on
    one drive halves that drive's frames as it halves bytes."""
    from minio_tpu.faultinject import FAULTS as REF_FAULTS
    from minio_tpu_torch.faultinject import FAULTS
    port, ref = _engines(tmp_path)
    payload = np.random.default_rng(6).integers(
        0, 256, 3 * 4096 + 7, dtype=np.uint8).tobytes()
    plan = {"rules": [{"kind": "latency", "target": "/nowhere",
                       "latency_ms": 1}]}
    try:
        for faults, layer in ((FAULTS, port), (REF_FAULTS, ref)):
            layer.make_bucket("fb")
            faults.load_plan(plan)
            try:
                layer.put_object("fb", "o", payload)
            finally:
                faults.clear()
        parts = []
        for layer in (port, ref):
            parts.append([next((Path(d.root) / "fb" / "o").glob(
                "*/part.1")).read_bytes() for d in layer.disks])
        assert parts[0] == parts[1]
        frame = np.frombuffer(parts[0][0], np.uint8)
        FAULTS.load_plan({"rules": [{"kind": "torn_write",
                                     "target": "/d"}]})
        try:
            cut = FAULTS.filter_write("/d", "append_file", frame)
        finally:
            FAULTS.clear()
        assert cut == parts[0][0][:len(frame) // 2]
    finally:
        port.shutdown()
        ref.shutdown()
        FAULTS.clear()
        REF_FAULTS.clear()


def _invocations(kernel_prefix: str) -> float:
    from minio_tpu_torch.obs.metrics2 import METRICS2
    fam = METRICS2.snapshot().get("minio_tpu_v2_kernel_invocations_total")
    return sum(row["value"] for row in (fam or {}).get("series", [])
               if row["labels"].get("kernel", "").startswith(kernel_prefix))


def test_pinned_dispatches_reach_the_kernel_metrics(tmp_path):
    """Every K1 and K2 dispatch of a pinned engine (PUT, GET, degraded
    GET, heal) is one ``minio_tpu_v2_kernel_invocations_total`` count, so
    a node's metrics scrape agrees with its admin dispatch counters."""
    from minio_tpu_torch.ops import batching
    port, ref = _engines(tmp_path)
    ref.shutdown()
    try:
        before = (batching.STATS.snapshot()["tpu_dispatches"],
                  batching.HH_STATS.snapshot()["tpu_dispatches"],
                  _invocations("rs_"), _invocations("hh256"))
        port.make_bucket("mb")
        body = np.random.default_rng(7).integers(
            0, 256, 3 * 4096 + 9, dtype=np.uint8).tobytes()
        port.put_object("mb", "o", body)
        assert port.get_object("mb", "o")[0] == body
        (part,) = (Path(port.disks[0].root) / "mb" / "o").glob("*/part.1")
        part.unlink()
        assert port.get_object("mb", "o")[0] == body
        assert port.healer.heal_object("mb", "o").healed_disks == [0]
        after = (batching.STATS.snapshot()["tpu_dispatches"],
                 batching.HH_STATS.snapshot()["tpu_dispatches"],
                 _invocations("rs_"), _invocations("hh256"))
        k1, k2, m1, m2 = (a - b for a, b in zip(after, before))
        assert k1 > 0 and k2 > 0
        assert (m1, m2) == (k1, k2)
    finally:
        port.shutdown()


def test_build_object_layer_runs_on_the_device_it_is_given(tmp_path):
    """The CLI's layer builder passes its device to every drive and set
    (``backend="cpu"`` on the CPU) and to the FS backend; with its
    default, the card, and no card it raises instead of serving from the
    CPU."""
    from minio_tpu_torch.__main__ import build_object_layer
    layer = build_object_layer([str(tmp_path / "a" / "d{1...4}")],
                               block_size=8192, device="cpu")
    try:
        eng = layer.pools[0].sets[0]
        assert (eng.backend, eng.device.type) == ("cpu", "cpu")
        assert {d.device for d in eng.disks} == {"cpu"}
        assert build_object_layer([str(tmp_path / "fs")],
                                  device="cpu").device == "cpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_object_layer([str(tmp_path / "b" / "d{1...4}")])
    finally:
        layer.shutdown()


def test_admin_counts_card_launches_apart_from_dispatches(tmp_path):
    """A node's admin ``kernel-launches`` answers K1's and K2's launches
    on the card (the wrappers' own counts), apart from the dispatch
    counters of its admin ``info``: a node on the CPU moves its
    dispatches and launches nothing."""
    from minio_tpu_torch.erasure.engine import ErasureObjects
    from minio_tpu_torch.ops import hh256_gpu, rs_gpu
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.xl import XLStorage
    ak, sk = "infoadmin", "infoadmin-secret"
    disks = [XLStorage(str(tmp_path / f"d{i}"), device="cpu")
             for i in range(4)]
    srv = S3Server(ErasureObjects(disks, block_size=8192, backend="cpu",
                                  device="cpu"), ak, sk)
    port = srv.start()
    try:
        c = S3Client("127.0.0.1", port, ak, sk)

        def admin(route: str) -> dict:
            r = c.request("GET", f"/minio-tpu/admin/v1/{route}")
            assert r.status == 200
            return json.loads(r.body)

        def info() -> dict:
            return {**admin("info")["tpu"],
                    "launches": admin("kernel-launches")}

        before = info()
        assert before["launches"] == {
            "gf_apply": rs_gpu.gf_apply_cuda.launches,
            "hh256": hh256_gpu.hash_chunks_cuda.launches}
        assert c.make_bucket("launchb").status == 200
        body = np.random.default_rng(3).integers(
            0, 256, 2 * 8192 + 5, dtype=np.uint8).tobytes()
        assert c.put_object("launchb", "o", body).status == 200
        assert c.get_object("launchb", "o").body == body
        after = info()
        for key in ("rs", "bitrot"):
            assert (after[key]["tpu_dispatches"]
                    > before[key]["tpu_dispatches"])
        assert after["launches"] == before["launches"]
    finally:
        srv.stop()


@pytest.mark.parametrize("switch", ["on", "off"])
def test_layerless_server_reads_the_probe_switch_from_the_env(
        monkeypatch, switch):
    """A server booted without a layer (a cluster node's boot server)
    reads ``codec probe_on_boot`` through the config system's env lookup
    (``MINIO_CODEC_PROBE_ON_BOOT``), as a layered one does."""
    from minio_tpu_torch.config.kv import ConfigSys
    from minio_tpu_torch.ops.autotune import AUTOTUNE
    from minio_tpu_torch.s3.server import S3Server
    assert ConfigSys(None, env={}).get("codec", "probe_on_boot") == "on"
    monkeypatch.setenv("MINIO_CODEC_PROBE_ON_BOOT", switch)
    probed = []
    monkeypatch.setattr(AUTOTUNE, "ensure_probed",
                        lambda **kw: probed.append(kw))
    srv = S3Server(None, "probeadmin", "probeadmin-secret")
    srv.start()
    try:
        assert probed == ([{"background": True}] if switch == "on" else [])
    finally:
        srv.stop()
