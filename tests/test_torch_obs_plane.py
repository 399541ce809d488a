"""The port's observability and QoS planes that the S3 front door pulls
in (obs/usage, slowlog, loopmon, timeline, watchdog, incidents and the
hooks into them), held to the JAX package's.

- The two hooks in modules the port already had: kernprof feeds every
  dispatch to the timeline's worst-kernel exemplar, and faultinject's
  ``loop_block`` rule stalls a monitored event loop, which the loop
  monitor captures and blames on the injected frame, in both packages.
- ``obs`` and ``qos`` export what the reference's packages export.
- Fresh instances of each plane in both packages are fed the same
  seeded events with the clock injected, and return the same snapshots:
  usage windows and top-k sketches, slowlog captures and blame,
  timeline samples (from scripted raw counters) and their cluster
  merge, watchdog transitions over synthetic samples, incident bundles.
- The stdlib helpers of the slice (pubsub, bandwidth) behave alike."""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading
import time

import numpy as np
import pytest

import minio_tpu.obs as ref_obs_pkg
import minio_tpu.qos as ref_qos_pkg
import minio_tpu_torch.obs as obs_pkg
import minio_tpu_torch.qos as qos_pkg
from minio_tpu.faultinject import FAULTS as REF_FAULTS
from minio_tpu.obs import incidents as ref_incidents
from minio_tpu.obs import kernprof as ref_kernprof
from minio_tpu.obs import loopmon as ref_loopmon
from minio_tpu.obs import slowlog as ref_slowlog
from minio_tpu.obs import timeline as ref_timeline
from minio_tpu.obs import usage as ref_usage
from minio_tpu.obs import watchdog as ref_watchdog
from minio_tpu.utils import bandwidth as ref_bandwidth
from minio_tpu.utils import pubsub as ref_pubsub
from minio_tpu_torch.faultinject import FAULTS
from minio_tpu_torch.obs import incidents, kernprof, loopmon, slowlog
from minio_tpu_torch.obs import timeline, usage, watchdog
from minio_tpu_torch.utils import bandwidth, pubsub

SEEDS = range(6)
BOTH = ((kernprof, loopmon, timeline, FAULTS),
        (ref_kernprof, ref_loopmon, ref_timeline, REF_FAULTS))


# ---------------------------------------------------------------------------
# The hooks


def test_package_exports_match_reference():
    assert obs_pkg.__all__ == ref_obs_pkg.__all__
    for name in obs_pkg.__all__:
        assert type(getattr(obs_pkg, name)).__name__ == \
            type(getattr(ref_obs_pkg, name)).__name__
    for name in ("admission", "ctx", "deadline", "scheduler"):
        assert hasattr(qos_pkg, name) and hasattr(ref_qos_pkg, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_dispatch_feeds_the_timeline_exemplar(seed):
    """After the same dispatches, each package's timeline holds the same
    worst-kernel exemplar (the wall, the kernel and its lane)."""
    rng = np.random.default_rng(seed)
    walls = rng.random(int(rng.integers(1, 12)))
    kernels = rng.choice(["rs_encode", "hh256", "select_scan"], len(walls))
    got = []
    for kp, _, tl, _ in BOTH:
        tl.TIMELINE.reset()
        kp.KERNPROF.reset()
        for k, w in zip(kernels, walls):
            kp.KERNPROF.record_dispatch(str(k), kp.HOST, 4096, float(w))
        got.append(tl.TIMELINE._worst_kern)
        tl.TIMELINE.reset()
        kp.KERNPROF.reset()
    assert got[0] == got[1]
    assert got[0][0] == pytest.approx(float(walls.max()) * 1e3)
    assert got[0][2] == str(kernels[int(walls.argmax())])


@contextlib.contextmanager
def monitored_loop(lm, name):
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True,
                         name=f"obs-test-{name}")
    t.start()
    lm.LOOPMON.register(name, loop)
    try:
        yield loop
    finally:
        lm.LOOPMON.unregister(name)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=5)
        loop.close()


def test_loop_block_rule_stalls_the_loop_as_in_the_reference():
    """A ``loop_block`` rule of 300 ms on a named loop: the heartbeat
    schedules the real block, the watcher captures a stall of that loop
    blamed on ``_injected_loop_block``, in both packages; afterwards the
    port's loop monitor keeps no thread (``release``)."""
    captures = []
    for _, lm, _, faults in BOTH:
        prev = lm.LOOPMON.stall_ms
        lm.LOOPMON.configure(stall_ms=120)
        with lm.LOOPMON._mu:
            lm.LOOPMON._stall_ring.clear()
        faults.load_plan({"seed": 1, "rules": [
            {"kind": "loop_block", "target": "obs-fi", "latency_ms": 300,
             "count": 1}]})
        try:
            assert faults.loop_block("unrelated") == 0.0
            with monitored_loop(lm, "obs-fi"):
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and not [
                        e for e in lm.LOOPMON.recent_stalls()
                        if e["loop"] == "obs-fi"]:
                    time.sleep(0.02)
                entry = [e for e in lm.LOOPMON.recent_stalls()
                         if e["loop"] == "obs-fi"][-1]
        finally:
            faults.clear()
            lm.LOOPMON.configure(stall_ms=prev)
        captures.append(entry)
    for entry in captures:
        assert entry["topFrame"].startswith("_injected_loop_block")
        assert entry["overdueMs"] >= 120
    assert sorted(captures[0]) == sorted(captures[1])
    loopmon.LOOPMON.release()
    assert loopmon.LOOPMON._watcher is None
    assert not loopmon.LOOPMON.profiler.running


# ---------------------------------------------------------------------------
# Usage


def usage_events(seed: int, t0: float = 10_000.0):
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for _ in range(300):
        t += float(rng.exponential(0.5))
        out.append(dict(
            bucket=str(rng.choice(["photos", "logs", "", "b" + str(
                int(rng.integers(0, 80)))])),
            access_key=str(rng.choice(["AK1", "AK2", "", "AK3"])),
            qos_class=str(rng.choice(["read", "write", "list", "select"])),
            rx=int(rng.integers(0, 1 << 20)), tx=int(rng.integers(0, 1 << 20)),
            status=int(rng.choice([200, 200, 404, 503, 500])),
            shed=bool(rng.random() < 0.1),
            key=str(rng.choice(["a", "b/c", ""])),
            duration_ms=float(rng.random() * 100),
            trace_id=f"t{int(rng.integers(0, 1000))}", now=t))
    return out, t


@pytest.mark.parametrize("seed", SEEDS)
def test_usage_windows_match(seed):
    events, end = usage_events(seed)
    views = []
    for mod in (usage, ref_usage):
        ua = mod.UsageAccountant()
        ua.configure(top_k=5, cardinality_cap=16, fast_s=30.0, slow_s=120.0,
                     noisy_min_requests=5)
        for e in events:
            ua.record(**e)
        views.append({
            "acct": {k: ua.window_accounts(k, w, end)
                     for k in ("buckets", "tenants") for w in (30.0, 120.0)},
            "shares": ua.class_shares(30.0, end),
            "top": ua.class_top_shares(end),
            "folded": ua.folded_total})
    assert json.dumps(views[0], sort_keys=True) == \
        json.dumps(views[1], sort_keys=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_topk_sketches_match(seed):
    rng = np.random.default_rng(seed)
    keys = [f"k{int(i)}" for i in rng.zipf(1.5, 500) % 200]
    snaps = []
    for mod in (usage, ref_usage):
        parts = [mod.TopKSketch(8) for _ in range(3)]
        for i, k in enumerate(keys):
            parts[i % 3].offer(k, 1 + i % 3)
        snaps.append(([p.snapshot() for p in parts],
                      mod.merge_topk([p.snapshot() for p in parts], 5)))
    assert snaps[0] == snaps[1]


def test_claimed_access_key_matches():
    for hdr in ("AWS4-HMAC-SHA256 Credential=AKID/20250101/us-east-1/s3/"
                "aws4_request, SignedHeaders=host, Signature=abc",
                "AWS AKV2:sig", "", "Bearer x"):
        for q in (None, {"X-Amz-Credential": "PRE/20250101/us-east-1/s3"}):
            assert usage.claimed_access_key(hdr, q) == \
                ref_usage.claimed_access_key(hdr, q)


# ---------------------------------------------------------------------------
# Slowlog


def span_tree(rng, depth=0):
    names = ["s3.PutObject", "erasure.encode", "storage.write", "rpc.call",
             "kernel.rs_encode", "admission.wait", "lock.acquire", "misc"]
    node = {"name": str(rng.choice(names)),
            "durationMs": float(rng.random() * 50), "children": []}
    if depth < 3:
        for _ in range(rng.integers(0, 3)):
            node["children"].append(span_tree(rng, depth + 1))
    return node


@pytest.mark.parametrize("seed", SEEDS)
def test_slowlog_captures_match(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    reqs = [dict(api=str(rng.choice(["PutObject", "GetObject"])),
                 api_class=str(rng.choice(["read", "write", "list"])),
                 method="GET", path=f"/b/{i}",
                 status=int(rng.choice([200, 200, 500, 503])),
                 duration_ms=float(rng.random() * 400),
                 request_id=f"R{i}", trace=span_tree(rng)
                 if rng.random() < 0.7 else None,
                 qos={"waitMs": float(rng.random() * 20)}
                 if rng.random() < 0.3 else None,
                 exempt=bool(rng.random() < 0.1)) for i in range(60)]
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.0)
    views = []
    for mod in (slowlog, ref_slowlog):
        sl = mod.SlowLog()
        sl.configure(100.0, {"list": 50.0, "write": None})
        got = [sl.record(**r) for r in reqs]
        views.append((got, sl.entries(n=100), sl.entries(blame="disk"),
                      sl.total, sl.exempted, sl.thresholds()))
    assert views[0] == views[1]


# ---------------------------------------------------------------------------
# Timeline


def scripted(mod):
    class Scripted(mod.Timeline):
        def __init__(self, raws, **kw):
            super().__init__(**kw)
            self.raws = list(raws)

        def _read_raw(self):
            return self.raws.pop(0)
    return Scripted


def raws(seed: int, n: int = 12) -> list:
    rng = np.random.default_rng(seed)
    acc = {"rx": 0, "tx": 0, "qr": 0, "qw": 0, "kn": 0, "kd": 0, "sw": 0}
    out = []
    for i in range(n):
        for k in acc:
            acc[k] += int(rng.integers(0, 5000))
        if rng.random() < 0.1:  # a counter reset
            acc = {k: v // 7 for k, v in acc.items()}
        out.append({
            "qps": {"read": acc["qr"], "write": acc["qw"]},
            "shed": {"write": acc["sw"]},
            "inflight": {"read": int(rng.integers(0, 9))},
            "queueDepth": int(rng.integers(0, 4)),
            "rx": acc["rx"], "tx": acc["tx"],
            "kernelBytes": {"native": acc["kn"], "device": acc["kd"]},
            "hedgeFired": 0, "mrfDepth": int(rng.integers(0, 3)),
            "drives": {"suspect": 0, "faulty": int(rng.integers(0, 2)),
                       "quarantined": 0},
            "backendState": {"native": 0, "device": int(rng.integers(0, 3))},
        })
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_samples_and_merge_match(seed):
    rng = np.random.default_rng(seed + 100)
    feed = raws(seed)
    notes = [(float(rng.random() * 100), f"tr{i}", "read")
             for i in range(len(feed))]
    snaps = []
    for mod in (timeline, ref_timeline):
        t = scripted(mod)(feed, period_s=1.0, retention_s=60.0)
        for i in range(len(feed)):
            t.note_request(notes[i][2], notes[i][0], notes[i][1])
            t.note_kernel("rs_encode", "native", notes[i][0] / 3, "k")
            t.tick(now=1000.0 + i * 1.0 + (0.3 if i % 4 == 3 else 0.0))
        snap = t.snapshot()
        lag = scripted(mod)(raws(seed + 50), period_s=1.0)
        for i in range(len(feed)):
            lag.tick(now=999.6 + i)
        merged = mod.merge_timelines([snap, lag.snapshot()])
        snaps.append((snap, merged, mod.slice_samples(snap["samples"], 3,
                                                      1004.0)))
    assert json.dumps(snaps[0], sort_keys=True) == \
        json.dumps(snaps[1], sort_keys=True)


# ---------------------------------------------------------------------------
# Watchdog and incidents


def samples(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bad = rng.random() < 0.5 if i > n // 3 else False
        cls = str(rng.choice(["read", "write"]))
        out.append({"t": 100.0 + i, "qps": {cls: int(rng.integers(5, 50))},
                    "errors": {cls: int(rng.integers(0, 20)) if bad else 0},
                    "shed": {cls: int(rng.integers(0, 10)) if bad else 0},
                    "slow": {cls: int(rng.integers(0, 5))},
                    "mrfDepth": int(rng.integers(0, 300)) if bad else 0,
                    "mrfJournal": 0, "resets": int(rng.random() < 0.05),
                    "cacheHits": int(rng.integers(0, 100)),
                    "cacheMisses": int(rng.integers(0, 100)),
                    "drives": {"suspect": 0, "faulty": int(bad),
                               "quarantined": 0},
                    "backendState": {"native": 0}})
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_watchdog_transitions_match(seed, monkeypatch):
    """The same samples, ticked at the same times, give the same
    transitions. The drive rule names the degraded drives from the
    package's drive monitor, a process-wide singleton whose contents
    carry the process's history: both monitors report the same drive."""
    from minio_tpu.obs import drivemon as ref_drivemon
    from minio_tpu_torch.obs import drivemon
    census = {"drives": [{"endpoint": "/srv/d1", "state": "ok"},
                         {"endpoint": "/srv/d3", "state": "faulty",
                          "quarantined": False}]}
    feed = samples(seed)
    got = []
    for mod, dm in ((watchdog, drivemon), (ref_watchdog, ref_drivemon)):
        monkeypatch.setattr(dm.DRIVEMON, "snapshot", lambda: census)
        wd = mod.Watchdog()
        wd.configure(fast_s=5.0, slow_s=20.0, burn_threshold=0.1,
                     pending_ticks=2, resolve_ticks=2)
        trs = []
        for i in range(5, len(feed)):
            trs += wd.tick(now=100.0 + i + 0.5, samples=feed[:i + 1])
        got.append(([{k: v for k, v in t.items() if k != "alertId"}
                     for t in trs], wd.fired_total,
                    {r: wd.state_of(r) for r in sorted(wd._alerts)}))
    assert got[0] == got[1]
    assert got[0][0]  # the samples do breach: transitions to compare


@pytest.mark.parametrize("raw", [
    "", "[]", "not json", '[{"name": "x"}]',
    '[{"name": "hot", "metric": "minio_tpu_v2_loop_lag_ms", "op": ">",'
    ' "threshold": 5}]',
    '[{"name": "Bad Name!", "metric": "m", "op": ">", "threshold": 1}]',
    '[{"name": "r", "metric": "m", "op": "~", "threshold": 1}]',
])
def test_user_rule_validation_matches(raw):
    def run(mod):
        try:
            return mod.validate_user_rules(raw), None
        except mod.AlertRuleError as e:
            return None, str(e)
    assert run(watchdog) == run(ref_watchdog)


def test_incident_bundles_match_by_key(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.0)
    tr = {"alertId": "drive_degraded-1", "rule": "drive_degraded",
          "cause": "drive /d3 faulty", "value": 1.0}
    bundles = []
    for mod in (incidents, ref_incidents):
        rec = mod.IncidentRecorder()
        rec.providers["config"] = lambda: {"api": {"requests_max": "0"}}
        b = rec.capture(tr)
        bundles.append((sorted(b), {k: b[k] for k in
                                    ("id", "rule", "cause", "value",
                                     "capturedAt")},
                        [sorted(x) for x in rec.list()],
                        sorted(rec.get("drive_degraded-1"))))
    assert bundles[0] == bundles[1]


# ---------------------------------------------------------------------------
# Stdlib helpers


def test_pubsub_matches():
    got = []
    for mod in (pubsub, ref_pubsub):
        ps = mod.PubSub()
        a, b = ps.subscribe(), ps.subscribe()
        for i in range(5):
            ps.publish({"n": i})
        ps.unsubscribe(b)
        ps.publish({"n": 99})
        got.append((ps.subscriber_count,
                    [a.get_nowait() for _ in range(a.qsize())], b.qsize()))
    assert got[0] == got[1]


def test_bandwidth_monitor_matches(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(time, "time", lambda: clock[0])
    got = {}
    for mod in (bandwidth, ref_bandwidth):
        clock[0] = 1000.0
        bm = mod.BandwidthMonitor()
        for i in range(20):
            clock[0] += 0.25
            bm.record(f"b{i % 3}", 1000 * i, 7 * i)
        tb = mod.TokenBucket(4096)
        got[mod] = (json.dumps(bm.report(), sort_keys=True),
                    [tb._take(n) for n in (100, 3000, 2000, 10)])
    assert got[bandwidth] == got[ref_bandwidth]
