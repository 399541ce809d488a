"""Boot-time crash-recovery sweep.

A kill -9 (or power cut) anywhere on the commit path leaves three
kinds of residue on the set's local drives:

1. **Orphaned staging dirs** under ``.minio.sys/tmp`` — a PUT,
   multipart complete, or heal write-back that died before (or midway
   through) its per-disk ``rename_data`` commits. Before this sweep
   they leaked forever.
2. **Orphaned part stage files** (``part.N.<uuid>.stage``) under the
   multipart tree — a ``put_object_part`` that died between streaming
   and promote; the upload session itself stays (clients retry parts),
   only the torn stage is garbage.
3. **Quorum-committed-but-minority-missing objects** — the commit
   fan-out died after write quorum but before every disk committed.
   The object is durable and serves, but below full redundancy, and
   NOTHING would re-queue its repair (the crash also killed the
   in-memory MRF add). Each staging dir carries an ``intent.json``
   breadcrumb (bucket/object) written by the engine for exactly this:
   the sweep maps the orphan back to its object and requeues it
   through the MRF (which the durable MRF journal persists).

Everything is **age-gated** (``MINIO_RECOVERY_TMP_AGE`` seconds,
default 60): in distributed layouts a restarting node serves storage
RPC to its peers before its own boot finishes, so a freshly-mtimed
staging dir may be a LIVE remote write, not a crash orphan — recency
is the only signal that distinguishes them, and a leaked dir for one
more boot is cheaper than a torn live PUT.

The sweep runs synchronously at layer attach (S3Server.set_layer),
reports found/cleaned/requeued via metrics2
(``minio_tpu_v2_recovery_swept_total``), a console line, and the admin
``/recovery`` surface, and drives the durable MRF journal replay
(erasure/mrfjournal.py) in the same pass — one boot-time recovery
story, one report.

The port's own copy of ``minio_tpu/storage/recovery.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import os
import shutil
import time

from .xl import INTENT_FILE, MINIO_META_BUCKET, TMP_DIR


def tmp_gc_age_s() -> float:
    """Age gate for staging residue (seconds). Read per sweep so the
    crash harness can tighten it per process via env."""
    try:
        return float(os.environ.get("MINIO_RECOVERY_TMP_AGE", "60"))
    except ValueError:
        return 60.0


def _read_intent(stage_dir: str) -> tuple[str, str, str] | None:
    """Best-effort (bucket, object, dataDir) from a staging dir's
    breadcrumb. Torn/garbled intents (fsync-less crash window) yield
    None — the dir still GCs, only the requeue hint is lost."""
    try:
        with open(os.path.join(stage_dir, INTENT_FILE), "rb") as f:
            doc = json.loads(f.read())
        return (str(doc["bucket"]), str(doc["object"]),
                str(doc.get("dataDir", "")))
    except Exception:
        return None


def _object_presence(engine, bucket: str, object_name: str,
                     data_dir: str = "") -> tuple[int, int]:
    """(disks that committed the intent's version, disks that
    didn't). With a dataDir hint the check is VERSION-aware: a crash
    mid-OVERWRITE leaves every disk with *some* version (the old one),
    so 'any readable version' would classify the torn commit as fully
    present and never requeue it — the exact case the sweep exists
    for. Without a hint (torn intent, zero-byte objects) it degrades
    to any-version presence. Heal re-classifies under its own lock
    before acting either way."""
    present = absent = 0
    for disk in engine.disks:
        try:
            versions = disk.read_versions(bucket, object_name)
        except Exception:
            absent += 1
            continue
        if not versions:
            absent += 1
        elif not data_dir or any(
                getattr(v, "data_dir", "") == data_dir
                for v in versions):
            present += 1
        else:
            absent += 1
    return present, absent


def sweep_engine(engine, age_s: float | None = None) -> dict:
    """One erasure set's recovery sweep over its LOCAL disks (remote
    disks are their own node's job). Returns the report dict (also
    stashed on ``engine.recovery_report``)."""
    t0 = time.monotonic()
    if age_s is None:
        age_s = tmp_gc_age_s()
    now = time.time()
    found = cleaned = stage_files = 0
    intents: dict[tuple[str, str], str] = {}
    local_disks = 0
    from ..erasure.multipart import MPU_PATH
    for disk in getattr(engine, "disks", []):
        root = getattr(disk, "root", None)
        if root is None:
            continue
        local_disks += 1
        tmp = os.path.join(root, TMP_DIR)
        try:
            names = os.listdir(tmp)
        except OSError:
            names = []
        for name in names:
            path = os.path.join(tmp, name)
            try:
                st = os.lstat(path)
            except OSError:
                continue
            if now - st.st_mtime < age_s:
                continue  # possibly a live write on a shared disk
            found += 1
            if os.path.isdir(path):
                intent = _read_intent(path)
                if intent is not None:
                    b, o, dd = intent
                    # Keep a dataDir hint when any orphan carries one.
                    intents[(b, o)] = intents.get((b, o)) or dd
                shutil.rmtree(path, ignore_errors=True)
                if not os.path.isdir(path):
                    cleaned += 1
            else:
                # Loose tmp files (atomic-write staging, link staging).
                try:
                    os.remove(path)
                    cleaned += 1
                except OSError:
                    pass
        # Torn multipart part stages: the upload session survives (a
        # client retries the part), only `.stage` remnants are
        # garbage.
        mpu = os.path.join(root, MINIO_META_BUCKET, MPU_PATH)
        for dirpath, _dirs, files in os.walk(mpu):
            for fname in files:
                if not fname.endswith(".stage"):
                    continue
                p = os.path.join(dirpath, fname)
                try:
                    if now - os.lstat(p).st_mtime >= age_s:
                        os.remove(p)
                        stage_files += 1
                except OSError:
                    pass

    # Durable MRF journal replay rides the same boot pass: queued
    # repairs from before the crash re-enter the queue (and the
    # mrf_queue_depth gauge). Replay FIRST, so intent-driven requeues
    # below dedup against it instead of double-counting as "replayed".
    replayed = 0
    mrf = getattr(engine, "mrf", None)
    if mrf is not None and hasattr(mrf, "replay_journal"):
        replayed = mrf.replay_journal()

    # Requeue objects the orphans point at — but only the partially-
    # committed ones (present on SOME disks, missing on others): a
    # fully-absent intent was an uncommitted write (the GC above is
    # the whole recovery), a fully-present one lost only garbage
    # collection.
    requeued: list[str] = []
    for (bucket, object_name) in sorted(intents):
        present, absent = _object_presence(
            engine, bucket, object_name,
            data_dir=intents[(bucket, object_name)])
        if present > 0 and absent > 0:
            engine.mrf.add(bucket, object_name)
            requeued.append(f"{bucket}/{object_name}")

    report = {
        "localDisks": local_disks,
        "found": found, "cleaned": cleaned,
        "stageFiles": stage_files,
        "requeued": requeued, "journalReplayed": replayed,
        "ageGateS": age_s,
        "durationS": round(time.monotonic() - t0, 4),
    }
    engine.recovery_report = report

    if found or stage_files or requeued or replayed:
        from ..obs.metrics2 import METRICS2
        for what, n in (("found", found), ("cleaned", cleaned),
                        ("stage_files", stage_files),
                        ("requeued", len(requeued)),
                        ("journal_replayed", replayed)):
            if n:
                METRICS2.inc("minio_tpu_v2_recovery_swept_total",
                             {"what": what}, n)
    # Unconditional one-liner: a boot that swept NOTHING is itself
    # evidence (the crash left no residue / the gate spared it all).
    from ..logger import Logger
    Logger.get().info(
        f"recovery sweep: {found} orphaned staging dir(s) found, "
        f"{cleaned} cleaned, {stage_files} torn part stage(s) "
        f"removed, {len(requeued)} object(s) requeued for heal, "
        f"{replayed} journaled repair(s) replayed "
        f"({report['durationS'] * 1e3:.0f}ms)", "recovery")
    return report


def sweep_layer(layer, age_s: float | None = None) -> list[dict]:
    """Recovery-sweep every erasure set of a layer (server boot).
    Layers without erasure sets (FS backend, gateways) sweep
    nothing."""
    reports: list[dict] = []
    pools = getattr(layer, "pools", None)
    if pools is None:
        pools = [layer]
    for pool in pools:
        for es in getattr(pool, "sets", [pool]):
            if not hasattr(es, "disks") or not hasattr(es, "mrf"):
                continue
            try:
                reports.append(sweep_engine(es, age_s=age_s))
            except Exception:
                from ..logger import Logger
                Logger.get().log_once(
                    "recovery sweep failed for an erasure set",
                    "recovery")
    return reports
