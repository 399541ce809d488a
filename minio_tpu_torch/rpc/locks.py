"""dsync: distributed RW locks with quorum (ref pkg/dsync/drwmutex.go:49,
cmd/local-locker.go, cmd/lock-rest-server.go).

Algorithm (ref lock:207): try to acquire on ALL lockers in parallel;
success iff >= quorum grants (n/2+1 for write, n/2 for read, matching
the reference); on failure release all grants and retry with jitter
until timeout. Stale locks expire server-side after LOCK_TTL (lock
maintenance sweep, ref lock-rest-server.go lockMaintenance); held locks
are refreshed by a background keep-alive (ref drwmutex continuous
refresh) so long operations never silently lose exclusion.

The port's own copy of ``minio_tpu/rpc/locks.py``, with no change in
behaviour.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from contextlib import contextmanager

from ..storage import errors as serr

LOCK_TTL = 60.0  # orphaned-lock expiry (maintenance sweep)


class LocalLocker:
    """Node-local lock table (ref localLocker, cmd/local-locker.go)."""

    def __init__(self):
        self._mu = threading.Lock()
        # resource -> {"writer": uid | None, "readers": {uid: expiry},
        #              "expiry": float}
        self._locks: dict[str, dict] = {}

    def _sweep(self, now: float) -> None:
        for res in list(self._locks):
            st = self._locks[res]
            if st["writer"] and st["expiry"] < now:
                st["writer"] = None
            st["readers"] = {u: e for u, e in st["readers"].items()
                             if e >= now}
            if not st["writer"] and not st["readers"]:
                del self._locks[res]

    def lock(self, resource: str, uid: str, writer: bool) -> bool:
        """Acquire or refresh: a repeat call from the holding uid renews
        the TTL (the keep-alive path). A failed writer attempt leaves a
        short writer-preference window during which new readers are
        refused, so steady reads can't starve writes."""
        now = time.monotonic()
        with self._mu:
            self._sweep(now)
            st = self._locks.setdefault(
                resource, {"writer": None, "readers": {}, "expiry": 0.0,
                           "writer_wait": 0.0})
            if writer:
                if st["writer"] is None and not st["readers"]:
                    st["writer"] = uid
                    st["expiry"] = now + LOCK_TTL
                    st["writer_wait"] = 0.0
                    return True
                if st["writer"] == uid:
                    st["expiry"] = now + LOCK_TTL
                    return True
                st["writer_wait"] = now + 1.0
                return False
            if st["writer"] is None and st.get("writer_wait", 0.0) <= now:
                st["readers"][uid] = now + LOCK_TTL
                return True
            if st["writer"] is None and uid in st["readers"]:
                st["readers"][uid] = now + LOCK_TTL  # refresh held read
                return True
            return False

    def unlock(self, resource: str, uid: str, writer: bool) -> bool:
        with self._mu:
            st = self._locks.get(resource)
            if st is None:
                return False
            if writer:
                if st["writer"] == uid:
                    st["writer"] = None
            else:
                st["readers"].pop(uid, None)
            if not st["writer"] and not st["readers"]:
                self._locks.pop(resource, None)
            return True

    def force_unlock(self, resource: str) -> None:
        with self._mu:
            self._locks.pop(resource, None)

    def top_locks(self) -> list[dict]:
        with self._mu:
            return [{"resource": r, "writer": bool(st["writer"]),
                     "readers": len(st["readers"])}
                    for r, st in self._locks.items()]


class LockRPCService:
    """Exposes a LocalLocker over the RPC transport."""

    def __init__(self, locker: LocalLocker):
        self.locker = locker

    def rpc_lock(self, a, p):
        ok = self.locker.lock(a["resource"], a["uid"], a["writer"])
        return {"granted": ok}, b""

    def rpc_unlock(self, a, p):
        self.locker.unlock(a["resource"], a["uid"], a["writer"])
        return {}, b""

    def rpc_force_unlock(self, a, p):
        self.locker.force_unlock(a["resource"])
        return {}, b""

    def rpc_top_locks(self, a, p):
        return {"locks": self.locker.top_locks()}, b""


class _LocalLockerClient:
    """In-process locker endpoint (this node's own table)."""

    def __init__(self, locker: LocalLocker):
        self.locker = locker

    def lock(self, resource, uid, writer):
        return self.locker.lock(resource, uid, writer)

    def unlock(self, resource, uid, writer):
        self.locker.unlock(resource, uid, writer)


class _RemoteLockerClient:
    """Peer locker endpoint over RPC."""

    def __init__(self, client):
        self.client = client

    def lock(self, resource, uid, writer):
        try:
            res, _ = self.client.call("lock", "lock",
                                      {"resource": resource, "uid": uid,
                                       "writer": writer})
            return bool(res.get("granted"))
        except serr.StorageError:
            return False

    def unlock(self, resource, uid, writer):
        try:
            self.client.call("lock", "unlock",
                             {"resource": resource, "uid": uid,
                              "writer": writer})
        except serr.StorageError:
            pass


class DRWMutex:
    """Distributed RW mutex over a set of locker endpoints
    (ref DRWMutex, pkg/dsync/drwmutex.go)."""

    def __init__(self, lockers: list, resource: str):
        self.lockers = lockers
        self.resource = resource

    def _quorum(self, writer: bool) -> int:
        """Write quorum n/2+1, read quorum n/2 (min 1) — ref
        pkg/dsync/drwmutex.go:207 quorum math."""
        n = len(self.lockers)
        return n // 2 + 1 if writer else max(n // 2, 1)

    def _fan(self, fn_name: str, uid: str, writer: bool) -> list[bool]:
        from ..parallel.quorum import parallel_map
        results, _ = parallel_map(
            [lambda lk=lk: getattr(lk, fn_name)(self.resource, uid,
                                                writer)
             for lk in self.lockers])
        return [bool(r) for r in results]

    def _try(self, uid: str, writer: bool) -> bool:
        grants = self._fan("lock", uid, writer)
        if sum(grants) >= self._quorum(writer):
            return True
        # Release partial grants (ref releaseAll:364).
        for lk, g in zip(self.lockers, grants):
            if g:
                lk.unlock(self.resource, uid, writer)
        return False

    def acquire(self, writer: bool, timeout: float = 30.0) -> str:
        uid = uuid.uuid4().hex
        deadline = time.monotonic() + timeout
        while True:
            if self._try(uid, writer):
                return uid
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"dsync: could not acquire {self.resource}")
            time.sleep(random.uniform(0.01, 0.05))

    def refresh(self, uid: str, writer: bool) -> bool:
        """Keep-alive: re-lock on every locker renews the server TTL.
        Returns False when the quorum was LOST (swept/usurped during a
        partition) — the holder no longer has exclusion."""
        grants = self._fan("lock", uid, writer)
        return sum(grants) >= self._quorum(writer)

    def release(self, uid: str, writer: bool) -> None:
        self._fan("unlock", uid, writer)


class DistNSLock:
    """Namespace-lock provider backed by dsync — drop-in for
    parallel.nslock.LocalNSLock in distributed mode
    (ref cmd/namespace-lock.go NewNSLock)."""

    def __init__(self, lockers: list, default_timeout: float = 30.0):
        self.lockers = lockers
        self.default_timeout = default_timeout
        # One shared keep-alive sweeper refreshes every held lock
        # (ref drwmutex continuous refresh; avoids a thread per lock).
        self._mu = threading.Lock()
        self._held: dict[int, dict] = {}
        self._next_id = 0
        self._sweeper: threading.Thread | None = None

    def _ensure_sweeper(self) -> None:
        if self._sweeper is None or not self._sweeper.is_alive():
            # mtpu-lint: disable=R1 -- lease-expiry sweeper daemon; runs for the server lifetime
            self._sweeper = threading.Thread(target=self._sweep_loop,
                                             daemon=True)
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        while True:
            time.sleep(LOCK_TTL / 3)
            with self._mu:
                entries = list(self._held.values())
            for e in entries:
                if not e["mutex"].refresh(e["uid"], e["writer"]):
                    e["lost"] = True

    @contextmanager
    def _locked(self, bucket: str, obj: str, writer: bool,
                timeout: float | None):
        m = DRWMutex(self.lockers, f"{bucket}/{obj}")
        uid = m.acquire(writer=writer,
                        timeout=timeout or self.default_timeout)
        entry = {"mutex": m, "uid": uid, "writer": writer, "lost": False}
        with self._mu:
            hid = self._next_id
            self._next_id += 1
            self._held[hid] = entry
        self._ensure_sweeper()
        try:
            yield
            if entry["lost"]:
                # Exclusion was lost mid-operation (partition longer
                # than LOCK_TTL): surface it loudly instead of
                # pretending the op was safe.
                raise TimeoutError(
                    f"dsync: lock on {bucket}/{obj} lost during "
                    f"operation (possible concurrent writer)")
        finally:
            with self._mu:
                self._held.pop(hid, None)
            m.release(uid, writer=writer)

    def write_locked(self, bucket: str, obj: str,
                     timeout: float | None = None):
        return self._locked(bucket, obj, True, timeout)

    def read_locked(self, bucket: str, obj: str,
                    timeout: float | None = None):
        return self._locked(bucket, obj, False, timeout)
