"""Namespace locks: per-(bucket, object) RW locks.

Single-node: in-process reader/writer locks (ref pkg/lsync +
cmd/namespace-lock.go:276). Distributed: the same interface backed by
dsync quorum locks over the lock RPC (rpc/locks.py).

The port's own copy of ``minio_tpu/parallel/nslock.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class _RWLock:
    """Writer-preferring reader/writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self, timeout: float | None = None) -> bool:
        with self._cond:
            def ready():
                return not self._writer and self._writers_waiting == 0
            if not self._cond.wait_for(ready, timeout):
                return False
            self._readers += 1
            return True

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self, timeout: float | None = None) -> bool:
        with self._cond:
            self._writers_waiting += 1
            try:
                def ready():
                    return not self._writer and self._readers == 0
                if not self._cond.wait_for(ready, timeout):
                    return False
                self._writer = True
                return True
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    def idle(self) -> bool:
        return (not self._writer and self._readers == 0
                and self._writers_waiting == 0)


class LocalNSLock:
    """In-process namespace lock registry (ref nsLockMap,
    cmd/namespace-lock.go). Entries are reference-counted so a lock
    object handed to a waiter is never GC'd out from under it (the
    ref/waiter count is the reference's nsLock ref counter)."""

    def __init__(self):
        self._mu = threading.Lock()
        # key -> [lock, refcount]
        self._locks: dict[tuple[str, str], list] = {}

    def _get(self, bucket: str, obj: str) -> _RWLock:
        with self._mu:
            key = (bucket, obj)
            ent = self._locks.get(key)
            if ent is None:
                ent = [_RWLock(), 0]
                self._locks[key] = ent
            ent[1] += 1
            return ent[0]

    def _put(self, bucket: str, obj: str) -> None:
        with self._mu:
            key = (bucket, obj)
            ent = self._locks.get(key)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] <= 0 and ent[0].idle():
                del self._locks[key]

    @contextmanager
    def write_locked(self, bucket: str, obj: str,
                     timeout: float | None = 30.0):
        lk = self._get(bucket, obj)
        try:
            if not lk.acquire_write(timeout):
                raise TimeoutError(f"write lock timeout: {bucket}/{obj}")
            try:
                yield
            finally:
                lk.release_write()
        finally:
            self._put(bucket, obj)

    @contextmanager
    def read_locked(self, bucket: str, obj: str,
                    timeout: float | None = 30.0):
        lk = self._get(bucket, obj)
        try:
            if not lk.acquire_read(timeout):
                raise TimeoutError(f"read lock timeout: {bucket}/{obj}")
            try:
                yield
            finally:
                lk.release_read()
        finally:
            self._put(bucket, obj)
