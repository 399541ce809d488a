"""Runtime lock-order sanitizer (opt-in: ``MTPU_LOCKTRACE=1``).

The static linter (tools/mtpu_lint) proves per-file invariants; what it
cannot see is the *dynamic* interleaving of locks across subsystems —
a registry-wide drive-monitor lock once serialized the quorum fan-out; no
AST walk could have said so. This module closes that gap the way TSan's
deadlock detector does, scaled down to stdlib threading:

- ``install()`` replaces ``threading.Lock``/``threading.RLock`` with
  tracing factories. Every lock created afterwards remembers its
  construction site (file:line), and every ``acquire`` records, for the
  acquiring thread, an ordered edge from each lock already held to the
  one being taken.
- The edges form a process-wide lock-ORDER graph keyed by construction
  site. A cycle in that graph (site A taken while holding B somewhere,
  B taken while holding A somewhere else) is a potential deadlock even
  if the schedule that trips it never ran — exactly the class of bug a
  test suite's lucky timing hides.
- ``time.sleep`` is also patched: sleeping while holding a traced lock
  is recorded as a held-lock blocking call (the runtime twin of lint
  rule R3).

Reports are collected, not raised: ``cycles()`` / ``blocking_reports()``
are checked by tests/conftest.py at session end, so the whole tier-1
suite doubles as the sanitizer's workload (acceptance: zero cycles).

Costs and limits:

- per-acquire overhead is one thread-local list append plus, when other
  locks are held, one dict insert — measured noise on this box;
- locks created *before* ``install()`` (e.g. jax internals imported
  first) are untraced by design: the interesting graph is minio_tpu's;
- edges between two locks from the SAME construction site are skipped:
  per-instance locks (one per drive, one per gate) legitimately nest
  against their siblings and would otherwise self-cycle; ordering bugs
  *within* one site family need lock striping analysis this tool does
  not attempt;
- ``Condition`` wait/notify works through delegation: ``_release_save``
  on a raw C RLock bypasses the wrapper while waiting, which only
  affects the waiter's own (blocked) thread and re-converges when the
  wait returns.

The port's own copy of ``minio_tpu/utils/locktrace.py``, with no change in
behaviour.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_SLEEP = time.sleep

_installed = False


class _Graph:
    """Lock-order edges + held-lock blocking reports, swappable so the
    constructed-deadlock regression test can run in isolation without
    polluting (or tripping) the session-wide gate."""

    def __init__(self):
        self.mu = _REAL_LOCK()
        # (held_site, acquired_site) -> first thread name that drew it
        self.edges: dict[tuple[str, str], str] = {}
        # (lock_site, call_site, kind) -> count
        self.blocking: dict[tuple[str, str, str], int] = {}

    def add_edge(self, held_site: str, acq_site: str) -> None:
        key = (held_site, acq_site)
        if key in self.edges:  # racy pre-check: worst case one extra lock
            return
        with self.mu:
            self.edges.setdefault(key, threading.current_thread().name)

    def add_blocking(self, lock_site: str, call_site: str,
                     kind: str) -> None:
        key = (lock_site, call_site, kind)
        with self.mu:
            self.blocking[key] = self.blocking.get(key, 0) + 1


_graph = _Graph()

# Thread-local stack of currently-held traced locks.
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _call_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class _TracedLock:
    """Delegating wrapper around a raw _thread lock/rlock. Tracks the
    per-thread held stack and feeds the order graph on nested acquires."""

    __slots__ = ("_inner", "site", "allow_blocking", "_last_held",
                 "__weakref__")

    def __init__(self, inner, site: str):
        self._inner = inner
        self.site = site
        self.allow_blocking = False
        # Held-stack of the most recent acquirer (see release():
        # cross-thread handoff releases must clean the ACQUIRER's
        # stack, not the releasing thread's).
        self._last_held = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            held = _held()
            if held and self not in held:
                site = self.site
                add = _graph.add_edge
                for lk in held:
                    if lk.site != site:
                        add(lk.site, site)
            # RLock re-entry appends again; release pops one level.
            held.append(self)
            self._last_held = held
        return got

    def release(self):
        # Single atomic list.remove calls only: a compound find+del
        # here could race the cross-thread cleanup below mutating the
        # same list (shrink between index computation and del =
        # IndexError before the real release, or wrong-entry delete).
        # remove() takes the leftmost entry, which is fine — for an
        # RLock held re-entrantly only the COUNT of entries matters
        # (edges are drawn solely on the first acquire).
        held = getattr(_tls, "held", None)
        removed = False
        if held:
            try:
                held.remove(self)
                removed = True
            except ValueError:
                pass
        if not removed:
            # Handoff-latch pattern: acquired on thread A, released on
            # thread B (legal for plain Lock). Without this, A's stack
            # would keep the lock forever — false edges on every later
            # acquire and false blocking reports on every later sleep.
            other = self._last_held
            if other is not None:
                try:
                    other.remove(self)
                except ValueError:
                    pass
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        # _is_owned / _release_save / _acquire_restore (Condition on an
        # RLock) and anything else delegate to the raw lock.
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<TracedLock {self.site} {self._inner!r}>"


def _traced_lock():
    return _TracedLock(_REAL_LOCK(), _call_site())


def _traced_rlock():
    return _TracedLock(_REAL_RLOCK(), _call_site())


def _traced_sleep(seconds):
    held = getattr(_tls, "held", None)
    if held:
        site = _call_site()
        for lk in held:
            if not lk.allow_blocking:
                _graph.add_blocking(lk.site, site, "time.sleep")
    return _REAL_SLEEP(seconds)


def transaction_lock(lock):
    """Mark `lock` as a coarse TRANSACTION lock whose critical section
    deliberately spans blocking work (config writes persisting through
    the quorum store, for example). Held-lock blocking reports are
    waived for it — the runtime twin of an inline lint suppression,
    declared at the construction site. Lock-ORDER edges still record:
    a transaction lock can still deadlock. No-op (returns the lock
    unchanged) when tracing is off."""
    if isinstance(lock, _TracedLock):
        lock.allow_blocking = True
    return lock


def install() -> None:
    """Patch threading.Lock/RLock and time.sleep. Idempotent."""
    global _installed
    if _installed:
        return
    _installed = True
    threading.Lock = _traced_lock
    threading.RLock = _traced_rlock
    time.sleep = _traced_sleep


def maybe_install() -> bool:
    """install() when MTPU_LOCKTRACE is truthy in the environment
    (any common spelling of off — 0/off/false/no, case-insensitive —
    stays off: a production operator writing MTPU_LOCKTRACE=false must
    not get a fully traced server)."""
    val = os.environ.get("MTPU_LOCKTRACE", "").strip().lower()
    if val in ("", "0", "off", "false", "no", "disabled"):
        return False
    install()
    return True


def installed() -> bool:
    return _installed


# -- reporting ---------------------------------------------------------------


def edges() -> dict[tuple[str, str], str]:
    with _graph.mu:
        return dict(_graph.edges)


def blocking_reports() -> dict[tuple[str, str, str], int]:
    with _graph.mu:
        return dict(_graph.blocking)


def cycles() -> list[list[str]]:
    """Elementary cycles in the site-order graph, each as the list of
    sites in order (first site repeated implicitly). Deduplicated by
    rotation so A->B->A and B->A->B report once."""
    with _graph.mu:
        es = list(_graph.edges)
    adj: dict[str, set[str]] = {}
    for a, b in es:
        adj.setdefault(a, set()).add(b)
    out: list[list[str]] = []
    seen: set[tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: list[str],
            visited: set[str]) -> None:
        for nxt in adj.get(node, ()):
            if nxt == start:
                rot = min(tuple(path[i:] + path[:i])
                          for i in range(len(path)))
                if rot not in seen:
                    seen.add(rot)
                    out.append(list(path))
            elif nxt not in visited and nxt > start:
                # Only explore nodes ordered after `start` so each cycle
                # is found from its smallest node exactly once.
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for n in sorted(adj):
        dfs(n, n, [n], {n})
    return out


def report() -> str:
    """Human-readable summary (conftest prints this on violation)."""
    lines = []
    cyc = cycles()
    if cyc:
        lines.append(f"locktrace: {len(cyc)} lock-order cycle(s):")
        for c in cyc:
            lines.append("  cycle: " + " -> ".join(c + [c[0]]))
    blk = blocking_reports()
    if blk:
        lines.append(f"locktrace: {len(blk)} held-lock blocking call "
                     "site(s):")
        for (lock_site, call_site, kind), n in sorted(blk.items()):
            lines.append(f"  {kind} at {call_site} while holding lock "
                         f"from {lock_site} (x{n})")
    return "\n".join(lines)


def reset() -> None:
    with _graph.mu:
        _graph.edges.clear()
        _graph.blocking.clear()


class isolated:
    """Context manager: swap in a fresh graph (the constructed-deadlock
    regression test records an intentional cycle without tripping the
    session-wide zero-cycle gate)."""

    def __enter__(self):
        global _graph
        self._saved = _graph
        _graph = _Graph()
        return sys.modules[__name__]

    def __exit__(self, *exc):
        global _graph
        _graph = self._saved
        return False
