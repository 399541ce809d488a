"""Runtime fault-injection subsystem: a seeded, deterministic
fault-plan engine the whole stack consults at its failure boundaries.

Every robustness claim in this codebase ultimately reduces to "when X
breaks, the system does Y" — and proving that needs X to break on
demand, reproducibly. Earlier rounds used one-off shims (a
``fault_latency_s`` attribute on XLStorage, monkeypatched disks in
tests); this module promotes injection to a first-class subsystem so
the data plane, the RPC transport, and the kernel dispatch layer all
share ONE plan with ONE deterministic decision procedure:

    plan = {"seed": 7, "rules": [
        {"kind": "latency", "target": "/disks/d5", "op": "read",
         "latency_ms": 80},
        {"kind": "error",   "target": "/disks/d3", "probability": 0.5},
        {"kind": "corrupt", "target": "/disks/d1", "op": "read"},
        {"kind": "torn_write", "target": "/disks/d2"},
        {"kind": "partition",  "target": "10.0.0.2:9000"},
        {"kind": "slow_wire",  "target": "10.0.0.2:9000",
         "latency_ms": 30},
        {"kind": "kernel", "target": "rs_encode"},
        {"kind": "loop_block", "target": "s3-0", "latency_ms": 400},
    ]}

Rule fields: ``kind`` (required), ``target`` (substring matched against
the drive endpoint / peer endpoint / kernel name / crash-point name;
empty matches all), ``op`` (exact storage op name or drivemon op class
read/write/stat/delete; ``*`` matches all), ``latency_ms``,
``probability`` (default 1.0), ``after`` (skip the first N matching
occurrences), ``count`` (fire at most N times; 0 = unlimited).

The ``crash`` kind is the crash-consistency harness's lever: the
commit paths in ``storage/xl.py`` / ``erasure/engine.py`` /
``erasure/multipart.py`` / ``erasure/heal.py`` declare NAMED crash
points (:meth:`FaultInjector.crash_point`) at every boundary where a
process death leaves interesting on-disk state — post-tmp-write,
between per-disk shard commits, mid multipart hard-link loop,
straddling the xl.meta replace, mid heal write-back. A fired crash
rule calls ``os._exit(137)``: no atexit handlers, no flushes, no
finally blocks — the closest in-process stand-in for SIGKILL, so the
restart-and-assert harness (tests/test_crash_consistency.py)
exercises REAL torn state, not a politely unwound exception. Points
register at import time, so the admin ``/fault-inject`` GET can
enumerate coverage (name + traversal count + armed flag) before any
traffic flows.

Determinism: whether occurrence ``n`` of a rule fires is a pure
function of (seed, rule index, n) — a SHA-256-derived fraction compared
against ``probability`` — so the same plan over the same op sequence
always injects the same faults, which is what makes scenario matrices
(tests/test_fault_harness.py) debuggable.

Hook points (each a one-attribute check when no plan is loaded):
  - ``storage/xl.py``  ``_DiskOp.__enter__`` -> :meth:`disk_op`
    (latency + error), ``read_*``/write paths -> :meth:`filter_read`
    / :meth:`filter_write` (corrupt, torn_write), ``rename_data`` ->
    :meth:`crash_point`;
  - ``rpc/transport.py`` ``RPCClient.call`` -> :meth:`peer`
    (partition, slow_wire);
  - ``ops/batching.py`` and the other kernel-lane dispatches ->
    :meth:`kernel` (kernel-dispatch failure: the CPU lane fails over to
    the host lanes, a card's dispatch raises to its caller);
  - ``obs/loopmon.py`` heartbeat -> :meth:`loop_block` (deterministic
    blocking callback on a named event loop; proves the stall
    detect -> blame -> fire -> resolve chain).

Configured via the admin API (``/minio-tpu/admin/v1/fault-inject``)
or config-KV (``fault_inject enable=on plan=<compact JSON>``).

The port's own copy of ``minio_tpu/faultinject/__init__.py``, with no
change in behaviour.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

KINDS = ("latency", "error", "corrupt", "torn_write", "partition",
         "slow_wire", "kernel", "crash", "loop_block")

# kinds consulted at each hook
_DISK_KINDS = ("latency", "error")
_PEER_KINDS = ("partition", "slow_wire")


class InjectedFault(Exception):
    """Marker base so injected failures are distinguishable in logs."""


class FaultPlanError(ValueError):
    """The submitted plan document is malformed."""


class _Rule:
    __slots__ = ("index", "kind", "target", "op", "latency_ms",
                 "probability", "after", "count", "seen", "fired")

    def __init__(self, index: int, doc: dict):
        if not isinstance(doc, dict):
            raise FaultPlanError(f"rule {index}: not an object")
        kind = doc.get("kind")
        if kind not in KINDS:
            raise FaultPlanError(
                f"rule {index}: kind {kind!r} not in {KINDS}")
        self.index = index
        self.kind = kind
        self.target = str(doc.get("target", ""))
        self.op = str(doc.get("op", "*")) or "*"
        try:
            self.latency_ms = float(doc.get("latency_ms", 0.0))
            self.probability = float(doc.get("probability", 1.0))
            self.after = int(doc.get("after", 0))
            self.count = int(doc.get("count", 0))
        except (TypeError, ValueError) as e:
            raise FaultPlanError(f"rule {index}: {e}")
        if not (0.0 <= self.probability <= 1.0):
            raise FaultPlanError(
                f"rule {index}: probability {self.probability} "
                "outside [0, 1]")
        if self.latency_ms < 0 or self.after < 0 or self.count < 0:
            raise FaultPlanError(f"rule {index}: negative field")
        unknown = set(doc) - {"kind", "target", "op", "latency_ms",
                              "probability", "after", "count"}
        if unknown:
            raise FaultPlanError(
                f"rule {index}: unknown fields {sorted(unknown)}")
        self.seen = 0     # matching occurrences observed
        self.fired = 0    # occurrences that actually injected

    def to_dict(self) -> dict:
        return {"kind": self.kind, "target": self.target, "op": self.op,
                "latency_ms": self.latency_ms,
                "probability": self.probability, "after": self.after,
                "count": self.count, "seen": self.seen,
                "fired": self.fired}


def _op_matches(rule_op: str, op: str) -> bool:
    if rule_op == "*" or rule_op == op:
        return True
    from ..obs.drivemon import op_class
    return rule_op == op_class(op)


class FaultInjector:
    """Process-wide fault-plan engine (singleton ``FAULTS``).

    Hot-path discipline: with no plan loaded every hook is a single
    attribute read (``self.enabled``); with a plan loaded, decisions
    are computed under the lock but SLEEPS AND RAISES happen outside
    it (lint R3 — a fault injector must not serialize the fan-outs it
    is trying to perturb)."""

    # Test seam for the crash kind: the harness's subprocess servers
    # die for real; in-process unit tests swap this for a recorder.
    # os._exit, not sys.exit: no atexit, no finally, no flushes — the
    # whole point is that NOTHING between the crash point and the
    # kernel runs.
    _exit = staticmethod(os._exit)
    CRASH_EXIT_CODE = 137  # what a SIGKILL-ed process reports

    def __init__(self):
        self.enabled = False
        self._mu = threading.Lock()
        self._rules: list[_Rule] = []
        self._seed = 0
        self._loaded_at = 0.0
        # Named crash points, declared at import time by the modules
        # that host them (name -> traversals observed while a plan was
        # armed). Static registration is deliberate: the harness
        # enumerates coverage from the admin GET, so a point that is
        # never traversed must still be LISTED (a registry built from
        # traffic would silently under-report coverage).
        self._crash_points: dict[str, int] = {}
        # Fires recorded AT the point itself, not inferred from rule
        # counters — a broad rule target matches many points, and its
        # fired total must not smear across all of them. (Almost
        # always unobservable post-fire — the process exits — but an
        # inferred-wrong positive is worse than an honest zero.)
        self._crash_fired: dict[str, int] = {}

    # -- plan management ----------------------------------------------

    @staticmethod
    def validate(doc: dict) -> list[_Rule]:
        if not isinstance(doc, dict):
            raise FaultPlanError("plan must be a JSON object")
        unknown = set(doc) - {"seed", "rules"}
        if unknown:
            raise FaultPlanError(f"unknown plan fields {sorted(unknown)}")
        rules = doc.get("rules", [])
        if not isinstance(rules, list):
            raise FaultPlanError("rules must be a list")
        return [_Rule(i, r) for i, r in enumerate(rules)]

    def load_plan(self, doc: dict) -> None:
        """Validate + atomically install a plan (replaces any active
        one; counters restart so determinism restarts with it)."""
        rules = self.validate(doc)
        seed = int(doc.get("seed", 0))
        with self._mu:
            self._rules = rules
            self._seed = seed
            self._loaded_at = time.time()
            self.enabled = bool(rules)
        from ..logger import Logger
        Logger.get().info(
            f"faultinject: plan loaded ({len(rules)} rules, "
            f"seed {seed})", "faultinject")

    def clear(self) -> None:
        with self._mu:
            had = bool(self._rules)
            self._rules = []
            self.enabled = False
        if had:
            from ..logger import Logger
            Logger.get().info("faultinject: plan cleared", "faultinject")

    def register_crash_point(self, name: str) -> str:
        """Declare a named crash point (module-import time). Idempotent;
        returns the name so hook modules can keep the constant."""
        with self._mu:
            self._crash_points.setdefault(name, 0)
        return name

    def crash_points(self) -> list[str]:
        with self._mu:
            return sorted(self._crash_points)

    def snapshot(self) -> dict:
        with self._mu:
            armed = set()
            for r in self._rules:
                if r.kind != "crash":
                    continue
                for name in self._crash_points:
                    if not r.target or r.target in name:
                        armed.add(name)
            return {"active": self.enabled, "seed": self._seed,
                    "loadedAt": self._loaded_at,
                    "rules": [r.to_dict() for r in self._rules],
                    # Per-point coverage counters for the crash
                    # harness and operators: hits counts traversals
                    # observed while a plan was armed (the no-plan hot
                    # path is one attribute read and counts nothing);
                    # fired counts kills AT the point.
                    "crashPoints": [
                        {"name": name, "hits": hits,
                         "armed": name in armed,
                         "fired": self._crash_fired.get(name, 0)}
                        for name, hits in sorted(
                            self._crash_points.items())]}

    # -- deterministic decision ---------------------------------------

    def _fires(self, rule: _Rule) -> bool:
        """Caller holds self._mu. Advances the rule's occurrence
        counter and decides deterministically whether it injects."""
        n = rule.seen
        rule.seen += 1
        if n < rule.after:
            return False
        if rule.count and rule.fired >= rule.count:
            return False
        if rule.probability < 1.0:
            h = hashlib.sha256(
                f"{self._seed}:{rule.index}:{n}".encode()).digest()
            frac = int.from_bytes(h[:8], "big") / float(1 << 64)
            if frac >= rule.probability:
                return False
        rule.fired += 1
        from ..obs.metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_fault_injections_total",
                     {"kind": rule.kind})
        return True

    def _collect(self, kinds, target: str, op: str = "*") -> list[_Rule]:
        """Fired rules of the given kinds matching target/op."""
        out = []
        with self._mu:
            for r in self._rules:
                if r.kind not in kinds:
                    continue
                if r.target and r.target not in target:
                    continue
                if op != "*" and not _op_matches(r.op, op):
                    continue
                if self._fires(r):
                    out.append(r)
        return out

    # -- hooks ---------------------------------------------------------

    def disk_op(self, endpoint: str, op: str) -> None:
        """Per-drive latency/error injection at the _DiskOp boundary.
        Sleeps land INSIDE the measured op window; errors raise
        FaultyDisk — exactly what a degraded physical drive looks like
        to the drive monitor."""
        if not self.enabled:
            return
        fired = self._collect(_DISK_KINDS, endpoint, op)
        err = None
        for r in fired:
            if r.kind == "latency" and r.latency_ms > 0:
                time.sleep(r.latency_ms / 1e3)
            elif r.kind == "error":
                err = r
        if err is not None:
            from ..storage.errors import FaultyDisk
            raise FaultyDisk(
                f"injected fault: {endpoint} {op} (rule {err.index})")

    def filter_read(self, endpoint: str, op: str, data: bytes) -> bytes:
        """Corrupt injection on read results: deterministically flip
        one byte (bitrot detection must catch it). The position is
        derived per OCCURRENCE, not fixed: the local-disk and
        remote-client read hooks can stack on one payload (loopback
        RPC), and two flips of the same byte would cancel into an
        uncorrupted read that silently passes verification."""
        if not self.enabled or not data:
            return data
        fired = self._collect(("corrupt",), endpoint, op)
        if not fired:
            return data
        blob = bytearray(data)
        for r in fired:
            h = hashlib.sha256(
                f"{self._seed}:{r.index}:{r.fired}:pos".encode()
            ).digest()
            blob[int.from_bytes(h[:8], "big") % len(blob)] ^= 0xFF
        return bytes(blob)

    def filter_write(self, endpoint: str, op: str, data: bytes) -> bytes:
        """Torn-write injection: the write persists only the first half
        of the payload (a crash mid-write), without erroring. ``data``
        may be bytes or a flat uint8 array (a pinned engine's frames)."""
        if not self.enabled or len(data) == 0:
            return data
        fired = self._collect(("torn_write",), endpoint, op)
        if not fired:
            return data
        return bytes(data[:max(1, len(data) // 2)])

    def peer(self, endpoint: str) -> tuple[float, bool]:
        """Per-peer wire faults: returns (extra latency seconds,
        partitioned). The transport sleeps/raises; raising here would
        hide which rule matched."""
        if not self.enabled:
            return 0.0, False
        lat = 0.0
        part = False
        for r in self._collect(_PEER_KINDS, endpoint):
            if r.kind == "slow_wire":
                lat += r.latency_ms / 1e3
            else:
                part = True
        return lat, part

    def loop_block(self, loop_name: str) -> float:
        """Event-loop blocker: seconds the named loop's loopmon
        heartbeat should schedule as a REAL blocking time.sleep
        callback onto its own loop (obs/loopmon.py
        ``_injected_loop_block``) — the deterministic stall that
        proves the detect -> blame -> fire -> resolve chain.  Returns
        0.0 with no plan loaded (single attribute read; the hook runs
        at 10Hz per loop)."""
        if not self.enabled:
            return 0.0
        total = 0.0
        for r in self._collect(("loop_block",), loop_name):
            total += r.latency_ms / 1e3
        return total

    def kernel(self, name: str) -> None:
        """Kernel-dispatch failure: raises inside the kernel-lane
        dispatch's try-block -- the CPU lane then fails over to the host
        lanes, a card's dispatch raises to its caller."""
        if not self.enabled:
            return
        if self._collect(("kernel",), name):
            raise InjectedFault(f"injected kernel-dispatch fault: {name}")

    def crash_point(self, name: str) -> None:
        """Named commit-path crash point: when an armed ``crash`` rule
        matches, the PROCESS DIES HERE via os._exit(137) — no
        exception, no cleanup, no flush. ``after``/``count``/
        ``probability`` apply as usual, so a harness can let N disks
        commit before the kill lands mid-fan-out. With no plan loaded
        this is a single attribute read (the hook sits on the PUT
        commit path)."""
        if not self.enabled:
            return
        with self._mu:
            if name in self._crash_points:
                self._crash_points[name] += 1
        if self._collect(("crash",), name):
            with self._mu:
                self._crash_fired[name] = \
                    self._crash_fired.get(name, 0) + 1
            # Best-effort breadcrumb; os._exit will NOT flush it, and
            # that is correct — a real power cut doesn't either.
            try:
                from ..logger import Logger
                Logger.get().info(
                    f"faultinject: crash point {name} fired — "
                    f"exiting {self.CRASH_EXIT_CODE}", "faultinject")
            except Exception:
                pass
            self._exit(self.CRASH_EXIT_CODE)


# The process-wide injector every hook point shares.
FAULTS = FaultInjector()
