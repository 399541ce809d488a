"""Runtime fault injection at the kernel-dispatch boundary: a seeded,
deterministic fault-plan engine every probe and kernel-lane dispatch
consults (``FAULTS.kernel(name)``):

    plan = {"seed": 7, "rules": [
        {"kind": "kernel", "target": "rs_encode"},
        {"kind": "kernel", "target": "", "probability": 0.5},
    ]}

Rule fields: ``kind`` (required), ``target`` (substring matched against
the kernel name; empty matches all), ``op`` (kept for the plan format;
a kernel hook matches every op), ``latency_ms``, ``probability``
(default 1.0), ``after`` (skip the first N matching occurrences),
``count`` (fire at most N times; 0 = unlimited).

Determinism: whether occurrence ``n`` of a rule fires is a pure
function of (seed, rule index, n) -- a SHA-256-derived fraction compared
against ``probability`` -- so the same plan over the same dispatch
sequence always injects the same faults.

The port's own copy of the kernel hook of
``minio_tpu/faultinject/__init__.py``, with no change in its behaviour.
The reference's drive, peer, event-loop and crash-point hooks come with
the erasure engine that calls them; until then a plan naming their
kinds is refused rather than silently ignored.
"""

from __future__ import annotations

import hashlib
import threading
import time

KINDS = ("kernel",)


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


class FaultInjector:
    """Process-wide fault-plan engine (singleton ``FAULTS``).

    Hot-path discipline: with no plan loaded the hook is a single
    attribute read (``self.enabled``); with a plan loaded, decisions
    are computed under the lock but RAISES happen outside it."""

    def __init__(self):
        self.enabled = False
        self._mu = threading.Lock()
        self._rules: list[_Rule] = []
        self._seed = 0
        self._loaded_at = 0.0

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

    def snapshot(self) -> dict:
        with self._mu:
            return {"active": self.enabled, "seed": self._seed,
                    "loadedAt": self._loaded_at,
                    "rules": [r.to_dict() for r in self._rules]}

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

    def _collect(self, target: str) -> list[_Rule]:
        """Fired rules matching target."""
        with self._mu:
            return [r for r in self._rules
                    if (not r.target or r.target in target)
                    and self._fires(r)]

    # -- hooks ---------------------------------------------------------

    def kernel(self, name: str) -> None:
        """Kernel-dispatch failure: raises inside the kernel-lane
        dispatch's try-block -- the CPU lane then fails over to the host
        lanes, a card's dispatch raises to its caller."""
        if not self.enabled:
            return
        if self._collect(name):
            raise InjectedFault(f"injected kernel-dispatch fault: {name}")


# The process-wide injector every hook point shares.
FAULTS = FaultInjector()
