"""Incident bundles: when an alert fires, freeze the evidence.

Every observability plane in this stack is a bounded RING — traces
(256), slowlog (128), timeline (15 min), console log — which is the
right cost discipline for steady state and exactly wrong for
diagnosis: by the time a human looks at a 3am page, the rings have
rotated the incident out.  This module closes that gap: the watchdog's
pending->firing transition calls :meth:`IncidentRecorder.capture`,
which snapshots everything a diagnosis needs INTO a bundle that
survives the rings' retention:

  - the surrounding timeline window (per-class rates, backend states,
    drive census, worst-request/kernel trace exemplars);
  - the matching slowlog entries (span trees stripped; blame + QoS
    data kept) plus the WORST request's full span tree;
  - the drive-health snapshot, MRF census, kernel backend states;
  - the active fault-injection plan (an injected incident says so);
  - the effective config (webhook/secret tokens redacted) and the
    full alert census at capture time.

Bundles live in a size-bounded ring (count- and byte-capped — an
incident storm must not become its own memory incident) and are
served by admin ``/incidents`` (root-only, so drive endpoints and
config stay un-redacted except for credentials): list for the index,
``?id=`` for one full JSON bundle.

The port's own copy of ``minio_tpu/obs/incidents.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

# Ring bounds: at most MAX_BUNDLES bundles, each at most MAX_BYTES of
# JSON (oversize bundles drop their heaviest sections, biggest first).
MAX_BUNDLES = 16
MAX_BYTES = 512 * 1024
TIMELINE_SAMPLES = 180
SLOWLOG_ENTRIES = 20


def _redact_config(doc: dict) -> dict:
    """Copy of a config dump with credential-bearing values masked
    (key name contains token/secret/password); the bundle must be
    shareable with a vendor/ticket without leaking webhook creds."""
    out: dict = {}
    for sub, targets in doc.items():
        out[sub] = {}
        for tgt, kvs in targets.items():
            out[sub][tgt] = {
                k: ("REDACTED" if v and any(
                    w in k for w in ("token", "secret", "password"))
                    else v)
                for k, v in kvs.items()}
    return out


class IncidentRecorder:
    """Process-wide bundle ring (singleton ``INCIDENTS``)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=MAX_BUNDLES)
        # Extra context sources the server wires in at start():
        #   "config" -> effective (already-redacted) config dump
        #   "mrf"    -> MRF heal-queue census
        self.providers: dict[str, object] = {}
        self.captured_total = 0

    # -- capture -------------------------------------------------------

    def capture(self, transition: dict) -> dict:
        """Freeze one bundle for a firing alert (called by the
        watchdog OUTSIDE its engine lock).  Collection is best-effort
        per section: one broken source costs its section, never the
        bundle."""
        bundle: dict = {
            "id": transition.get("alertId")
            or f"incident-{int(time.time() * 1000)}",
            "rule": transition.get("rule", ""),
            "cause": transition.get("cause", ""),
            "value": transition.get("value", 0.0),
            "capturedAt": time.time(),
        }

        def section(name: str, build) -> None:
            try:
                bundle[name] = build()
            except Exception as e:  # noqa: BLE001 - best-effort evidence
                bundle.setdefault("errors", {})[name] = repr(e)

        def timeline_window() -> dict:
            from .timeline import TIMELINE
            return {"periodS": TIMELINE.period_s,
                    "samples": TIMELINE.samples(n=TIMELINE_SAMPLES)}

        def slowlog_tail() -> list[dict]:
            # Span trees stripped here — the worst one rides whole in
            # its own section; 20 full trees would blow the byte cap.
            from .slowlog import SLOWLOG
            return [{k: v for k, v in e.items() if k != "spans"}
                    for e in SLOWLOG.entries(n=SLOWLOG_ENTRIES)]

        def worst_trace() -> dict | None:
            from .slowlog import SLOWLOG
            worst = None
            for e in SLOWLOG.entries(n=SLOWLOG_ENTRIES):
                if "spans" in e and (
                        worst is None
                        or e["durationMs"] > worst["durationMs"]):
                    worst = e
            if worst is None:
                return None
            return {"requestID": worst.get("requestID", ""),
                    "durationMs": worst.get("durationMs", 0),
                    "blamedLayer": worst.get("blamedLayer", ""),
                    "spans": worst["spans"]}

        def drive_census() -> dict:
            from .drivemon import DRIVEMON
            return DRIVEMON.snapshot()

        def backend_states() -> dict:
            from .kernprof import KERNPROF
            return KERNPROF.snapshot()

        def fault_plan() -> dict:
            from ..faultinject import FAULTS
            return FAULTS.snapshot()

        def alert_census() -> dict:
            from .watchdog import WATCHDOG
            return WATCHDOG.snapshot()

        def loop_census() -> dict:
            # Event-loop health at capture time: per-loop lag/census
            # plus the stall flight-recorder ring — for a loop_stall
            # firing this is the evidence (the frozen stack captures
            # naming the frame that held the loop).
            from .loopmon import LOOPMON
            return LOOPMON.snapshot()

        def usage_census() -> dict:
            # The attribution snapshot at capture time: WHO was the
            # traffic when the alert fired — the noisy_neighbor rule's
            # evidence, and the first question for any brownout.
            from .usage import USAGE
            return USAGE.snapshot()

        section("timeline", timeline_window)
        section("slowlog", slowlog_tail)
        section("worstTrace", worst_trace)
        section("drives", drive_census)
        section("kernelBackends", backend_states)
        section("faultPlan", fault_plan)
        section("alerts", alert_census)
        section("usage", usage_census)
        section("loops", loop_census)
        for name, provider in list(self.providers.items()):
            section(name, provider)
        if isinstance(bundle.get("config"), dict):
            # Defense in depth: the server's provider already redacts,
            # but a bundle must never ship credentials even if a
            # future provider forgets.
            try:
                bundle["config"] = _redact_config(bundle["config"])
            except Exception as e:  # noqa: BLE001 - never ship un-redacted
                del bundle["config"]
                bundle.setdefault("errors", {})["config"] = repr(e)
        bundle["bytes"] = self._bound(bundle)
        with self._mu:
            self._ring.append(bundle)
            self.captured_total += 1
        from .metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_incidents_total",
                     {"rule": bundle["rule"]})
        return bundle

    @staticmethod
    def _bound(bundle: dict) -> int:
        """Enforce the per-bundle byte cap by dropping the heaviest
        sections first, recording what was dropped — a truncated
        bundle must SAY it is truncated, not silently read complete.
        Returns the bundle's serialized size (stored so the index
        never re-serializes the ring to report byte counts)."""
        size = len(json.dumps(bundle, default=str))
        for drop in ("worstTrace", "slowlog", "timeline", "usage",
                     "loops", "config"):
            if size <= MAX_BYTES:
                return size
            if drop in bundle:
                del bundle[drop]
                bundle.setdefault("truncated", []).append(drop)
                size = len(json.dumps(bundle, default=str))
        if size > MAX_BYTES:
            # Still oversize with every droppable section gone (a
            # pathological drive/alert census): keep only the headline
            # — the cap is a MEMORY bound, not a suggestion.
            keep = ("id", "rule", "cause", "value", "capturedAt",
                    "truncated", "errors")
            extra = [k for k in bundle if k not in keep]
            for k in extra:
                del bundle[k]
            bundle.setdefault("truncated", []).extend(sorted(extra))
            size = len(json.dumps(bundle, default=str))
        return size

    # -- reads ---------------------------------------------------------

    def list(self) -> list[dict]:
        """Newest-last index of captured bundles (id + headline)."""
        with self._mu:
            items = list(self._ring)
        # ``bundleId`` duplicates ``id`` on purpose: it is the JOIN
        # KEY the watchdog webhook payloads carry, so an external
        # pager can match a notification to its bundle field-for-field.
        return [{"id": b["id"], "bundleId": b["id"], "rule": b["rule"],
                 "cause": b["cause"], "capturedAt": b["capturedAt"],
                 "bytes": b.get("bytes", 0)}
                for b in items]

    def get(self, incident_id: str) -> dict:
        with self._mu:
            for b in self._ring:
                if b["id"] == incident_id:
                    return b
        raise KeyError(incident_id)

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()
            self.captured_total = 0


# The process-wide recorder the watchdog captures into.
INCIDENTS = IncidentRecorder()
