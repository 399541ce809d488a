"""Object lock (WORM): bucket config, per-version retention + legal
hold, and delete/overwrite enforcement.

Mirrors the reference's object-lock semantics (ref
pkg/bucket/object/lock/lock.go: ParseObjectLockConfig,
GetObjectRetentionMeta:~, enforcement in cmd/object-handlers.go
checkRequestAuthType + enforceRetentionForDeletion,
cmd/erasure-object.go DeleteObject guards): retention rides in object
metadata (`x-amz-object-lock-mode`, `x-amz-object-lock-retain-until-date`,
`x-amz-object-lock-legal-hold`), bucket defaults come from
<ObjectLockConfiguration><Rule><DefaultRetention>, COMPLIANCE versions
are immutable until expiry, GOVERNANCE deletions need the bypass header
plus the s3:BypassGovernanceRetention grant.

The port's own copy of ``minio_tpu/bucket/objectlock.py``, with no change in
behaviour.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..s3.xmlutil import parse

GOVERNANCE = "GOVERNANCE"
COMPLIANCE = "COMPLIANCE"

META_MODE = "x-amz-object-lock-mode"
META_RETAIN_UNTIL = "x-amz-object-lock-retain-until-date"
META_LEGAL_HOLD = "x-amz-object-lock-legal-hold"

H_BYPASS_GOVERNANCE = "x-amz-bypass-governance-retention"

ENABLED_XML = ("<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
               "</ObjectLockEnabled></ObjectLockConfiguration>")

def parse_iso8601(s: str) -> float:
    """UTC ISO8601, fractional seconds tolerated and ignored."""
    import calendar
    s = s.strip()
    if "." in s:
        s = s.split(".")[0] + "Z"
    return calendar.timegm(time.strptime(s, "%Y-%m-%dT%H:%M:%SZ"))


def iso8601(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


class ObjectLockError(Exception):
    pass


class PastRetainDate(ObjectLockError):
    """Retain-until date not in the future."""


class BadLockDate(ObjectLockError):
    """Unparseable retain-until date."""


@dataclass
class DefaultRetention:
    mode: str = ""
    days: int = 0
    years: int = 0

    @property
    def seconds(self) -> float:
        return self.days * 86400 + self.years * 365 * 86400


@dataclass
class ObjectLockConfig:
    """Parsed <ObjectLockConfiguration> (ref ParseObjectLockConfig,
    pkg/bucket/object/lock/lock.go)."""
    enabled: bool = False
    default: DefaultRetention | None = None

    @classmethod
    def from_xml(cls, raw: str | bytes) -> "ObjectLockConfig":
        if not raw:
            return cls()
        doc = parse(raw if isinstance(raw, bytes) else raw.encode())
        cfg = cls(enabled=(doc.findtext("ObjectLockEnabled") == "Enabled"))
        rule = doc.find("Rule")
        if rule is not None:
            dr = rule.find("DefaultRetention")
            if dr is not None:
                mode = dr.findtext("Mode") or ""
                if mode not in (GOVERNANCE, COMPLIANCE):
                    raise ObjectLockError(f"bad default mode: {mode!r}")
                days = int(dr.findtext("Days") or "0")
                years = int(dr.findtext("Years") or "0")
                if (days > 0) == (years > 0):  # exactly one required
                    raise ObjectLockError("need exactly one of Days/Years")
                cfg.default = DefaultRetention(mode, days, years)
        return cfg


def parse_retention_xml(raw: bytes) -> tuple[str, float]:
    """<Retention><Mode/><RetainUntilDate/></Retention> -> (mode, ts)."""
    doc = parse(raw)
    mode = doc.findtext("Mode") or ""
    if mode not in (GOVERNANCE, COMPLIANCE):
        raise ObjectLockError(f"bad mode: {mode!r}")
    date = doc.findtext("RetainUntilDate") or ""
    return mode, parse_iso8601(date)


def parse_legal_hold_xml(raw: bytes) -> str:
    doc = parse(raw)
    status = doc.findtext("Status") or ""
    if status not in ("ON", "OFF"):
        raise ObjectLockError(f"bad legal hold status: {status!r}")
    return status


def apply_put_headers(headers: dict, config: ObjectLockConfig,
                      meta: dict, now: float | None = None) -> None:
    """Stamp lock metadata on a new object from the PUT's lock headers,
    falling back to the bucket's default retention (ref
    getObjectRetentionMeta + default-retention fill in PutObjectHandler,
    cmd/object-handlers.go)."""
    now = time.time() if now is None else now
    mode = headers.get(META_MODE, "")
    until = headers.get(META_RETAIN_UNTIL, "")
    hold = headers.get(META_LEGAL_HOLD, "")
    if mode or until:
        if mode not in (GOVERNANCE, COMPLIANCE) or not until:
            raise ObjectLockError("retention needs both a valid mode "
                                  "and a retain-until date")
        try:
            ts = parse_iso8601(until)
        except ValueError:
            raise BadLockDate(until)
        if ts <= now:
            raise PastRetainDate(until)
        meta[META_MODE] = mode
        meta[META_RETAIN_UNTIL] = iso8601(ts)
    elif config.enabled and config.default is not None:
        meta[META_MODE] = config.default.mode
        meta[META_RETAIN_UNTIL] = iso8601(now + config.default.seconds)
    if hold:
        if hold not in ("ON", "OFF"):
            raise ObjectLockError(f"bad legal hold: {hold!r}")
        meta[META_LEGAL_HOLD] = hold


def retention_active(meta: dict, now: float | None = None) -> str:
    """Returns the active retention mode ("" when expired/absent)."""
    now = time.time() if now is None else now
    mode = meta.get(META_MODE, "")
    until = meta.get(META_RETAIN_UNTIL, "")
    if not mode or not until:
        return ""
    try:
        return mode if parse_iso8601(until) > now else ""
    except ValueError:
        return ""


def check_version_delete(meta: dict, bypass_governance: bool,
                         now: float | None = None) -> None:
    """Raise ObjectLockError when deleting THIS version is forbidden
    (ref enforceRetentionBypassForDelete, cmd/bucket-object-lock.go).
    Plain (marker-writing) deletes never call this — only versioned
    deletes destroy data."""
    if meta.get(META_LEGAL_HOLD) == "ON":
        raise ObjectLockError("object is under legal hold")
    mode = retention_active(meta, now)
    if mode == COMPLIANCE:
        raise ObjectLockError("object is WORM protected (COMPLIANCE)")
    if mode == GOVERNANCE and not bypass_governance:
        raise ObjectLockError("object is WORM protected (GOVERNANCE); "
                              "bypass not granted")


def check_retention_update(old_meta: dict, new_mode: str, new_until: float,
                           bypass_governance: bool,
                           now: float | None = None) -> None:
    """A COMPLIANCE lock can only be extended, never shortened or
    re-moded; GOVERNANCE changes need bypass (ref
    enforceRetentionBypassForPut)."""
    mode = retention_active(old_meta, now)
    if not mode:
        return
    old_until = parse_iso8601(old_meta[META_RETAIN_UNTIL])
    if mode == COMPLIANCE:
        if new_mode != COMPLIANCE or new_until < old_until:
            raise ObjectLockError("COMPLIANCE retention cannot be "
                                  "shortened or downgraded")
    elif mode == GOVERNANCE and not bypass_governance:
        # Pure extension (same mode, later date) is always allowed;
        # only shortening/downgrading is privileged.
        if new_mode != GOVERNANCE or new_until < old_until:
            raise ObjectLockError("shortening GOVERNANCE retention "
                                  "requires bypass")
