"""Bucket lifecycle (ILM) rules engine.

Ref pkg/bucket/lifecycle/lifecycle.go (Lifecycle.ComputeAction),
rule.go, expiration.go, noncurrentversion.go. Parses the bucket's
<LifecycleConfiguration> XML and decides, per object version, whether
it should expire now. Transition-to-tier is parsed but reported as
unsupported (no remote tiers configured in this build).

The port's own copy of ``minio_tpu/bucket/lifecycle.py``, with no change in
behaviour.
"""

from __future__ import annotations

import time
import urllib.parse
from dataclasses import dataclass, field

from ..s3.xmlutil import parse

# Actions (ref lifecycle.go Action enum).
NONE = "none"
DELETE = "delete"                  # expire current version
DELETE_VERSION = "delete-version"  # expire a noncurrent version
DELETE_MARKER = "delete-marker"    # remove an expired delete marker
TRANSITION = "transition"          # move current version to a tier

_DAY = 24 * 3600.0


@dataclass
class Rule:
    rule_id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    tags: dict = field(default_factory=dict)
    expiration_days: int = 0
    expiration_date: float = 0.0
    expired_object_delete_marker: bool = False
    noncurrent_days: int = 0
    transition_days: int = 0
    transition_date: float = 0.0
    transition_tier: str = ""      # <Transition><StorageClass>

    def enabled(self) -> bool:
        return self.status == "Enabled"

    def matches(self, name: str, tags: dict) -> bool:
        if self.prefix and not name.startswith(self.prefix):
            return False
        for k, v in self.tags.items():
            if tags.get(k) != v:
                return False
        return True


def _parse_date(text: str) -> float:
    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%M:%S.000Z",
                "%Y-%m-%d"):
        try:
            return time.mktime(time.strptime(text, fmt)) - time.timezone
        except ValueError:
            continue
    raise ValueError(f"bad lifecycle date: {text}")


def parse_tags(raw: str) -> dict:
    """'a=1&b=2' url-encoded tag string -> dict (the xl.meta
    x-amz-tagging form)."""
    out = {}
    for pair in raw.split("&") if raw else []:
        k, _, v = pair.partition("=")
        out[urllib.parse.unquote_plus(k)] = urllib.parse.unquote_plus(v)
    return out


class Lifecycle:
    def __init__(self, rules: list[Rule]):
        self.rules = rules

    def __bool__(self) -> bool:
        return bool(self.rules)

    @classmethod
    def parse(cls, raw: str | bytes) -> "Lifecycle":
        if not raw:
            return cls([])
        doc = parse(raw.encode() if isinstance(raw, str) else raw)
        rules: list[Rule] = []
        for r in doc.findall("Rule"):
            rule = Rule(rule_id=r.findtext("ID") or "",
                        status=r.findtext("Status") or "Enabled")
            # Filter: bare <Prefix>, <Filter><Prefix>, or <Filter><And>.
            rule.prefix = r.findtext("Prefix") or ""
            filt = r.find("Filter")
            if filt is not None:
                rule.prefix = filt.findtext("Prefix") or rule.prefix
                and_el = filt.find("And")
                tag_els = filt.findall("Tag")
                if and_el is not None:
                    rule.prefix = (and_el.findtext("Prefix")
                                   or rule.prefix)
                    tag_els = and_el.findall("Tag")
                for t in tag_els:
                    rule.tags[t.findtext("Key") or ""] = \
                        t.findtext("Value") or ""
            exp = r.find("Expiration")
            if exp is not None:
                if exp.findtext("Days"):
                    rule.expiration_days = int(exp.findtext("Days"))
                if exp.findtext("Date"):
                    rule.expiration_date = _parse_date(
                        exp.findtext("Date"))
                if exp.findtext("ExpiredObjectDeleteMarker") == "true":
                    rule.expired_object_delete_marker = True
            tr = r.find("Transition")
            if tr is not None:
                if tr.findtext("Days"):
                    rule.transition_days = int(tr.findtext("Days"))
                if tr.findtext("Date"):
                    rule.transition_date = _parse_date(
                        tr.findtext("Date"))
                rule.transition_tier = (
                    tr.findtext("StorageClass") or "").upper()
            nce = r.find("NoncurrentVersionExpiration")
            if nce is not None and nce.findtext("NoncurrentDays"):
                rule.noncurrent_days = int(
                    nce.findtext("NoncurrentDays"))
            rules.append(rule)
        return cls(rules)

    def compute_action(self, name: str, mod_time: float,
                       is_latest: bool = True,
                       delete_marker: bool = False,
                       tags: dict | None = None,
                       sole_version: bool = True,
                       now: float | None = None) -> str:
        return self.compute_with_tier(
            name, mod_time, is_latest=is_latest,
            delete_marker=delete_marker, tags=tags,
            sole_version=sole_version, now=now)[0]

    def compute_with_tier(self, name: str, mod_time: float,
                          is_latest: bool = True,
                          delete_marker: bool = False,
                          tags: dict | None = None,
                          sole_version: bool = True,
                          now: float | None = None,
                          ) -> tuple[str, str]:
        """Decide this version's fate (ref Lifecycle.ComputeAction).
        mod_time for a noncurrent version is WHEN IT BECAME noncurrent
        in the reference (successor mod-time); the caller passes the
        successor's mod_time for noncurrent versions."""
        now = time.time() if now is None else now
        tags = tags or {}
        for rule in self.rules:
            if not rule.enabled() or not rule.matches(name, tags):
                continue
            if not is_latest:
                if rule.noncurrent_days and \
                        now >= mod_time + rule.noncurrent_days * _DAY:
                    return DELETE_VERSION, ""
                continue
            if delete_marker:
                # A delete marker with no remaining data versions is
                # removable once flagged (ref ExpiredObjectDeleteMarker).
                if rule.expired_object_delete_marker and sole_version:
                    return DELETE_MARKER, ""
                continue
            if rule.expiration_date and now >= rule.expiration_date:
                return DELETE, ""
            if rule.expiration_days and \
                    now >= mod_time + rule.expiration_days * _DAY:
                return DELETE, ""
            if rule.transition_tier:
                due = ((rule.transition_date
                        and now >= rule.transition_date)
                       or (rule.transition_days
                           and now >= mod_time
                           + rule.transition_days * _DAY)
                       or (not rule.transition_days
                           and not rule.transition_date))
                if due:
                    return TRANSITION, rule.transition_tier
        return NONE, ""
