"""Notification config: XML parsing + event routing rules.

Ref pkg/event/config.go (Config/Queue structs, filter-rule validation)
and pkg/event/rules.go (RulesMap: event-name -> pattern -> target-ID
set). A bucket's <NotificationConfiguration> maps (event, key) pairs to
target ARNs; patterns come from prefix/suffix FilterRules.

The port's own copy of ``minio_tpu/event/rules.py``, with no change in
behaviour.
"""

from __future__ import annotations

from ..s3.xmlutil import parse
from .event import expand_event_name


def _pattern(prefix: str, suffix: str) -> str:
    """prefix+suffix -> one wildcard pattern (ref pkg/event/rules.go
    NewPattern: 'p*' + '*s' joined with a single star)."""
    pat = ""
    if prefix:
        pat = prefix if prefix.endswith("*") else prefix + "*"
    if suffix:
        s = suffix if suffix.startswith("*") else "*" + suffix
        pat = pat + s if pat else s
    if not pat:
        pat = "*"
    return pat.replace("**", "*")


def _match_simple(pattern: str, text: str) -> bool:
    """Wildcard match with '*' only (ref pkg/wildcard MatchSimple)."""
    parts = pattern.split("*")
    if len(parts) == 1:
        return pattern == text
    if not text.startswith(parts[0]) or not text.endswith(parts[-1]):
        return False
    pos = len(parts[0])
    for part in parts[1:-1]:
        if not part:
            continue
        idx = text.find(part, pos)
        if idx < 0:
            return False
        pos = idx + len(part)
    return pos <= len(text) - len(parts[-1])


class RulesMap:
    """event-name -> [(pattern, arn)] (ref pkg/event/rules.go)."""

    def __init__(self):
        self.rules: dict[str, list[tuple[str, str]]] = {}

    def add(self, event_names: list[str], pattern: str, arn: str) -> None:
        for name in event_names:
            for concrete in expand_event_name(name):
                self.rules.setdefault(concrete, []).append((pattern, arn))

    def match(self, event_name: str, key: str) -> set[str]:
        """Target ARNs subscribed to (event, key)."""
        out: set[str] = set()
        for pattern, arn in self.rules.get(event_name, []):
            if _match_simple(pattern, key):
                out.add(arn)
        return out

    def __bool__(self) -> bool:
        return bool(self.rules)


def parse_notification_xml(raw: str) -> RulesMap:
    """<NotificationConfiguration> -> RulesMap. Supports Queue/Topic/
    CloudFunction configurations uniformly (all route by ARN; ref
    pkg/event/config.go Config.ToRulesMap)."""
    rules = RulesMap()
    if not raw:
        return rules
    doc = parse(raw.encode() if isinstance(raw, str) else raw)
    for tag, arn_tag in (("QueueConfiguration", "Queue"),
                        ("TopicConfiguration", "Topic"),
                        ("CloudFunctionConfiguration", "CloudFunction")):
        for qc in doc.findall(tag):
            arn = qc.findtext(arn_tag) or ""
            events = [e.text or "" for e in qc.findall("Event")]
            prefix = suffix = ""
            filt = qc.find("Filter")
            if filt is not None:
                s3key = filt.find("S3Key")
                if s3key is not None:
                    for fr in s3key.findall("FilterRule"):
                        name = (fr.findtext("Name") or "").lower()
                        value = fr.findtext("Value") or ""
                        if name == "prefix":
                            prefix = value
                        elif name == "suffix":
                            suffix = value
            if arn and events:
                rules.add(events, _pattern(prefix, suffix), arn)
    return rules
