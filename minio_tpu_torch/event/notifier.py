"""NotificationSys: routes fired events to subscribed targets.

Ref cmd/notification.go:48 (NotificationSys), cmd/event-notification.go
(EventNotifier.Send: look up the bucket's rules map, fan out to matching
targets). Delivery is async — the S3 handler never blocks on a sink.

The port's own copy of ``minio_tpu/event/notifier.py``, with no change in
behaviour.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

from .event import Event
from .rules import RulesMap, parse_notification_xml
from .targets import Target


class NotificationSys:
    def __init__(self, bucket_meta=None, region: str = "us-east-1"):
        self.bucket_meta = bucket_meta
        self.region = region
        self.targets: dict[str, Target] = {}
        self._mu = threading.RLock()
        self._pool = ThreadPoolExecutor(max_workers=4,
                                        thread_name_prefix="event-send")
        # Tests / callers may inject per-bucket rules directly instead of
        # going through bucket metadata XML.
        self._static_rules: dict[str, RulesMap] = {}
        # Parsed-rules cache keyed by the raw XML (the hot path must not
        # re-parse the notification config on every fired event).
        self._parsed: dict[str, tuple[str, RulesMap]] = {}

    def register_target(self, target: Target) -> None:
        with self._mu:
            self.targets[target.arn()] = target

    def remove_target(self, arn: str) -> None:
        with self._mu:
            t = self.targets.pop(arn, None)
        if t:
            t.close()

    def target_arns(self) -> list[str]:
        with self._mu:
            return list(self.targets)

    def rules_for(self, bucket: str) -> RulesMap:
        if bucket in self._static_rules:
            return self._static_rules[bucket]
        if self.bucket_meta is None:
            return RulesMap()
        raw = self.bucket_meta.get(bucket).notification_xml
        with self._mu:
            hit = self._parsed.get(bucket)
            if hit and hit[0] == raw:
                return hit[1]
        rules = parse_notification_xml(raw)
        with self._mu:
            self._parsed[bucket] = (raw, rules)
        return rules

    def set_rules(self, bucket: str, rules: RulesMap) -> None:
        self._static_rules[bucket] = rules

    def send(self, event: Event) -> None:
        """Fan out asynchronously to every matching target
        (ref EventNotifier.Send)."""
        rules = self.rules_for(event.bucket)
        if not rules:
            return
        arns = rules.match(event.event_name, event.key)
        if not arns:
            return
        event.region = event.region or self.region
        record = {"EventName": event.event_name,
                  "Key": f"{event.bucket}/{event.key}",
                  "Records": [event.to_record()]}
        with self._mu:
            targets = [self.targets[a] for a in arns if a in self.targets]
        for t in targets:
            # mtpu-lint: disable=R1 -- post-response fan-out: delivery must not be canceled by the finished request's burnt budget
            self._pool.submit(self._send_one, t, record)

    @staticmethod
    def _send_one(target: Target, record: dict) -> None:
        try:
            target.send(record)
        except Exception:
            pass  # target-level retry (queue store) owns persistence

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._mu:
            for t in self.targets.values():
                t.close()
