"""Structured logger with console ring buffer (ref cmd/logger/logger.go,
cmd/consolelogger.go — the ring feeds `mc admin console`).

Opt-in JSON mode (`MINIO_LOG_JSON=1` or config-KV ``logger json=on``):
every console line becomes one JSON object, and callers may attach
structured join-key fields (``Logger.warn(msg, src, alert_id=...,
rule=...)``) — the same way PR-4 audit entries carry ``trace_id`` —
so alert/transition/quarantine lines are machine-parseable instead of
regex fodder.  In text mode the fields render as a trailing
``[k=v ...]`` suffix; the ring keeps them structured either way.

The port's own copy of ``minio_tpu/logger/logger.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field


@dataclass
class LogEntry:
    level: str = "INFO"
    time: float = 0.0
    message: str = ""
    source: str = ""
    trace: list = field(default_factory=list)
    # Structured join keys (alert_id, rule, ...): first-class in the
    # JSON output, suffix-rendered in text mode.
    fields: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))


class ConsoleLogRing:
    """Last-N log entries, served to `admin console-log` (ref
    cmd/consolelogger.go HTTPConsoleLoggerSys ring)."""

    def __init__(self, size: int = 10_000):
        self._mu = threading.Lock()
        self._ring: deque[LogEntry] = deque(maxlen=size)

    def add(self, entry: LogEntry) -> None:
        with self._mu:
            self._ring.append(entry)

    def tail(self, n: int = 100) -> list[LogEntry]:
        if n <= 0:
            return []
        with self._mu:
            items = list(self._ring)
        return items[-n:]


def _env_json(env=os.environ) -> bool:
    return env.get("MINIO_LOG_JSON", "").lower() in ("1", "on", "true",
                                                     "yes")


class Logger:
    """Process-wide logger: console stderr + ring; one-time dedup of
    repeated messages (ref cmd/logger/logonce.go)."""

    _instance = None
    _instance_mu = threading.Lock()

    def __init__(self, json_output: bool | None = None):
        self.ring = ConsoleLogRing()
        # None = consult the env (MINIO_LOG_JSON); config-KV `logger
        # json` may flip this live via the server's apply hook, but
        # the env spelling wins there too (env-first rule).
        self.json_output = _env_json() if json_output is None \
            else json_output
        self._once_seen: set[str] = set()
        self._mu = threading.Lock()

    @classmethod
    def get(cls) -> "Logger":
        with cls._instance_mu:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _emit(self, level: str, message: str, source: str = "",
              **fields) -> None:
        entry = LogEntry(level=level, time=time.time(), message=message,
                         source=source, fields=dict(fields))
        self.ring.add(entry)
        if self.json_output:
            print(entry.to_json(), file=sys.stderr)
        else:
            ts = time.strftime("%H:%M:%S", time.localtime(entry.time))
            suffix = ""
            if fields:
                kv = " ".join(f"{k}={v}" for k, v in
                              sorted(fields.items()))
                suffix = f"  [{kv}]"
            print(f"{ts} {level:<5} {message}{suffix}", file=sys.stderr)

    def info(self, message: str, source: str = "", **fields) -> None:
        self._emit("INFO", message, source, **fields)

    def error(self, message: str, source: str = "", **fields) -> None:
        self._emit("ERROR", message, source, **fields)

    def warn(self, message: str, source: str = "", **fields) -> None:
        self._emit("WARN", message, source, **fields)

    def log_once(self, message: str, source: str = "") -> None:
        """Errors that would repeat per-request are logged once (ref
        logger.LogOnceIf)."""
        with self._mu:
            if message in self._once_seen:
                return
            if len(self._once_seen) > 4096:
                self._once_seen.clear()
            self._once_seen.add(message)
        self._emit("ERROR", message, source)
