"""Structured logging and the console ring (ref cmd/logger/); the audit
webhook comes with the HTTP front end that feeds it."""

from .logger import ConsoleLogRing, LogEntry, Logger  # noqa: F401
