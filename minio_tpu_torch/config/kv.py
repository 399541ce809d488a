"""Subsystem=KV configuration system (ref cmd/config/config.go:202-273
`Config`/`KVS`, RegisterDefaultKVS:178, SetKVS:636; persistence in
`.minio.sys/config/config.json` via cmd/config-current.go; history +
rollback via the admin `config-history` APIs).

Model: config[subsystem][target] = {key: value}; target "_" is the
default. Environment wins over stored config (`MINIO_<SUBSYS>_<KEY>`,
the reference's env-first rule). Every successful change snapshots the
previous document into `config/history/<ulid>.json` for rollback.

The port's own copy of ``minio_tpu/config/kv.py``, with no change in behaviour.
"""

from __future__ import annotations

import copy
import os
import threading
import time
import uuid

DEFAULT_TARGET = "_"

CONFIG_PATH = "config/config.json"
HISTORY_PREFIX = "config/history"
MAX_HISTORY = 10

# Default KVS per subsystem (ref RegisterDefaultKVS callers across
# cmd/config-current.go). Only subsystems this framework actually
# consumes are registered; unknown subsystems are rejected like the
# reference's `Errorf("unknown sub-system")`.
DEFAULT_KVS: dict[str, dict[str, str]] = {
    "api": {
        "requests_max": "0",
        "requests_deadline": "10s",
        # QoS per-class admission caps (0 = unlimited); the global
        # requests_max still bounds the sum (minio_tpu/qos/admission.py).
        "requests_max_read": "0",
        "requests_max_write": "0",
        "requests_max_list": "0",
        "requests_max_admin": "0",
        # SelectObjectContent runs as its OWN admission class: a
        # capped analytics sweep sheds 503 SlowDown instead of
        # competing with PUT/GET for slots (scan kernel dispatches
        # additionally ride the background QoS lane).
        "requests_max_select": "0",
        "cors_allow_origin": "*",
    },
    "compression": {
        "enable": "off",
        "extensions": ".txt,.log,.csv,.json,.tar,.xml,.bin",
        "mime_types": "text/*,application/json,application/xml",
    },
    "scanner": {
        "delay": "10",
        "max_wait": "15s",
    },
    "heal": {
        "bitrotscan": "off",
        "max_sleep": "1s",
        "max_io": "10",
    },
    "storage_class": {
        "standard": "",
        "rrs": "EC:2",
        # Comma-separated buckets whose PUTs default to the REGEN
        # (regenerating-code) class; live-reloadable.
        "regen_buckets": "",
    },
    "region": {
        "name": "us-east-1",
    },
    "logger_webhook": {
        "enable": "off",
        "endpoint": "",
        "auth_token": "",
    },
    "audit_webhook": {
        "enable": "off",
        "endpoint": "",
        "auth_token": "",
    },
    # Internal RPC transport knobs (rpc/transport.py): offline_retry
    # is how long a peer stays health-gated after a failure before a
    # reconnect probe (jittered +0-50% per mark so a restarted peer
    # is not thundering-herded by the whole cluster at once).
    "rpc": {
        "offline_retry": "2s",
    },
    # Commit-path durability (storage/xl.py commit_replace): fsync=on
    # routes every commit rename through fsync-file + fsync-parent-dir
    # so a power cut cannot lose an acknowledged write to the page
    # cache. Default off — the reference's fsync-less reliable-rename
    # — because the overhead is real (bench.py crash_recovery measures
    # it paired; docs/robustness.md documents the tradeoff).
    "storage": {
        "fsync": "off",
    },
    # Runtime fault injection (minio_tpu/faultinject): enable=on with
    # a plan (COMPACT JSON — no spaces — or set it via the admin
    # /fault-inject API) loads the deterministic fault plan at apply
    # time; enable=off clears any config-loaded plan.
    "fault_inject": {
        "enable": "off",
        "plan": "",
    },
    # Hot-object serving tier (cache/hotcache.py): a two-level
    # (memory + disk) decoded-object cache in the erasure GET path
    # with single-flight fill and cross-peer invalidation. `dirs` is a
    # comma-separated list of disk-tier directories (ideally one per
    # data drive — placement is drive-health-aware); empty = memory
    # tier only. `revalidate` bounds worst-case staleness after a LOST
    # peer invalidation ("0" = revalidate every memory hit, "off" =
    # trust invalidation alone). Replaces the removed
    # MINIO_CACHE_DRIVES CacheObjectLayer wrapper.
    "cache": {
        "enable": "off",
        "mem_bytes": "134217728",
        "disk_bytes": "1073741824",
        "dirs": "",
        "min_hits": "1",
        "max_object_bytes": "33554432",
        "revalidate": "1s",
    },
    # Codec dispatch autotuner (ops/autotune.py): autotune=off pins
    # the legacy static device-first policy; hysteresis is the
    # challenger-over-incumbent throughput factor a plan flip needs
    # (>= 1.0 — 1.0 flips on any faster sample); probe_on_boot=off
    # skips the boot probe ladder (the plan then builds from live
    # dispatch samples only).
    "codec": {
        "autotune": "on",
        "hysteresis": "1.25",
        "probe_on_boot": "on",
    },
    # Structured logging (logger/logger.py): json=on makes every
    # console line a JSON object with structured fields (alert lines
    # carry alert_id/rule join keys). MINIO_LOG_JSON=1 is the legacy
    # env spelling and wins over config.
    "logger": {
        "json": "off",
    },
    # SLO watchdog (obs/watchdog.py): multi-window burn-rate alerting
    # over the timeline ring plus built-in event rules (drive census,
    # kernel backend down, MRF backlog, cache collapse, counter-reset
    # storms) — default ON. `rules` is a JSON array of user threshold
    # rules over registered metrics2 series (validated before
    # persist); `webhook_endpoint` enables async alert delivery with
    # bounded queue + bounded retry/backoff.
    "alerts": {
        "enable": "on",
        "fast_window": "1m",
        "slow_window": "15m",
        "burn_threshold": "0.10",
        "pending_ticks": "2",
        "resolve_ticks": "3",
        "rules": "",
        "webhook_endpoint": "",
        "webhook_auth_token": "",
    },
    # Tenant/workload attribution (obs/usage.py): per-bucket/per-key
    # exact accounts over fast/slow windows + SpaceSaving top-K
    # sketches per QoS class. `cardinality_cap` bounds the distinct
    # bucket/tenant names tracked (and the usage_* metric labels) —
    # overflow folds into `_other`; `noisy_share`/`noisy_min_requests`
    # tune the watchdog's noisy_neighbor built-in rule.
    "usage": {
        "enable": "on",
        "top_k": "10",
        "cardinality_cap": "64",
        "fast_window": "1m",
        "slow_window": "15m",
        "noisy_share": "0.5",
        "noisy_min_requests": "20",
    },
    # Slow-request capture SLOs (obs/slowlog.py): any request past its
    # class threshold (ms) lands in the slowlog ring with per-layer
    # blame. Per-class keys override the default; empty = inherit;
    # 0 disables the latency trigger (5xx capture stays on).
    "obs": {
        "slow_ms": "1000",
        "slow_ms_read": "",
        "slow_ms_write": "",
        "slow_ms_list": "",
        "slow_ms_admin": "",
        "slow_ms_select": "",
        "profile_on_slow": "off",
        # Timeline sample ring (obs/timeline.py): one sample every
        # `timeline_sample`, kept for `timeline_retention` at fixed
        # memory (the ring is capacity-clamped; see MAX_SAMPLES).
        "timeline_sample": "1s",
        "timeline_retention": "15m",
        # Event-loop health plane (obs/loopmon.py): a heartbeat
        # overdue past `loop_stall_ms` triggers the stall flight
        # recorder (stack capture + watchdog loop_stall rule);
        # `profile_continuous` keeps the ~1% duty-cycle whole-process
        # profiler running (admin /profile).
        "loop_stall_ms": "250",
        "profile_continuous": "on",
    },
}


class UnknownSubsystem(ValueError):
    pass


class UnknownKey(ValueError):
    pass


def parse_kv_line(line: str) -> tuple[str, str, dict[str, str]]:
    """Parse `subsys[:target] key=value key2="v w"` — the `mc admin
    config set` wire format (ref config.Config.SetKVS)."""
    parts = _split_kv(line.strip())
    if not parts:
        raise ValueError("empty config line")
    subsys, _, target = parts[0].partition(":")
    kvs: dict[str, str] = {}
    for item in parts[1:]:
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(f"malformed kv {item!r}")
        kvs[k] = v.strip('"')
    return subsys, target or DEFAULT_TARGET, kvs


def _split_kv(line: str) -> list[str]:
    """Split on spaces, respecting double quotes."""
    out: list[str] = []
    cur = []
    in_q = False
    for ch in line:
        if ch == '"':
            in_q = not in_q
            cur.append(ch)
        elif ch == " " and not in_q:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


class ConfigSys:
    """Stored config + env overrides + history, persisted through the
    quorum ConfigStore (ref globalConfigSys / lookupConfigs). With
    ``store=None`` it is a read-only view of the env and the defaults."""

    def __init__(self, store, env=os.environ):
        self.store = store
        self.env = env
        self._apply_hooks: list = []  # callables(config_sys)
        # callables(subsys, target, kvs) raising ValueError to REJECT a
        # change before it persists (ref per-subsystem validation in
        # lookupConfigs).
        self.validators: list = []
        # Coarse TRANSACTION lock: a config write's in-memory mutation,
        # history snapshot, and quorum persist must stay atomic and
        # ordered end-to-end (two racing writers must never persist out
        # of mutation order), so the critical section deliberately
        # spans disk I/O — declared to the runtime sanitizer, which
        # still watches it for lock-order cycles.
        from ..utils.locktrace import transaction_lock
        self._write_mu = transaction_lock(threading.Lock())
        doc = store.load(CONFIG_PATH) if store is not None else None
        self._config: dict = doc["config"] if doc else {}

    # -- reads ----------------------------------------------------------

    def get(self, subsys: str, key: str,
            target: str = DEFAULT_TARGET) -> str:
        """Env > stored > default (ref env-first lookup order)."""
        if subsys not in DEFAULT_KVS:
            raise UnknownSubsystem(subsys)
        if key not in DEFAULT_KVS[subsys]:
            raise UnknownKey(f"{subsys}/{key}")
        env_key = f"MINIO_{subsys.upper()}_{key.upper()}"
        if env_key in self.env:
            return self.env[env_key]
        stored = self._config.get(subsys, {}).get(target, {})
        if key in stored:
            return stored[key]
        return DEFAULT_KVS[subsys][key]

    def get_subsys(self, subsys: str,
                   target: str = DEFAULT_TARGET) -> dict[str, str]:
        if subsys not in DEFAULT_KVS:
            raise UnknownSubsystem(subsys)
        return {k: self.get(subsys, k, target)
                for k in DEFAULT_KVS[subsys]}

    def dump(self) -> dict:
        """Full effective config, env overrides applied; every stored
        target appears, not just the default."""
        out: dict = {}
        for sub in sorted(DEFAULT_KVS):
            targets = {DEFAULT_TARGET} | set(
                self._config.get(sub, {}))
            out[sub] = {t: self.get_subsys(sub, t)
                        for t in sorted(targets)}
        return out

    # -- writes ---------------------------------------------------------

    def set_kv(self, line: str) -> None:
        subsys, target, kvs = parse_kv_line(line)
        if subsys not in DEFAULT_KVS:
            raise UnknownSubsystem(subsys)
        for k in kvs:
            if k not in DEFAULT_KVS[subsys]:
                raise UnknownKey(f"{subsys}/{k}")
        for validate in self.validators:
            validate(subsys, target, kvs)  # ValueError rejects
        with self._write_mu:
            self._snapshot_history()
            self._config.setdefault(subsys, {}).setdefault(
                target, {}).update(kvs)
            self._persist()
        self._run_hooks()

    def del_kv(self, spec: str) -> None:
        """Reset `subsys[:target]` back to defaults (same addressing
        as set)."""
        subsys, _, target = spec.strip().partition(":")
        target = target or DEFAULT_TARGET
        if subsys not in DEFAULT_KVS:
            raise UnknownSubsystem(subsys)
        if subsys in self._config:
            with self._write_mu:
                self._snapshot_history()
                self._config[subsys].pop(target, None)
                if not self._config[subsys]:
                    del self._config[subsys]
                self._persist()
            self._run_hooks()

    def _persist(self) -> None:
        self.store.save(CONFIG_PATH, {"version": 1,
                                      "config": self._config})

    # -- history --------------------------------------------------------

    def _snapshot_history(self) -> None:
        # ns resolution: snapshots in the same second must still sort
        # in creation order (restore picks "the latest").
        hid = f"{time.time_ns():020d}-{uuid.uuid4().hex[:6]}"
        self.store.save(f"{HISTORY_PREFIX}/{hid}.json",
                        {"id": hid, "time": time.time(),
                         "config": copy.deepcopy(self._config)})
        # Bound history (ref minioConfigHistoryPrefix GC).
        entries = sorted(self.history_ids())
        for old in entries[:-MAX_HISTORY]:
            self.store.delete(f"{HISTORY_PREFIX}/{old}.json")

    def history_ids(self) -> list[str]:
        names = self.store.list(HISTORY_PREFIX) or []
        return sorted(n.rsplit("/", 1)[-1][:-len(".json")]
                      for n in names if n.endswith(".json"))

    def restore(self, history_id: str) -> None:
        doc = self.store.load(f"{HISTORY_PREFIX}/{history_id}.json")
        if doc is None:
            raise KeyError(history_id)
        with self._write_mu:
            self._snapshot_history()
            self._config = doc["config"]
            self._persist()
        self._run_hooks()

    # -- dynamic apply ---------------------------------------------------

    def on_change(self, hook) -> None:
        """Register a callable(config_sys) run after every successful
        change (the reference's dynamic-subsystem reload,
        config.Config SetKVS dynamic flag)."""
        self._apply_hooks.append(hook)

    def _run_hooks(self) -> None:
        for hook in self._apply_hooks:
            try:
                hook(self)
            except Exception:
                from ..logger import Logger
                Logger.get().log_once(
                    f"config apply hook failed: {hook!r}", "config")
