"""Admin API client SDK — the `madmin` analog (ref pkg/madmin, 5856
LoC: the Go client the reference's `mc admin` is built on). Wraps the
SigV4 S3Client against the `/minio-tpu/admin/v1/*` JSON routes so
tools and tests never hand-roll admin requests.

The port's own copy of ``minio_tpu/s3/admin_client.py``, with no change in
behaviour.
"""

from __future__ import annotations

import json
import urllib.parse

from .client import S3Client


class AdminError(Exception):
    def __init__(self, status: int, body: bytes):
        super().__init__(f"admin API {status}: {body[:200]!r}")
        self.status = status
        self.body = body


class AdminClient:
    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str):
        self._c = S3Client(host, port, access_key, secret_key)

    def _call(self, method: str, route: str, params: dict | None = None,
              body: bytes = b"") -> dict:
        query = urllib.parse.urlencode(params or {})
        r = self._c.request(method, f"/minio-tpu/admin/v1/{route}",
                            query=query, body=body)
        if r.status != 200:
            raise AdminError(r.status, r.body)
        return json.loads(r.body) if r.body else {}

    # -- info / usage ---------------------------------------------------

    def server_info(self) -> dict:
        return self._call("GET", "info")

    def data_usage(self) -> dict:
        return self._call("GET", "datausage")

    def top(self, n: int = 0) -> dict:
        """Workload attribution report (`mc admin top` analog): ranked
        buckets/tenants, per-class top-K keys/clients, stored-bytes
        join, worst-request trace exemplars."""
        return self._call("GET", "top", {"n": str(n)} if n else {})

    def obd_info(self, drive_perf: bool = False) -> dict:
        return self._call("GET", "obd-info",
                          {"drivePerf": "true"} if drive_perf else {})

    # -- users / policies -----------------------------------------------

    def add_user(self, access_key: str, secret_key: str,
                 policies: list[str] | None = None) -> None:
        self._call("POST", "add-user", body=json.dumps({
            "accessKey": access_key, "secretKey": secret_key,
            "policies": policies or []}).encode())

    def list_users(self) -> list:
        return self._call("GET", "list-users")["users"]

    def remove_user(self, access_key: str) -> None:
        self._call("POST", "remove-user", {"accessKey": access_key})

    def add_policy(self, name: str, policy: dict) -> None:
        self._call("POST", "add-policy", {"name": name},
                   json.dumps(policy).encode())

    def list_policies(self) -> list:
        return self._call("GET", "list-policies")["policies"]

    def set_user_policy(self, access_key: str,
                        policies: list[str]) -> None:
        self._call("POST", "set-user-policy",
                   {"accessKey": access_key,
                    "policies": ",".join(policies)})

    def set_sts_policy_map(self, identity: str,
                           policies: list[str]) -> None:
        """Attach canned policies to an external STS identity
        (``ldap:<dn>`` or ``oidc:<sub>``) — the `mc admin policy
        attach --ldap` analog. Empty list clears the mapping."""
        self._call("POST", "set-sts-policy-map", body=json.dumps({
            "identity": identity, "policies": policies}).encode())

    def get_sts_policy_map(self) -> dict:
        return self._call("GET", "get-sts-policy-map")["map"]

    # -- heal -----------------------------------------------------------

    def heal(self, bucket: str = "", prefix: str = "",
             dry_run: bool = False) -> list:
        p = {}
        if bucket:
            p["bucket"] = bucket
        if prefix:
            p["prefix"] = prefix
        if dry_run:
            p["dryRun"] = "true"
        return self._call("POST", "heal", p)["items"]

    def heal_start(self, bucket: str = "", prefix: str = "") -> str:
        p = {}
        if bucket:
            p["bucket"] = bucket
        if prefix:
            p["prefix"] = prefix
        return self._call("POST", "heal-start", p)["clientToken"]

    def heal_status(self, token: str) -> dict:
        return self._call("GET", "heal-status", {"token": token})

    # -- config ---------------------------------------------------------

    def get_config(self) -> dict:
        return self._call("GET", "get-config")["config"]

    def set_config_kv(self, line: str) -> None:
        self._call("POST", "set-config-kv", body=line.encode())

    def del_config_kv(self, spec: str) -> None:
        self._call("POST", "del-config-kv", body=spec.encode())

    def config_history(self) -> list:
        return self._call("GET", "config-history")["entries"]

    def restore_config(self, history_id: str) -> None:
        self._call("POST", "restore-config", {"id": history_id})

    # -- quota / replication / tiers ------------------------------------

    def set_bucket_quota(self, bucket: str, quota_bytes: int,
                         quota_type: str = "hard") -> None:
        body = b"{}" if not quota_bytes else json.dumps(
            {"quota": quota_bytes, "quotaType": quota_type}).encode()
        self._call("POST", "set-bucket-quota", {"bucket": bucket}, body)

    def get_bucket_quota(self, bucket: str) -> dict:
        return self._call("GET", "get-bucket-quota", {"bucket": bucket})

    def set_remote_target(self, bucket: str, endpoint: str,
                          target_bucket: str, access_key: str,
                          secret_key: str,
                          bandwidth_limit: int = 0) -> str:
        return self._call("POST", "set-remote-target",
                          {"bucket": bucket}, json.dumps({
                              "endpoint": endpoint,
                              "target_bucket": target_bucket,
                              "access_key": access_key,
                              "secret_key": secret_key,
                              "bandwidth_limit": bandwidth_limit,
                          }).encode())["arn"]

    def set_target_bandwidth(self, bucket: str, arn: str,
                             bandwidth_limit: int) -> None:
        """Replication bytes/sec cap for one target (0 lifts it)."""
        self._call("POST", "set-target-bandwidth", {"bucket": bucket},
                   json.dumps({"arn": arn,
                               "bandwidth_limit": bandwidth_limit,
                               }).encode())

    def list_remote_targets(self, bucket: str) -> list:
        return self._call("GET", "list-remote-targets",
                          {"bucket": bucket})["targets"]

    def remove_remote_target(self, bucket: str, arn: str) -> None:
        self._call("POST", "remove-remote-target",
                   {"bucket": bucket, "arn": arn})

    def add_tier(self, name: str, endpoint: str, bucket: str,
                 access_key: str, secret_key: str,
                 prefix: str = "") -> None:
        self._call("POST", "add-tier", body=json.dumps({
            "name": name, "endpoint": endpoint, "bucket": bucket,
            "access_key": access_key, "secret_key": secret_key,
            "prefix": prefix}).encode())

    def list_tiers(self) -> list:
        return self._call("GET", "list-tiers")["tiers"]

    def remove_tier(self, name: str) -> None:
        self._call("POST", "remove-tier", {"name": name})

    # -- observability --------------------------------------------------

    def trace(self, timeout: float = 3.0) -> list:
        return self._call("GET", "trace",
                          {"timeout": str(timeout)})["entries"]

    def console_log(self, n: int = 100) -> list:
        return self._call("GET", "console-log",
                          {"n": str(n)})["entries"]

    def profiling_start(self, interval_ms: float = 5.0) -> None:
        self._call("POST", "profiling-start",
                   {"intervalMs": str(interval_ms)})

    def profiling_stop(self) -> dict:
        return self._call("POST", "profiling-stop")["profile"]

    def bandwidth(self, bucket: str = "") -> dict:
        p = {"bucket": bucket} if bucket else {}
        return self._call("GET", "bandwidth", p)

    def cache_stats(self) -> dict:
        return self._call("GET", "cache-stats")

    def codec_plan(self, probe: bool = False) -> dict:
        """Codec dispatch planner view (ops/autotune.py): live plan,
        measured crossover table, probe results, device-affinity map.
        probe=True re-runs the probe ladder synchronously first."""
        p = {"probe": "true"} if probe else {}
        return self._call("GET", "codec-plan", p)

    def replication_stats(self) -> dict:
        return self._call("GET", "replication-stats")

    def top_locks(self) -> list:
        return self._call("GET", "top-locks")["locks"]

    # -- robustness -----------------------------------------------------

    def fault_inject(self, plan: dict | None = None,
                     clear: bool = False) -> dict:
        """Load (POST), clear (?clear=true), or inspect (bare GET —
        rules with seen/fired counters plus the registered crash-point
        inventory) the runtime fault plan."""
        if clear:
            return self._call("POST", "fault-inject", {"clear": "true"})
        if plan is not None:
            import json as _json
            return self._call("POST", "fault-inject",
                              body=_json.dumps(plan).encode())
        return self._call("GET", "fault-inject")

    def recovery(self) -> dict:
        """Boot-time crash-recovery report: per-set sweep results
        (staging residue GC'd, objects requeued, journal entries
        replayed) + the live durable-MRF journal census."""
        return self._call("GET", "recovery")
