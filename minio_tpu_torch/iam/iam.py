"""IAMSys: users, groups, policy attachment, service accounts, STS temp
credentials — persisted as JSON objects under .minio.sys/config/iam/ on
the cluster's own disks (the reference bootstraps IAM on its own object
store the same way; ref cmd/iam.go:204, cmd/iam-object-store.go).

The port's own copy of ``minio_tpu/iam/iam.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import threading
import time
from dataclasses import dataclass, field

from ..parallel.quorum import parallel_map
from ..storage import errors as serr
from ..storage.xl import MINIO_META_BUCKET
from .policy import DEFAULT_POLICIES, Policy

IAM_PREFIX = "config/iam"


@dataclass
class UserIdentity:
    access_key: str
    secret_key: str
    status: str = "enabled"          # enabled | disabled
    policies: list[str] = field(default_factory=list)
    groups: list[str] = field(default_factory=list)
    parent: str = ""                 # for service accounts / STS
    session_token: str = ""
    expiration: float = 0.0          # 0 = permanent
    session_policy: dict | None = None

    def to_dict(self) -> dict:
        return {"accessKey": self.access_key,
                "secretKey": self.secret_key,
                "status": self.status, "policies": self.policies,
                "groups": self.groups, "parent": self.parent,
                "expiration": self.expiration,
                "sessionToken": self.session_token,
                "sessionPolicy": self.session_policy}

    @classmethod
    def from_dict(cls, d: dict) -> "UserIdentity":
        return cls(access_key=d["accessKey"], secret_key=d["secretKey"],
                   status=d.get("status", "enabled"),
                   policies=list(d.get("policies", [])),
                   groups=list(d.get("groups", [])),
                   parent=d.get("parent", ""),
                   expiration=d.get("expiration", 0.0),
                   session_token=d.get("sessionToken", ""),
                   session_policy=d.get("sessionPolicy"))

    @property
    def expired(self) -> bool:
        return self.expiration > 0 and time.time() > self.expiration


class ConfigStore:
    """Quorum JSON config storage on the erasure set's disks (the
    system's own object store, ref .minio.sys/config)."""

    def __init__(self, disks: list):
        self.disks = disks

    def _first_success(self, read):
        """Run ``read(disk)`` against healthy disks first, quarantined
        only as a last resort — config reads obey the same hygiene as
        the data plane (obs/drivemon.py quarantine lifecycle). A
        healthy disk answering "not found" is a DEFINITIVE miss
        (config docs are optional — most never exist), so only
        transient failures on every healthy disk justify probing a
        possibly-stalling quarantined drive (availability over
        hygiene). Returns the first successful read, or None."""
        from ..obs.drivemon import DRIVEMON, drive_key
        healthy: list = []
        quarantined: list = []
        for d in self.disks:
            (quarantined if DRIVEMON.is_quarantined(drive_key(d))
             else healthy).append(d)
        definitive_miss = False
        for d in healthy:
            try:
                return read(d)
            except (serr.FileNotFound, serr.VolumeNotFound):
                definitive_miss = True
            except serr.StorageError:
                continue
        if not definitive_miss:
            for d in quarantined:
                try:
                    return read(d)
                except serr.StorageError:
                    continue
        return None

    def save(self, path: str, doc: dict) -> None:
        raw = json.dumps(doc, sort_keys=True).encode()
        _, errs = parallel_map(
            [lambda d=d: d.write_all(MINIO_META_BUCKET, path, raw)
             for d in self.disks])
        ok = sum(1 for e in errs if e is None)
        if ok < len(self.disks) // 2 + 1:
            raise serr.FaultyDisk(f"config write quorum failed: {path}")

    def load(self, path: str) -> dict | None:
        return self._first_success(
            lambda d: json.loads(d.read_all(MINIO_META_BUCKET, path)))

    def delete(self, path: str) -> None:
        parallel_map([lambda d=d: d.delete(MINIO_META_BUCKET, path)
                      for d in self.disks])

    def list(self, prefix: str) -> list[str]:
        out = self._first_success(
            lambda d: [e for e in d.list_dir(MINIO_META_BUCKET, prefix)
                       if not e.endswith("/")])
        return [] if out is None else out


class IAMSys:
    """Identity and policy registry (ref IAMSys, cmd/iam.go:204)."""

    def __init__(self, store: ConfigStore, root_access: str,
                 root_secret: str):
        self.store = store
        self.root_access = root_access
        self.root_secret = root_secret
        self._mu = threading.RLock()
        self.users: dict[str, UserIdentity] = {}
        self.policies: dict[str, Policy] = dict(DEFAULT_POLICIES)
        self.policy_docs: dict[str, dict] = {}
        self.groups: dict[str, dict] = {}  # name -> {members, policies}
        self._sts_key = hashlib.sha256(
            f"sts:{root_secret}".encode()).digest()
        self._last_load = 0.0
        # Fallback freshness poll (seconds). With the peer push wired
        # (distributed mode), the boot path stretches this: pushes are
        # the primary mechanism, the poll is the safety net (ref
        # peer-notified IAM reload, cmd/notification.go LoadUser etc).
        self.reload_interval = 1.0
        # NotificationSys.load_iam in distributed mode; None otherwise.
        self.notify = None
        self.load()

    def _maybe_reload(self) -> None:
        """On-demand refresh so identities created via another cluster
        node become visible (ref peer-notified IAM reload; here a cheap
        miss-triggered re-read with rate limiting)."""
        if time.time() - self._last_load >= self.reload_interval:
            self.load()

    # -- persistence ----------------------------------------------------

    def load(self) -> None:
        """Full rebuild from the store — REPLACE, don't merge, so
        entities deleted on another node disappear here too (a merge
        would keep revoked credentials alive until restart; all
        identities including STS temp creds are store-persisted, so a
        rebuild loses nothing)."""
        with self._mu:
            self._last_load = time.time()
            users: dict[str, UserIdentity] = {}
            for name in self.store.list(f"{IAM_PREFIX}/users"):
                doc = self.store.load(f"{IAM_PREFIX}/users/{name}")
                if doc:
                    u = UserIdentity.from_dict(doc)
                    users[u.access_key] = u
            policies = dict(DEFAULT_POLICIES)
            policy_docs: dict[str, dict] = {}
            for name in self.store.list(f"{IAM_PREFIX}/policies"):
                doc = self.store.load(f"{IAM_PREFIX}/policies/{name}")
                if doc:
                    pname = name.removesuffix(".json")
                    policies[pname] = Policy.from_dict(doc)
                    policy_docs[pname] = doc
            groups: dict[str, dict] = {}
            for name in self.store.list(f"{IAM_PREFIX}/groups"):
                doc = self.store.load(f"{IAM_PREFIX}/groups/{name}")
                if doc:
                    groups[name.removesuffix(".json")] = doc
            self.users = users
            self.policies = policies
            self.policy_docs = policy_docs
            self.groups = groups
            self.sts_policy_map = (
                self.store.load(f"{IAM_PREFIX}/sts-policy-map.json")
                or {})

    def _notify_peers(self) -> None:
        if self.notify is not None:
            self.notify()

    # -- users ----------------------------------------------------------

    def add_user(self, access_key: str, secret_key: str,
                 policies: list[str] | None = None) -> UserIdentity:
        if access_key == self.root_access:
            raise ValueError("cannot modify root credentials")
        if len(access_key) < 3 or len(secret_key) < 8:
            raise ValueError("access key >= 3 chars, secret >= 8 chars")
        u = UserIdentity(access_key, secret_key,
                         policies=list(policies or []))
        with self._mu:
            self.users[access_key] = u
            self.store.save(f"{IAM_PREFIX}/users/{access_key}.json",
                            u.to_dict())
        self._notify_peers()
        return u

    def remove_user(self, access_key: str) -> None:
        with self._mu:
            if access_key not in self.users:
                raise KeyError(access_key)
            del self.users[access_key]
            self.store.delete(f"{IAM_PREFIX}/users/{access_key}.json")
        self._notify_peers()

    def set_user_status(self, access_key: str, status: str) -> None:
        with self._mu:
            u = self.users[access_key]
            u.status = status
            self.store.save(f"{IAM_PREFIX}/users/{access_key}.json",
                            u.to_dict())
        self._notify_peers()

    def set_user_policy(self, access_key: str,
                        policies: list[str]) -> None:
        with self._mu:
            u = self.users[access_key]
            u.policies = list(policies)
            self.store.save(f"{IAM_PREFIX}/users/{access_key}.json",
                            u.to_dict())
        self._notify_peers()

    def list_users(self) -> list[dict]:
        with self._mu:
            return [{"accessKey": u.access_key, "status": u.status,
                     "policies": u.policies}
                    for u in self.users.values() if not u.parent]

    # -- groups ---------------------------------------------------------

    def add_group(self, name: str, members: list[str],
                  policies: list[str] | None = None) -> None:
        with self._mu:
            g = self.groups.setdefault(
                name, {"members": [], "policies": list(policies or [])})
            g["members"] = sorted(set(g["members"]) | set(members))
            if policies is not None:
                g["policies"] = list(policies)
            self.store.save(f"{IAM_PREFIX}/groups/{name}.json", g)
            for m in members:
                u = self.users.get(m)
                if u and name not in u.groups:
                    u.groups.append(name)
                    self.store.save(f"{IAM_PREFIX}/users/{m}.json",
                                    u.to_dict())
        self._notify_peers()

    # -- policies -------------------------------------------------------

    def set_policy(self, name: str, doc: dict) -> None:
        with self._mu:
            self.policies[name] = Policy.from_dict(doc)
            self.policy_docs[name] = doc
            self.store.save(f"{IAM_PREFIX}/policies/{name}.json", doc)
        self._notify_peers()

    def delete_policy(self, name: str) -> None:
        with self._mu:
            if name in DEFAULT_POLICIES:
                raise ValueError(f"cannot delete built-in policy {name}")
            self.policies.pop(name, None)
            self.policy_docs.pop(name, None)
            self.store.delete(f"{IAM_PREFIX}/policies/{name}.json")
        self._notify_peers()

    def list_policies(self) -> list[str]:
        with self._mu:
            return sorted(self.policies)

    # -- STS ------------------------------------------------------------

    def _mint_temp_credentials(self, claims: dict, parent: str,
                               duration_seconds: int,
                               policies: list[str] | None = None,
                               session_policy: dict | None = None,
                               ) -> UserIdentity:
        """Shared STS tail: clamp duration, mint keys, sign the session
        token, persist so every cluster node honors the credential (ref
        STS creds stored in the IAM object store)."""
        duration_seconds = max(900, min(duration_seconds, 7 * 24 * 3600))
        exp = time.time() + duration_seconds
        tmp_access = "MTPU" + secrets.token_hex(8).upper()
        tmp_secret = secrets.token_urlsafe(24)
        token = self._sign_token(
            dict(claims, exp=exp, secret=tmp_secret))
        u = UserIdentity(tmp_access, tmp_secret,
                         policies=list(policies or []), parent=parent,
                         session_token=token, expiration=exp,
                         session_policy=session_policy)
        with self._mu:
            self.users[tmp_access] = u
            self.store.save(f"{IAM_PREFIX}/users/{tmp_access}.json",
                            u.to_dict())
        return u

    def assume_role(self, access_key: str,
                    duration_seconds: int = 3600,
                    session_policy: dict | None = None) -> UserIdentity:
        """Mint temp credentials for an authenticated identity
        (ref AssumeRole, cmd/sts-handlers.go)."""
        claims: dict = {"parent": access_key}
        if session_policy:
            claims["policy"] = session_policy
        return self._mint_temp_credentials(
            claims, access_key, duration_seconds,
            session_policy=session_policy)

    def assume_role_web_identity(self, subject: str, policy_name: str,
                                 duration_seconds: int = 3600,
                                 ) -> UserIdentity:
        """Temp credentials for an EXTERNAL (OpenID) identity; the
        token's policy claim names the canned policy to attach (ref
        AssumeRoleWithWebIdentity, cmd/sts-handlers.go)."""
        with self._mu:
            if policy_name not in self.policies:
                raise KeyError(f"no such policy {policy_name!r}")
        return self._mint_temp_credentials(
            {"sub": subject}, f"oidc:{subject}", duration_seconds,
            policies=[policy_name])

    def set_sts_policy_map(self, key: str, policies: list[str]) -> None:
        """Map an external identity (``ldap:<user-dn>``, ``ldap:<group-dn>``
        or ``oidc:<sub>``) to canned policies — the reference's policy
        database for LDAP/OIDC STS identities (ref mc admin policy
        attach --ldap; cmd/iam.go PolicyDBSet)."""
        with self._mu:
            unknown = [p for p in policies if p not in self.policies]
            if unknown:
                raise KeyError(f"no such policy {unknown[0]!r}")
            if policies:
                self.sts_policy_map[key] = list(policies)
            else:
                self.sts_policy_map.pop(key, None)
            self.store.save(f"{IAM_PREFIX}/sts-policy-map.json",
                            self.sts_policy_map)
        self._notify_peers()

    def assume_role_ldap_identity(self, user_dn: str, groups: list[str],
                                  duration_seconds: int = 3600,
                                  ) -> UserIdentity:
        """Temp credentials for an LDAP-authenticated identity; policies
        come from the policy map over the user DN and group DNs (ref
        AssumeRoleWithLDAPIdentity, cmd/sts-handlers.go:78-93). No
        mapped policy = refused, like the reference."""
        with self._mu:
            names: list[str] = []
            for key in [f"ldap:{user_dn}"] + [f"ldap:{g}" for g in groups]:
                for p in self.sts_policy_map.get(key, []):
                    if p not in names:
                        names.append(p)
        if not names:
            raise KeyError(f"no policy mapped for {user_dn!r}")
        return self._mint_temp_credentials(
            {"ldapUser": user_dn}, f"ldap:{user_dn}", duration_seconds,
            policies=names)

    def _sign_token(self, claims: dict) -> str:
        body = base64.urlsafe_b64encode(
            json.dumps(claims, sort_keys=True).encode()).decode()
        sig = hmac.new(self._sts_key, body.encode(),
                       hashlib.sha256).hexdigest()
        return f"{body}.{sig}"

    def verify_token(self, token: str) -> dict | None:
        body, _, sig = token.rpartition(".")
        want = hmac.new(self._sts_key, body.encode(),
                        hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            return None
        claims = json.loads(base64.urlsafe_b64decode(body))
        if time.time() > claims.get("exp", 0):
            return None
        return claims

    # -- auth + authz ---------------------------------------------------

    def lookup_secret(self, access_key: str) -> str | None:
        """SigV4 secret lookup (ref checkRequestAuthType)."""
        if access_key == self.root_access:
            return self.root_secret
        with self._mu:
            u = self.users.get(access_key)
        if u is None:
            self._maybe_reload()
            with self._mu:
                u = self.users.get(access_key)
        if u is None or u.status != "enabled" or u.expired:
            return None
        return u.secret_key

    def get_user(self, access_key: str):
        with self._mu:
            return self.users.get(access_key)

    def is_allowed(self, access_key: str, action: str, resource: str,
                   context: dict | None = None) -> bool:
        """Policy check (ref IAMSys.IsAllowed, cmd/iam.go:1612)."""
        if access_key == self.root_access:
            return True
        with self._mu:
            u = self.users.get(access_key)
        if u is None:
            self._maybe_reload()
        with self._mu:
            u = self.users.get(access_key)
            if u is None or u.status != "enabled" or u.expired:
                return False
            names = list(u.policies)
            for g in u.groups:
                names.extend(self.groups.get(g, {}).get("policies", []))
            if u.parent:
                # STS/service creds inherit the parent's policies,
                # intersected with any session policy.
                parent = self.users.get(u.parent)
                if u.parent == self.root_access:
                    names = ["readwrite"]
                elif parent:
                    names.extend(parent.policies)
            pols = [self.policies[n] for n in names
                    if n in self.policies]
        if not pols:
            return False
        allowed = any(
            p.is_allowed(action, resource, context=context or {})
            for p in pols)
        # A session policy can only restrict further (AWS semantics:
        # effective perms = identity ∩ session policy).
        if allowed and u.session_policy:
            sp = Policy.from_dict(u.session_policy)
            allowed = sp.is_allowed(action, resource,
                                    context=context or {})
        return allowed
