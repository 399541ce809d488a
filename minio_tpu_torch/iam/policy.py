"""AWS-compatible policy documents and evaluation
(ref pkg/iam/policy: Policy.IsAllowed, pkg/bucket/policy,
pkg/wildcard for * / ? matching).

Supported: Version/Statement with Effect, Action (s3:* wildcards),
Resource (arn:aws:s3:::bucket/key wildcards), Principal (bucket
policies), and the common Condition operators (StringEquals,
StringLike, IpAddress is accepted but not evaluated without a source).
Explicit Deny overrides Allow, default deny — AWS semantics.

The port's own copy of ``minio_tpu/iam/policy.py``, with no change in
behaviour.
"""

from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field

ARN_PREFIX = "arn:aws:s3:::"

# Action names (subset mirroring pkg/iam/policy/action.go).
ALL_ACTIONS = "s3:*"


def wildcard_match(pattern: str, s: str) -> bool:
    """S3 wildcard semantics: '*' matches any sequence (including '/'),
    '?' any single char (ref pkg/wildcard/match.go MatchSimple)."""
    # fnmatch's [] classes are not part of S3 wildcards; escape them.
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(s, pattern)


@dataclass
class Statement:
    effect: str                      # "Allow" | "Deny"
    actions: list[str]
    resources: list[str]
    principals: list[str] = field(default_factory=list)  # bucket policies
    conditions: dict = field(default_factory=dict)
    not_actions: list[str] = field(default_factory=list)

    def matches_action(self, action: str) -> bool:
        if self.not_actions:
            return not any(wildcard_match(p, action)
                           for p in self.not_actions)
        return any(wildcard_match(p, action) for p in self.actions)

    def matches_resource(self, resource: str) -> bool:
        if not self.resources:
            return True
        for r in self.resources:
            pat = r[len(ARN_PREFIX):] if r.startswith(ARN_PREFIX) else r
            if wildcard_match(pat, resource) or pat == "*":
                return True
        return False

    def matches_principal(self, principal: str) -> bool:
        if not self.principals:
            return True
        return any(p == "*" or wildcard_match(p, principal)
                   for p in self.principals)

    def matches_conditions(self, context: dict) -> bool:
        for op, clauses in self.conditions.items():
            op_l = op.lower()
            for key, want in clauses.items():
                got = context.get(key.lower())
                wants = want if isinstance(want, list) else [want]
                if op_l == "stringequals":
                    if got is None or got not in wants:
                        return False
                elif op_l == "stringnotequals":
                    if got is not None and got in wants:
                        return False
                elif op_l == "stringlike":
                    if got is None or not any(
                            wildcard_match(w, got) for w in wants):
                        return False
                # Unknown operators: conservatively no-match for Allow
                # is risky; the reference fails closed too.
                elif op_l in ("ipaddress", "notipaddress"):
                    continue
                else:
                    return False
        return True


@dataclass
class Policy:
    statements: list[Statement]
    version: str = "2012-10-17"

    @classmethod
    def from_dict(cls, doc: dict) -> "Policy":
        stmts = []
        raw = doc.get("Statement", [])
        if isinstance(raw, dict):
            raw = [raw]
        for s in raw:
            actions = s.get("Action", [])
            if isinstance(actions, str):
                actions = [actions]
            not_actions = s.get("NotAction", [])
            if isinstance(not_actions, str):
                not_actions = [not_actions]
            resources = s.get("Resource", [])
            if isinstance(resources, str):
                resources = [resources]
            principal = s.get("Principal", {})
            principals: list[str] = []
            if principal == "*":
                principals = ["*"]
            elif isinstance(principal, dict):
                aws = principal.get("AWS", [])
                principals = [aws] if isinstance(aws, str) else list(aws)
            stmts.append(Statement(
                effect=s.get("Effect", "Deny"),
                actions=actions, not_actions=not_actions,
                resources=resources, principals=principals,
                conditions=s.get("Condition", {}) or {},
            ))
        return cls(stmts, doc.get("Version", "2012-10-17"))

    @classmethod
    def from_json(cls, raw: str | bytes) -> "Policy":
        return cls.from_dict(json.loads(raw))

    def is_allowed(self, action: str, resource: str,
                   principal: str = "", context: dict | None = None,
                   ) -> bool:
        """Explicit Deny wins; else any Allow; else deny
        (ref iampolicy.Policy.IsAllowed)."""
        context = context or {}
        allowed = False
        for st in self.statements:
            if not (st.matches_action(action)
                    and st.matches_resource(resource)
                    and st.matches_principal(principal)
                    and st.matches_conditions(context)):
                continue
            if st.effect == "Deny":
                return False
            allowed = True
        return allowed


# --- canned policies (ref pkg/iam/policy default policies) -------------------

READ_WRITE = Policy.from_dict({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:*"],
                   "Resource": ["arn:aws:s3:::*"]}],
})

READ_ONLY = Policy.from_dict({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow",
                   "Action": ["s3:GetBucketLocation", "s3:GetObject",
                              "s3:ListBucket", "s3:ListAllMyBuckets",
                              "s3:GetObjectVersion"],
                   "Resource": ["arn:aws:s3:::*"]}],
})

WRITE_ONLY = Policy.from_dict({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:PutObject"],
                   "Resource": ["arn:aws:s3:::*"]}],
})

DEFAULT_POLICIES = {
    "readwrite": READ_WRITE,
    "readonly": READ_ONLY,
    "writeonly": WRITE_ONLY,
}
