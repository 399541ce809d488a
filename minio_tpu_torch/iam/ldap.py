"""Minimal LDAPv3 wire client for the LDAP identity backend.

The reference ships an LDAP identity provider (ref
cmd/config/identity/ldap/config.go, lookup-bind mode) backing
AssumeRoleWithLDAPIdentity (ref cmd/sts-handlers.go:78-93). It uses the
go-ldap client; this build implements the two operations STS needs —
simple bind and subtree search — directly at the BER/wire level, the
same pattern as the broker sinks (event/brokers.py): no client
libraries, tested against an in-process fake server speaking the same
frames (tests/test_ldap_sts.py).

Wire format (RFC 4511): every LDAPMessage is a BER SEQUENCE of
{messageID INTEGER, protocolOp [APPLICATION n]}. Only definite lengths
are emitted; both short and long-form lengths are parsed.

The port's own copy of ``minio_tpu/iam/ldap.py``, with no change in
behaviour.
"""

from __future__ import annotations

import socket
import ssl
import threading

# -- BER primitives -----------------------------------------------------------


def ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def ber(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + ber_len(len(payload)) + payload


def ber_int(v: int, tag: int = 0x02) -> bytes:
    if v == 0:
        return ber(tag, b"\x00")
    body = v.to_bytes((v.bit_length() // 8) + 1, "big", signed=True)
    return ber(tag, body)


def ber_str(s: str | bytes, tag: int = 0x04) -> bytes:
    return ber(tag, s if isinstance(s, bytes) else s.encode())


def ber_seq(*parts: bytes) -> bytes:
    return ber(0x30, b"".join(parts))


def ber_read(buf: bytes, off: int) -> tuple[int, bytes, int]:
    """Parse one TLV at off -> (tag, value, next_off)."""
    if off + 2 > len(buf):
        raise ValueError("short BER element")
    tag = buf[off]
    l0 = buf[off + 1]
    off += 2
    if l0 < 0x80:
        length = l0
    else:
        nlen = l0 & 0x7F
        if nlen == 0 or off + nlen > len(buf):
            raise ValueError("bad BER length")
        length = int.from_bytes(buf[off:off + nlen], "big")
        off += nlen
    if off + length > len(buf):
        raise ValueError("truncated BER value")
    return tag, buf[off:off + length], off + length


def ber_read_all(payload: bytes) -> list[tuple[int, bytes]]:
    out, off = [], 0
    while off < len(payload):
        tag, val, off = ber_read(payload, off)
        out.append((tag, val))
    return out


# -- protocol ops -------------------------------------------------------------

_APP_BIND_REQ = 0x60
_APP_BIND_RESP = 0x61
_APP_SEARCH_REQ = 0x63
_APP_SEARCH_ENTRY = 0x64
_APP_SEARCH_DONE = 0x65
_APP_UNBIND = 0x42
_CTX_SIMPLE_AUTH = 0x80
_CTX_FILTER_EQ = 0xA3
_CTX_FILTER_AND = 0xA0
_CTX_FILTER_PRESENT = 0x87


class LDAPError(Exception):
    pass


def insecure_context() -> ssl.SSLContext:
    """No-verify TLS context for the explicit skip-verify opt-out."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def filter_eq(attr: str, value: str) -> bytes:
    return ber(_CTX_FILTER_EQ, ber_str(attr) + ber_str(value))


def filter_and(*filters: bytes) -> bytes:
    return ber(_CTX_FILTER_AND, b"".join(filters))


def filter_present(attr: str) -> bytes:
    return ber(_CTX_FILTER_PRESENT, attr.encode())


class LDAPClient:
    """One LDAP connection: bind + subtree search (RFC 4511 subset)."""

    def __init__(self, host: str, port: int = 389, timeout: float = 10.0,
                 tls: bool = False, tls_context: ssl.SSLContext | None = None):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        if tls:
            ctx = tls_context
            if ctx is None:
                # VERIFYING by default: LDAPS carries the directory
                # password, so certificate validation is the floor.
                # Directories with private CAs opt out explicitly via
                # MINIO_IDENTITY_LDAP_TLS_SKIP_VERIFY (insecure_context
                # below), matching the reference's tls_skip_verify.
                ctx = ssl.create_default_context()
            self._sock = ctx.wrap_socket(self._sock, server_hostname=host)
        self._msg_id = 0
        self._mu = threading.Lock()
        self._buf = b""

    def close(self) -> None:
        try:
            with self._mu:
                self._msg_id += 1
                self._sock.sendall(ber_seq(ber_int(self._msg_id),
                                           ber(_APP_UNBIND, b"")))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- transport ------------------------------------------------------

    def _recv_message(self) -> tuple[int, int, bytes]:
        """-> (message_id, op_tag, op_value)."""
        while True:
            try:
                _tag, val, consumed = ber_read(self._buf, 0)
                self._buf = self._buf[consumed:]
                parts = ber_read_all(val)
                if len(parts) < 2 or parts[0][0] != 0x02:
                    raise LDAPError("malformed LDAPMessage")
                msg_id = int.from_bytes(parts[0][1], "big")
                return msg_id, parts[1][0], parts[1][1]
            except ValueError:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise LDAPError("connection closed")
                self._buf += chunk

    def _send(self, op: bytes) -> int:
        self._msg_id += 1
        self._sock.sendall(ber_seq(ber_int(self._msg_id), op))
        return self._msg_id

    # -- operations -----------------------------------------------------

    def simple_bind(self, dn: str, password: str) -> None:
        """BindRequest with simple auth; raises LDAPError unless the
        server answers resultCode 0 (ref ldap.Conn.Bind)."""
        with self._mu:
            mid = self._send(ber(_APP_BIND_REQ,
                                 ber_int(3) + ber_str(dn)
                                 + ber_str(password, _CTX_SIMPLE_AUTH)))
            rid, tag, val = self._recv_message()
        if rid != mid or tag != _APP_BIND_RESP:
            raise LDAPError("unexpected bind response")
        parts = ber_read_all(val)
        code = int.from_bytes(parts[0][1], "big") if parts else 255
        if code != 0:
            raise LDAPError(f"bind failed: resultCode={code}")

    def search(self, base: str, flt: bytes,
               attrs: list[str] | None = None,
               ) -> list[tuple[str, dict[str, list[str]]]]:
        """Whole-subtree search -> [(dn, {attr: [values]})]."""
        attr_seq = ber_seq(*[ber_str(a) for a in (attrs or [])])
        req = ber(_APP_SEARCH_REQ,
                  ber_str(base) + ber_int(2, 0x0A) + ber_int(0, 0x0A)
                  + ber_int(0) + ber_int(0) + ber(0x01, b"\x00")
                  + flt + attr_seq)
        entries: list[tuple[str, dict[str, list[str]]]] = []
        with self._mu:
            mid = self._send(req)
            while True:
                rid, tag, val = self._recv_message()
                if rid != mid:
                    continue
                if tag == _APP_SEARCH_ENTRY:
                    parts = ber_read_all(val)
                    dn = parts[0][1].decode("utf-8", "replace")
                    attrs_out: dict[str, list[str]] = {}
                    if len(parts) > 1:
                        for _t, pa in ber_read_all(parts[1][1]):
                            kv = ber_read_all(pa)
                            name = kv[0][1].decode()
                            vals = [v.decode("utf-8", "replace")
                                    for _vt, v in ber_read_all(kv[1][1])]
                            attrs_out[name] = vals
                    entries.append((dn, attrs_out))
                elif tag == _APP_SEARCH_DONE:
                    parts = ber_read_all(val)
                    code = (int.from_bytes(parts[0][1], "big")
                            if parts else 255)
                    if code != 0:
                        raise LDAPError(
                            f"search failed: resultCode={code}")
                    return entries
                else:
                    raise LDAPError(f"unexpected op 0x{tag:02x}")


# -- identity backend ---------------------------------------------------------


class LDAPIdentity:
    """Lookup-bind LDAP identity (ref ldap/config.go LookupBind mode):
    a service account searches the user's DN from a username filter,
    the user's password is verified by binding as that DN, and group
    memberships come from a group filter over the member DN.

    Config (env, matching the reference's MINIO_IDENTITY_LDAP_*):
      SERVER_ADDR           host:port
      LOOKUP_BIND_DN        service account DN
      LOOKUP_BIND_PASSWORD
      USER_DN_SEARCH_BASE_DN
      USER_DN_SEARCH_FILTER   e.g. (uid=%s)   (%s = username)
      GROUP_SEARCH_BASE_DN
      GROUP_SEARCH_FILTER     e.g. (member=%d) (%d = user DN)
      TLS                     "on" to wrap the socket
    """

    def __init__(self, server_addr: str, lookup_bind_dn: str,
                 lookup_bind_password: str, user_base_dn: str,
                 user_filter: str = "(uid=%s)", group_base_dn: str = "",
                 group_filter: str = "(member=%d)", tls: bool = False,
                 tls_skip_verify: bool = False, client_factory=None):
        self.server_addr = server_addr
        self.lookup_bind_dn = lookup_bind_dn
        self.lookup_bind_password = lookup_bind_password
        self.user_base_dn = user_base_dn
        self.user_filter = user_filter
        self.group_base_dn = group_base_dn
        self.group_filter = group_filter
        self.tls = tls
        self.tls_skip_verify = tls_skip_verify
        self._client_factory = client_factory or self._connect

    @classmethod
    def from_env(cls, env) -> "LDAPIdentity | None":
        addr = env.get("MINIO_IDENTITY_LDAP_SERVER_ADDR", "")
        if not addr:
            return None
        return cls(
            addr,
            env.get("MINIO_IDENTITY_LDAP_LOOKUP_BIND_DN", ""),
            env.get("MINIO_IDENTITY_LDAP_LOOKUP_BIND_PASSWORD", ""),
            env.get("MINIO_IDENTITY_LDAP_USER_DN_SEARCH_BASE_DN", ""),
            env.get("MINIO_IDENTITY_LDAP_USER_DN_SEARCH_FILTER",
                    "(uid=%s)"),
            env.get("MINIO_IDENTITY_LDAP_GROUP_SEARCH_BASE_DN", ""),
            env.get("MINIO_IDENTITY_LDAP_GROUP_SEARCH_FILTER",
                    "(member=%d)"),
            env.get("MINIO_IDENTITY_LDAP_TLS", "") == "on",
            env.get("MINIO_IDENTITY_LDAP_TLS_SKIP_VERIFY", "") == "on")

    def _connect(self) -> LDAPClient:
        host, _, port = self.server_addr.rpartition(":")
        ctx = insecure_context() if (self.tls and self.tls_skip_verify) \
            else None
        return LDAPClient(host or self.server_addr,
                          int(port) if port else 389, tls=self.tls,
                          tls_context=ctx)

    @staticmethod
    def _parse_filter(template: str, value: str) -> bytes:
        """Compile the reference's filter syntax subset: an optional
        (&(...)(...)) conjunction of (attr=%s|%d|literal|*) terms."""
        t = template.strip()
        if t.startswith("(&") and t.endswith(")"):
            inner = t[2:-1]
            parts, depth, start = [], 0, 0
            for i, ch in enumerate(inner):
                if ch == "(":
                    if depth == 0:
                        start = i
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        parts.append(inner[start:i + 1])
            return filter_and(*[LDAPIdentity._parse_filter(p, value)
                                for p in parts])
        if not (t.startswith("(") and t.endswith(")")):
            raise LDAPError(f"unsupported filter {template!r}")
        attr, _, rhs = t[1:-1].partition("=")
        if rhs == "*":
            return filter_present(attr)
        rhs = rhs.replace("%s", value).replace("%d", value)
        return filter_eq(attr, rhs)

    def authenticate(self, username: str, password: str,
                     ) -> tuple[str, list[str]]:
        """-> (user_dn, group_dns); raises LDAPError on bad creds.

        Anonymous/empty passwords are rejected up front: an LDAP simple
        bind with an empty password SUCCEEDS as anonymous on most
        servers, which would turn 'forgot the password field' into a
        login (the go-ldap client guards identically)."""
        if not username or not password:
            raise LDAPError("empty username or password")
        with self._client_factory() as lookup:
            lookup.simple_bind(self.lookup_bind_dn,
                               self.lookup_bind_password)
            hits = lookup.search(
                self.user_base_dn,
                self._parse_filter(self.user_filter, username), ["dn"])
            if len(hits) != 1:
                raise LDAPError(
                    f"user search matched {len(hits)} entries")
            user_dn = hits[0][0]
            # Password check on a SEPARATE connection: the user bind
            # must not downgrade the lookup connection's authorization.
            with self._client_factory() as conn:
                conn.simple_bind(user_dn, password)
            # Group search stays on the SERVICE ACCOUNT connection:
            # directories commonly deny regular users read access to
            # the group subtree, which would silently yield groups=[]
            # and lose group-mapped policies (the reference's
            # lookup-bind mode searches as the service account too).
            groups: list[str] = []
            if self.group_base_dn:
                for dn, _attrs in lookup.search(
                        self.group_base_dn,
                        self._parse_filter(self.group_filter, user_dn),
                        ["dn"]):
                    groups.append(dn)
        return user_dn, groups
