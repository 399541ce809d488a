"""Broker event sinks: the reference's pkg/event/target/ suite
(amqp, elasticsearch, kafka, mqtt, mysql, nats, nsq, postgresql,
redis — ref pkg/event/target/*.go, 8k LoC) rebuilt as minimal
wire-protocol clients over stdlib sockets.

No broker client libraries exist in this image, so each target speaks
the sink's actual wire format directly — enough of it to deliver one
event durably (the queuestore wrapper in targets.py adds disk-backed
retry on top of ANY of these). Tests drive every target against an
in-process fake broker that decodes the real bytes
(tests/test_event_brokers.py).

All targets share the Target contract (arn/send/close) and raise on
failure so TargetList/queuestore retry semantics apply uniformly
(ref pkg/event/targetlist.go:25).

The port's own copy of ``minio_tpu/event/brokers.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
import zlib

from .targets import Target, WebhookTarget


def _connect(host: str, port: int, timeout: float) -> socket.socket:
    s = socket.create_connection((host, port), timeout=timeout)
    s.settimeout(timeout)
    return s


def _recv_exact(s: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("broker closed connection")
        buf += chunk
    return buf


def _key_of(record: dict) -> str:
    try:
        rec = record["Records"][0]
        return (rec["s3"]["bucket"]["name"] + "/"
                + rec["s3"]["object"]["key"])
    except (KeyError, IndexError, TypeError):
        return record.get("Key", "minio-tpu-event")


class _SocketTarget(Target):
    """Shared connect-per-send plumbing (brokers are connect-cheap at
    event rates; a persistent-session variant can pool later)."""

    kind = "socket"

    def __init__(self, host: str, port: int, arn_id: str = "1",
                 timeout: float = 5.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._arn = f"arn:minio-tpu:sqs::{arn_id}:{self.kind}"

    def arn(self) -> str:
        return self._arn


# ---------------------------------------------------------------------------
# NATS (plain-text protocol: INFO/CONNECT/PUB/+OK)


class NATSTarget(_SocketTarget):
    """ref pkg/event/target/nats.go — PUB <subject> <len>\\r\\n<json>."""

    kind = "nats"
    env_name = "NATS"

    def __init__(self, host: str, port: int, subject: str = "minio-tpu",
                 **kw):
        super().__init__(host, port, **kw)
        self.subject = subject

    def send(self, record: dict) -> None:
        payload = json.dumps(record).encode()
        s = _connect(self.host, self.port, self.timeout)
        try:
            f = s.makefile("rb")
            info = f.readline()            # INFO {...}
            if not info.startswith(b"INFO"):
                raise ConnectionError(f"bad NATS greeting: {info[:40]!r}")
            s.sendall(b'CONNECT {"verbose":true}\r\n')
            if f.readline().strip() != b"+OK":
                raise ConnectionError("NATS CONNECT refused")
            s.sendall(b"PUB " + self.subject.encode()
                      + b" %d\r\n" % len(payload) + payload + b"\r\n")
            if f.readline().strip() != b"+OK":
                raise ConnectionError("NATS PUB refused")
        finally:
            s.close()


# ---------------------------------------------------------------------------
# NSQ ("  V2" magic, PUB <topic>\n[4B size][body], "OK" frame)


class NSQTarget(_SocketTarget):
    """ref pkg/event/target/nsq.go — TCP protocol V2 PUB."""

    kind = "nsq"
    env_name = "NSQ"

    def __init__(self, host: str, port: int, topic: str = "minio-tpu",
                 **kw):
        super().__init__(host, port, **kw)
        self.topic = topic

    def send(self, record: dict) -> None:
        payload = json.dumps(record).encode()
        s = _connect(self.host, self.port, self.timeout)
        try:
            s.sendall(b"  V2")
            s.sendall(b"PUB " + self.topic.encode() + b"\n"
                      + struct.pack(">I", len(payload)) + payload)
            size = struct.unpack(">I", _recv_exact(s, 4))[0]
            frame = _recv_exact(s, size)   # [4B frame type]["OK"]
            ftype = struct.unpack(">i", frame[:4])[0]
            if ftype != 0 or frame[4:] != b"OK":
                raise ConnectionError(f"NSQ PUB failed: {frame!r}")
        finally:
            s.close()


# ---------------------------------------------------------------------------
# MQTT 3.1.1 (CONNECT/CONNACK, PUBLISH QoS0)


def _mqtt_string(b: bytes) -> bytes:
    return struct.pack(">H", len(b)) + b


def _mqtt_remaining_length(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


class MQTTTarget(_SocketTarget):
    """ref pkg/event/target/mqtt.go — MQTT 3.1.1 QoS0 publish."""

    kind = "mqtt"
    env_name = "MQTT"

    def __init__(self, host: str, port: int, topic: str = "minio-tpu",
                 client_id: str = "minio-tpu", **kw):
        super().__init__(host, port, **kw)
        self.topic = topic
        self.client_id = client_id

    def send(self, record: dict) -> None:
        payload = json.dumps(record).encode()
        s = _connect(self.host, self.port, self.timeout)
        try:
            var = (_mqtt_string(b"MQTT") + b"\x04"   # protocol level 4
                   + b"\x02"                          # clean session
                   + struct.pack(">H", 60)            # keepalive
                   + _mqtt_string(self.client_id.encode()))
            s.sendall(b"\x10" + _mqtt_remaining_length(len(var)) + var)
            ack = _recv_exact(s, 4)                   # CONNACK
            if ack[0] != 0x20 or ack[3] != 0:
                raise ConnectionError(f"MQTT CONNACK: {ack!r}")
            body = _mqtt_string(self.topic.encode()) + payload
            s.sendall(b"\x30" + _mqtt_remaining_length(len(body)) + body)
            # QoS0: no PUBACK. DISCONNECT politely.
            s.sendall(b"\xe0\x00")
        finally:
            s.close()


# ---------------------------------------------------------------------------
# Redis (RESP: RPUSH for list format / HSET for namespace format)


def _resp_command(*args: bytes) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        out.append(b"$%d\r\n" % len(a) + a + b"\r\n")
    return b"".join(out)


class RedisTarget(_SocketTarget):
    """ref pkg/event/target/redis.go — 'access' format RPUSHes the
    event onto a list key; 'namespace' format HSETs key->state."""

    kind = "redis"
    env_name = "REDIS"

    def __init__(self, host: str, port: int, key: str = "minio-tpu",
                 fmt: str = "access", **kw):
        super().__init__(host, port, **kw)
        self.key = key
        self.fmt = fmt

    def send(self, record: dict) -> None:
        payload = json.dumps(record).encode()
        s = _connect(self.host, self.port, self.timeout)
        try:
            if self.fmt == "namespace":
                cmd = _resp_command(b"HSET", self.key.encode(),
                                    _key_of(record).encode(), payload)
            else:
                cmd = _resp_command(b"RPUSH", self.key.encode(), payload)
            s.sendall(cmd)
            reply = _recv_exact(s, 1)
            if reply in (b"-",):
                raise ConnectionError("redis error reply")
            # drain the rest of the line
            while not reply.endswith(b"\r\n"):
                chunk = s.recv(64)
                if not chunk:
                    raise ConnectionError(
                        "redis closed connection mid-reply")
                reply += chunk
        finally:
            s.close()


# ---------------------------------------------------------------------------
# Elasticsearch (HTTP index API — JSON document per event)


class ElasticsearchTarget(WebhookTarget):
    """ref pkg/event/target/elasticsearch.go — POST /<index>/_doc.
    Reuses the webhook POST machinery (https/ports/paths handled
    there); only the document URL and ARN differ."""

    kind = "elasticsearch"
    env_name = "ELASTICSEARCH"

    def __init__(self, endpoint: str, index: str = "minio-tpu",
                 arn_id: str = "1", timeout: float = 5.0):
        self.index = index
        super().__init__(endpoint.rstrip("/") + f"/{index}/_doc",
                         arn_id=arn_id, timeout=timeout)
        self._arn = f"arn:minio-tpu:sqs::{arn_id}:elasticsearch"


# ---------------------------------------------------------------------------
# Kafka (wire protocol: Produce v0 with legacy v0 message set)


def _kafka_str(s: bytes) -> bytes:
    return struct.pack(">h", len(s)) + s


class KafkaTarget(_SocketTarget):
    """ref pkg/event/target/kafka.go — one Produce v0 request per
    event (legacy message format with CRC32, acks=1)."""

    kind = "kafka"
    env_name = "KAFKA"

    def __init__(self, host: str, port: int, topic: str = "minio-tpu",
                 **kw):
        super().__init__(host, port, **kw)
        self.topic = topic

    def send(self, record: dict) -> None:
        key = _key_of(record).encode()
        value = json.dumps(record).encode()
        # v0 Message: crc32(magic..value) + magic(0) + attrs(0) + key + value
        def _bytes(b: bytes) -> bytes:
            return struct.pack(">i", len(b)) + b
        msg_body = b"\x00\x00" + _bytes(key) + _bytes(value)
        msg = struct.pack(">I", zlib.crc32(msg_body)) + msg_body
        # MessageSet entry: offset(8) + size(4) + message
        mset = struct.pack(">qi", 0, len(msg)) + msg
        # ProduceRequest v0: acks(2) timeout(4) [topic [partition mset]]
        req_body = (struct.pack(">hi", 1, int(self.timeout * 1000))
                    + struct.pack(">i", 1) + _kafka_str(self.topic.encode())
                    + struct.pack(">i", 1) + struct.pack(">i", 0)
                    + struct.pack(">i", len(mset)) + mset)
        # Request header: api_key=0 (Produce), version=0, correlation, client
        header = (struct.pack(">hhi", 0, 0, 1)
                  + _kafka_str(b"minio-tpu"))
        frame = struct.pack(">i", len(header) + len(req_body)) \
            + header + req_body
        s = _connect(self.host, self.port, self.timeout)
        try:
            s.sendall(frame)
            size = struct.unpack(">i", _recv_exact(s, 4))[0]
            resp = _recv_exact(s, size)
            # corr(4) + topics(4) + topic + partitions: [id(4) err(2) off(8)]
            off = 4
            ntopics = struct.unpack_from(">i", resp, off)[0]
            off += 4
            for _ in range(ntopics):
                tlen = struct.unpack_from(">h", resp, off)[0]
                off += 2 + tlen
                nparts = struct.unpack_from(">i", resp, off)[0]
                off += 4
                for _ in range(nparts):
                    _pid, err = struct.unpack_from(">ih", resp, off)
                    off += 4 + 2 + 8
                    if err != 0:
                        raise ConnectionError(f"kafka produce error {err}")
        finally:
            s.close()


# ---------------------------------------------------------------------------
# AMQP 0-9-1 (connection/channel handshake + basic.publish)


def _amqp_frame(ftype: int, channel: int, payload: bytes) -> bytes:
    return struct.pack(">BHI", ftype, channel, len(payload)) \
        + payload + b"\xce"


def _amqp_read_frame(s: socket.socket) -> tuple[int, int, bytes]:
    hdr = _recv_exact(s, 7)
    ftype, channel, size = struct.unpack(">BHI", hdr)
    payload = _recv_exact(s, size)
    if _recv_exact(s, 1) != b"\xce":
        raise ConnectionError("AMQP frame-end missing")
    return ftype, channel, payload


def _amqp_shortstr(b: bytes) -> bytes:
    return struct.pack(">B", len(b)) + b


def _amqp_longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


class AMQPTarget(_SocketTarget):
    """ref pkg/event/target/amqp.go — 0-9-1 PLAIN login then
    basic.publish to a direct exchange/routing key."""

    kind = "amqp"
    env_name = "AMQP"

    def __init__(self, host: str, port: int, exchange: str = "",
                 routing_key: str = "minio-tpu", user: str = "guest",
                 password: str = "guest", **kw):
        super().__init__(host, port, **kw)
        self.exchange = exchange
        self.routing_key = routing_key
        self.user = user
        self.password = password

    def _method(self, cls: int, mid: int, args: bytes = b"") -> bytes:
        return struct.pack(">HH", cls, mid) + args

    def send(self, record: dict) -> None:
        payload = json.dumps(record).encode()
        s = _connect(self.host, self.port, self.timeout)
        try:
            s.sendall(b"AMQP\x00\x00\x09\x01")
            _t, _c, p = _amqp_read_frame(s)          # connection.start
            if struct.unpack(">HH", p[:4]) != (10, 10):
                raise ConnectionError("expected connection.start")
            sasl = b"\x00" + self.user.encode() + b"\x00" \
                + self.password.encode()
            args = (struct.pack(">I", 0)              # client-properties
                    + _amqp_shortstr(b"PLAIN")
                    + _amqp_longstr(sasl)
                    + _amqp_shortstr(b"en_US"))
            s.sendall(_amqp_frame(1, 0, self._method(10, 11, args)))
            _t, _c, p = _amqp_read_frame(s)          # connection.tune
            if struct.unpack(">HH", p[:4]) != (10, 30):
                raise ConnectionError("expected connection.tune")
            chmax, fmax, hb = struct.unpack(">HIH", p[4:12])
            s.sendall(_amqp_frame(1, 0, self._method(
                10, 31, struct.pack(">HIH", chmax or 1, fmax, 0))))
            s.sendall(_amqp_frame(1, 0, self._method(
                10, 40, _amqp_shortstr(b"/") + b"\x00\x00")))
            _t, _c, p = _amqp_read_frame(s)          # connection.open-ok
            if struct.unpack(">HH", p[:4]) != (10, 41):
                raise ConnectionError("expected connection.open-ok")
            s.sendall(_amqp_frame(1, 1, self._method(
                20, 10, _amqp_shortstr(b""))))       # channel.open
            _t, _c, p = _amqp_read_frame(s)
            if struct.unpack(">HH", p[:4]) != (20, 11):
                raise ConnectionError("expected channel.open-ok")
            # basic.publish (60,40): reserved + exchange + rkey + flags
            s.sendall(_amqp_frame(1, 1, self._method(
                60, 40, b"\x00\x00"
                + _amqp_shortstr(self.exchange.encode())
                + _amqp_shortstr(self.routing_key.encode()) + b"\x00")))
            # content header: class 60, weight 0, size, no props
            s.sendall(_amqp_frame(2, 1, struct.pack(
                ">HHQH", 60, 0, len(payload), 0)))
            s.sendall(_amqp_frame(3, 1, payload))    # body frame
            # Close the connection and WAIT for close-ok: a broker
            # rejecting the publish (unroutable exchange etc.) sends
            # channel.close/connection.close first, which must become
            # an error so the queuestore retries instead of dropping
            # the event.
            s.sendall(_amqp_frame(1, 0, self._method(
                10, 50, struct.pack(">H", 200)
                + _amqp_shortstr(b"bye") + struct.pack(">HH", 0, 0))))
            while True:
                _t, _c, p = _amqp_read_frame(s)
                cls_mid = struct.unpack(">HH", p[:4])
                if cls_mid == (10, 51):          # connection.close-ok
                    break
                if cls_mid in ((20, 40), (10, 50)):  # broker close
                    code = struct.unpack(">H", p[4:6])[0]
                    raise ConnectionError(
                        f"AMQP publish rejected: code {code}")
        finally:
            s.close()


# ---------------------------------------------------------------------------
# PostgreSQL (simple protocol: startup, trust auth, INSERT via Query)


class PostgresTarget(_SocketTarget):
    """ref pkg/event/target/postgresql.go — one INSERT per event into
    <table>(key, value) via the simple-query protocol (trust auth)."""

    kind = "postgresql"
    env_name = "POSTGRES"

    def __init__(self, host: str, port: int, table: str = "minio_tpu",
                 user: str = "postgres", database: str = "postgres",
                 **kw):
        super().__init__(host, port, **kw)
        self.table = table
        self.user = user
        self.database = database

    def send(self, record: dict) -> None:
        payload = json.dumps(record).replace("'", "''")
        key = _key_of(record).replace("'", "''")
        s = _connect(self.host, self.port, self.timeout)
        try:
            params = (b"user\x00" + self.user.encode() + b"\x00"
                      + b"database\x00" + self.database.encode()
                      + b"\x00\x00")
            body = struct.pack(">I", 196608) + params   # protocol 3.0
            s.sendall(struct.pack(">I", len(body) + 4) + body)
            # Read until ReadyForQuery ('Z'); require AuthenticationOk.
            authed = False
            while True:
                tag = _recv_exact(s, 1)
                size = struct.unpack(">I", _recv_exact(s, 4))[0]
                data = _recv_exact(s, size - 4)
                if tag == b"R":
                    if struct.unpack(">I", data[:4])[0] != 0:
                        raise ConnectionError(
                            "postgres requires auth (trust only)")
                    authed = True
                elif tag == b"E":
                    raise ConnectionError(f"postgres error: {data!r}")
                elif tag == b"Z":
                    break
            if not authed:
                raise ConnectionError("postgres never authenticated")
            sql = (f"INSERT INTO {self.table} (event_key, event_value) "
                   f"VALUES ('{key}', '{payload}')")
            q = sql.encode() + b"\x00"
            s.sendall(b"Q" + struct.pack(">I", len(q) + 4) + q)
            while True:
                tag = _recv_exact(s, 1)
                size = struct.unpack(">I", _recv_exact(s, 4))[0]
                data = _recv_exact(s, size - 4)
                if tag == b"E":
                    raise ConnectionError(f"postgres error: {data!r}")
                if tag == b"Z":
                    break
        finally:
            s.close()


# ---------------------------------------------------------------------------
# MySQL (handshake v10 + mysql_native_password + COM_QUERY INSERT)


def _mysql_scramble(password: bytes, salt: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha1(password).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


class MySQLTarget(_SocketTarget):
    """ref pkg/event/target/mysql.go — mysql_native_password login and
    one INSERT per event."""

    kind = "mysql"
    env_name = "MYSQL"

    def __init__(self, host: str, port: int, table: str = "minio_tpu",
                 user: str = "root", password: str = "",
                 database: str = "minio_tpu", **kw):
        super().__init__(host, port, **kw)
        self.table = table
        self.user = user
        self.password = password
        self.database = database

    @staticmethod
    def _read_packet(s: socket.socket) -> tuple[int, bytes]:
        hdr = _recv_exact(s, 4)
        size = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
        return hdr[3], _recv_exact(s, size)

    @staticmethod
    def _packet(seq: int, body: bytes) -> bytes:
        n = len(body)
        return bytes((n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF,
                      seq)) + body

    def send(self, record: dict) -> None:
        def esc(text: str) -> str:
            # MySQL treats backslash as an escape char even inside
            # '...' strings: double it BEFORE doubling quotes, or an
            # object key ending in a backslash re-opens the string
            # (SQL injection via key names).
            return text.replace("\\", "\\\\").replace("'", "''")
        payload = esc(json.dumps(record))
        key = esc(_key_of(record))
        s = _connect(self.host, self.port, self.timeout)
        try:
            _seq, greet = self._read_packet(s)
            if greet[0] != 10:
                raise ConnectionError("unsupported mysql protocol")
            rest = greet[1:]
            nul = rest.index(b"\x00")
            rest = rest[nul + 1:]
            salt1 = rest[4:12]
            # skip filler, capability low, charset, status, cap high,
            # auth len, 10 reserved
            salt2 = rest[12 + 1 + 2 + 2 + 1 + 2 + 2 + 10:][:12]
            scramble = _mysql_scramble(self.password.encode(),
                                       salt1 + salt2)
            # CLIENT_LONG_PASSWORD | PROTOCOL_41 | SECURE_CONNECTION
            # | CONNECT_WITH_DB (db name trails the auth response).
            caps = 0x00000001 | 0x00000200 | 0x00008000 | 0x00000008
            body = (struct.pack("<IIB", caps, 1 << 24, 33)
                    + b"\x00" * 23 + self.user.encode() + b"\x00"
                    + bytes([len(scramble)]) + scramble
                    + self.database.encode() + b"\x00")
            s.sendall(self._packet(1, body))
            _seq, ok = self._read_packet(s)
            if ok[:1] == b"\xff":
                raise ConnectionError(f"mysql auth failed: {ok[3:]!r}")
            sql = (f"INSERT INTO {self.table} (event_key, event_value) "
                   f"VALUES ('{key}', '{payload}')")
            s.sendall(self._packet(0, b"\x03" + sql.encode()))
            _seq, resp = self._read_packet(s)
            if resp[:1] == b"\xff":
                raise ConnectionError(f"mysql insert failed: {resp[3:]!r}")
        finally:
            s.close()


# ---------------------------------------------------------------------------
# env config (ref config/notify subsystem env conventions:
# MINIO_NOTIFY_<SINK>_ENABLE / _ADDRESS ("host:port") / sink knobs)


def targets_from_env(env=None) -> list[Target]:
    """Instantiate every broker sink enabled via environment. Each may
    additionally set MINIO_NOTIFY_<SINK>_QUEUE_DIR for disk-backed
    retry (wrapped by the caller, same as the webhook sink)."""
    import os as _os
    env = env if env is not None else _os.environ
    out: list[Target] = []

    def addr(name, default_port):
        raw = env.get(f"MINIO_NOTIFY_{name}_ADDRESS", "")
        host, _, port = raw.partition(":")
        return host or "127.0.0.1", int(port or default_port)

    def on(name):
        return env.get(f"MINIO_NOTIFY_{name}_ENABLE", "") == "on"

    if on("NATS"):
        h, p = addr("NATS", 4222)
        out.append(NATSTarget(
            h, p, subject=env.get("MINIO_NOTIFY_NATS_SUBJECT",
                                  "minio-tpu")))
    if on("NSQ"):
        h, p = addr("NSQ", 4150)
        out.append(NSQTarget(
            h, p, topic=env.get("MINIO_NOTIFY_NSQ_TOPIC", "minio-tpu")))
    if on("MQTT"):
        h, p = addr("MQTT", 1883)
        out.append(MQTTTarget(
            h, p, topic=env.get("MINIO_NOTIFY_MQTT_TOPIC", "minio-tpu")))
    if on("REDIS"):
        h, p = addr("REDIS", 6379)
        out.append(RedisTarget(
            h, p, key=env.get("MINIO_NOTIFY_REDIS_KEY", "minio-tpu"),
            fmt=env.get("MINIO_NOTIFY_REDIS_FORMAT", "access")))
    if on("ELASTICSEARCH"):
        out.append(ElasticsearchTarget(
            env.get("MINIO_NOTIFY_ELASTICSEARCH_URL",
                    "http://127.0.0.1:9200"),
            index=env.get("MINIO_NOTIFY_ELASTICSEARCH_INDEX",
                          "minio-tpu")))
    if on("KAFKA"):
        h, p = addr("KAFKA", 9092)
        out.append(KafkaTarget(
            h, p, topic=env.get("MINIO_NOTIFY_KAFKA_TOPIC",
                                "minio-tpu")))
    if on("AMQP"):
        h, p = addr("AMQP", 5672)
        out.append(AMQPTarget(
            h, p,
            exchange=env.get("MINIO_NOTIFY_AMQP_EXCHANGE", ""),
            routing_key=env.get("MINIO_NOTIFY_AMQP_ROUTING_KEY",
                                "minio-tpu"),
            user=env.get("MINIO_NOTIFY_AMQP_USER", "guest"),
            password=env.get("MINIO_NOTIFY_AMQP_PASSWORD", "guest")))
    if on("POSTGRES"):
        h, p = addr("POSTGRES", 5432)
        out.append(PostgresTarget(
            h, p, table=env.get("MINIO_NOTIFY_POSTGRES_TABLE",
                                "minio_tpu"),
            user=env.get("MINIO_NOTIFY_POSTGRES_USER", "postgres"),
            database=env.get("MINIO_NOTIFY_POSTGRES_DATABASE",
                             "postgres")))
    if on("MYSQL"):
        h, p = addr("MYSQL", 3306)
        out.append(MySQLTarget(
            h, p, table=env.get("MINIO_NOTIFY_MYSQL_TABLE", "minio_tpu"),
            user=env.get("MINIO_NOTIFY_MYSQL_USER", "root"),
            password=env.get("MINIO_NOTIFY_MYSQL_PASSWORD", ""),
            database=env.get("MINIO_NOTIFY_MYSQL_DATABASE",
                             "minio_tpu")))
    return out
