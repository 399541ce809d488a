"""The device-free pieces of the port's S3 front door, held to the JAX
package's on the same seeded inputs: SigV4 (canonical requests, header
signatures, presigned URLs, aws-chunked chains, V2), the XML builder and
the error table, IAM policy evaluation, bucket-event rule matching,
object lock (retention and legal-hold parsing, PUT headers, delete and
update checks) and QoS admission (request classes, gate decisions).

Each case draws its inputs from a numpy generator with a fixed seed and
compares what the two packages return, or the error each raises."""

from __future__ import annotations

import json

import numpy as np
import pytest

from minio_tpu.bucket import objectlock as ref_ol
from minio_tpu.event import event as ref_ev
from minio_tpu.event import rules as ref_rules
from minio_tpu.iam import policy as ref_policy
from minio_tpu.qos import admission as ref_adm
from minio_tpu.qos.deadline import Deadline as RefDeadline
from minio_tpu.s3 import errors as ref_errors
from minio_tpu.s3 import sigv4 as ref_sigv4
from minio_tpu.s3 import xmlutil as ref_xml
from minio_tpu_torch.bucket import objectlock as ol
from minio_tpu_torch.event import event as ev
from minio_tpu_torch.event import rules
from minio_tpu_torch.iam import policy
from minio_tpu_torch.qos import admission as adm
from minio_tpu_torch.qos.deadline import Deadline
from minio_tpu_torch.s3 import errors
from minio_tpu_torch.s3 import sigv4
from minio_tpu_torch.s3 import xmlutil

SEEDS = range(8)
AMZ_TIME = 1_760_000_000.0
ALPHABET = list("abcXYZ019-_.~/ +=&%日")


def outcome(fn, *args, **kw):
    """(value, None) or (None, the error's class name and text)."""
    try:
        return fn(*args, **kw), None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return None, (type(e).__name__, str(e))


def rstr(rng, lo=1, hi=12, alphabet=ALPHABET) -> str:
    return "".join(rng.choice(alphabet, rng.integers(lo, hi)))


def rquery(rng) -> str:
    pairs = []
    for _ in range(rng.integers(0, 6)):
        k = rstr(rng, 1, 6, list("abcXYZ-_"))
        v = rstr(rng, 0, 8)
        pairs.append(f"{k}={v}" if rng.random() < 0.8 else k)
    return "&".join(pairs)


def rheaders(rng, host="127.0.0.1:9000") -> dict:
    h = {"host": host}
    for _ in range(rng.integers(0, 5)):
        h["x-amz-meta-" + rstr(rng, 1, 6, list("abcxyz"))] = \
            "  " + rstr(rng, 0, 10, list("abc XYZ  01")) + " "
    if rng.random() < 0.5:
        h["content-type"] = "application/x-" + rstr(rng, 1, 5,
                                                    list("abc"))
    return h


def rpath(rng) -> str:
    return "/" + "/".join(rstr(rng, 1, 8) for _ in
                          range(rng.integers(1, 4)))


# ---------------------------------------------------------------------------
# SigV4


@pytest.mark.parametrize("seed", SEEDS)
def test_canonical_query_and_request_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        q = rquery(rng)
        assert sigv4.canonical_query(q) == ref_sigv4.canonical_query(q)
        h = rheaders(rng)
        signed = sorted(h)
        path = rpath(rng)
        args = ("PUT", path, q, h, signed, "UNSIGNED-PAYLOAD")
        assert sigv4._canonical_request(*args) == \
            ref_sigv4._canonical_request(*args)


@pytest.mark.parametrize("seed", SEEDS)
def test_header_signatures_match_and_verify_across(seed):
    rng = np.random.default_rng(seed)
    lookup = {"AKID": "secret/key+1"}.get
    for _ in range(6):
        method = str(rng.choice(["GET", "PUT", "POST", "HEAD", "DELETE"]))
        path, q, h = rpath(rng), rquery(rng), rheaders(rng)
        body = rng.integers(0, 256, rng.integers(0, 300),
                            dtype=np.uint8).tobytes()
        region = str(rng.choice(["us-east-1", "eu-west-2"]))
        mine = sigv4.sign_request(method, path, q, h, body, "AKID",
                                  "secret/key+1", region, AMZ_TIME)
        theirs = ref_sigv4.sign_request(method, path, q, h, body, "AKID",
                                        "secret/key+1", region, AMZ_TIME)
        assert mine == theirs
        sha = mine["x-amz-content-sha256"]
        assert sigv4.verify_header_auth(method, path, q, mine, sha, lookup,
                                        now=AMZ_TIME) == "AKID"
        assert ref_sigv4.verify_header_auth(method, path, q, mine, sha,
                                            lookup, now=AMZ_TIME) == "AKID"
        # One flipped byte of the signature, a wrong secret, a skewed
        # clock: the same error from both.
        bad = dict(mine, authorization=mine["authorization"][:-1] + (
            "0" if mine["authorization"][-1] != "0" else "1"))
        for hdrs, lk, now in ((bad, lookup, AMZ_TIME),
                              (mine, {"AKID": "other"}.get, AMZ_TIME),
                              (mine, {}.get, AMZ_TIME),
                              (mine, lookup, AMZ_TIME + 3600)):
            got = outcome(sigv4.verify_header_auth, method, path, q, hdrs,
                          sha, lk, now=now)
            want = outcome(ref_sigv4.verify_header_auth, method, path, q,
                           hdrs, sha, lk, now=now)
            assert got[1] is not None
            assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_presigned_urls_match_and_verify_across(seed):
    rng = np.random.default_rng(seed)
    lookup = {"AK": "SK"}.get
    for _ in range(4):
        path = rpath(rng).replace(" ", "%20")
        expires = int(rng.integers(1, 7 * 86400))
        extra = {"response-content-type": "text/plain"} \
            if rng.random() < 0.5 else None
        url = sigv4.presign_url("GET", "h:1", path, "AK", "SK", expires,
                                amz_time=AMZ_TIME, extra_query=extra)
        assert url == ref_sigv4.presign_url("GET", "h:1", path, "AK", "SK",
                                            expires, amz_time=AMZ_TIME,
                                            extra_query=extra)
        query = url.split("?", 1)[1]
        for now in (AMZ_TIME + 1, AMZ_TIME + expires + 1):
            got = outcome(sigv4.verify_presigned, "GET", path, query,
                          {"host": "h:1"}, lookup, now=now)
            want = outcome(ref_sigv4.verify_presigned, "GET", path, query,
                           {"host": "h:1"}, lookup, now=now)
            assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_streaming_chains_match_and_decode_across(seed):
    rng = np.random.default_rng(seed)
    body = rng.integers(0, 256, int(rng.integers(0, 50_000)),
                        dtype=np.uint8).tobytes()
    chunk = int(rng.integers(1000, 20_000))
    h = {"host": "h:1"}
    mine = sigv4.sign_streaming_request("PUT", "/b/k", "", h, body, "AK",
                                        "SK", chunk_size=chunk,
                                        amz_time=AMZ_TIME)
    assert mine == ref_sigv4.sign_streaming_request(
        "PUT", "/b/k", "", h, body, "AK", "SK", chunk_size=chunk,
        amz_time=AMZ_TIME)
    hdrs, wire = mine
    cred, _, seed_sig = sigv4.parse_auth_fields(hdrs)
    rcred, _, _ = ref_sigv4.parse_auth_fields(hdrs)
    amz = hdrs["x-amz-date"]
    assert sigv4.decode_streaming(wire, "SK", cred, amz, seed_sig) == body
    assert ref_sigv4.decode_streaming(wire, "SK", rcred, amz,
                                      seed_sig) == body
    torn = wire[:len(wire) // 2] + bytes([wire[len(wire) // 2] ^ 1]) + \
        wire[len(wire) // 2 + 1:]
    got = outcome(sigv4.decode_streaming, torn, "SK", cred, amz, seed_sig)
    want = outcome(ref_sigv4.decode_streaming, torn, "SK", rcred, amz,
                   seed_sig)
    assert (got[0], got[1] and got[1][1]) == (want[0], want[1] and
                                              want[1][1])


@pytest.mark.parametrize("seed", SEEDS)
def test_v2_signatures_match(seed):
    rng = np.random.default_rng(seed)
    lookup = {"AK": "SK"}.get
    for _ in range(5):
        h = dict(rheaders(rng), date="Tue, 14 Oct 2025 10:00:00 GMT")
        q = str(rng.choice(["", "acl", "uploads", "versionId=3&foo=1",
                            "tagging&x=2"]))
        path = rpath(rng)
        mine = sigv4.sign_request_v2("GET", path, q, h, "AK", "SK")
        assert mine == ref_sigv4.sign_request_v2("GET", path, q, h, "AK",
                                                 "SK")
        assert sigv4.verify_header_auth_v2("GET", path, q, mine,
                                           lookup) == "AK"
        assert ref_sigv4.verify_header_auth_v2("GET", path, q, mine,
                                               lookup) == "AK"


# ---------------------------------------------------------------------------
# The XML builder and the error table


def build(mod, rng_seed: int) -> bytes:
    rng = np.random.default_rng(rng_seed)
    root = mod.Element("ListBucketResult", xmlns=mod.S3_XMLNS)
    for _ in range(rng.integers(1, 8)):
        c = root.child("Contents")
        c.child("Key", rstr(rng, 1, 10, ALPHABET + list("<>&\"'")))
        c.child("Size", str(int(rng.integers(0, 1 << 40))))
    return root.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_xml_documents_match(seed):
    mine, theirs = build(xmlutil, seed), build(ref_xml, seed)
    assert mine == theirs
    assert [e.text for e in xmlutil.parse(mine).iter()] == \
        [e.text for e in ref_xml.parse(theirs).iter()]


def test_error_table_matches():
    names = sorted(n for n in dir(ref_errors) if n.startswith("ERR_"))
    assert names == sorted(n for n in dir(errors) if n.startswith("ERR_"))
    for n in names:
        a, b = getattr(errors, n), getattr(ref_errors, n)
        assert (a.code, a.description, a.http_status, a.xml("/r", "1")) == \
            (b.code, b.description, b.http_status, b.xml("/r", "1")), n


def test_storage_errors_map_alike():
    from minio_tpu.storage import errors as ref_serr
    from minio_tpu_torch.storage import errors as serr
    names = sorted(n for n, v in vars(ref_serr).items()
                   if isinstance(v, type) and issubclass(v, Exception))
    for n in names:
        if not hasattr(serr, n):
            continue
        a = errors.storage_api_error(getattr(serr, n)("x"))
        b = ref_errors.storage_api_error(getattr(ref_serr, n)("x"))
        assert (a and (a.code, a.http_status)) == \
            (b and (b.code, b.http_status)), n


# ---------------------------------------------------------------------------
# IAM policy evaluation

ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject",
           "s3:ListBucket", "s3:*", "s3:Get*", "admin:*"]
RESOURCES = ["arn:aws:s3:::photos/*", "arn:aws:s3:::photos",
             "arn:aws:s3:::*", "arn:aws:s3:::logs/2024/*",
             "arn:aws:s3:::ph?tos/*", "*"]


def rpolicy(rng) -> dict:
    stmts = []
    for _ in range(rng.integers(1, 4)):
        st = {"Effect": str(rng.choice(["Allow", "Deny"])),
              "Resource": list(rng.choice(RESOURCES,
                                          rng.integers(1, 3)))}
        if rng.random() < 0.2:
            st["NotAction"] = str(rng.choice(ACTIONS))
        else:
            st["Action"] = list(rng.choice(ACTIONS, rng.integers(1, 3)))
        if rng.random() < 0.3:
            st["Principal"] = str(rng.choice(["*", "alice"])) \
                if rng.random() < 0.5 else {"AWS": ["alice", "bo*"]}
        if rng.random() < 0.3:
            op = str(rng.choice(["StringEquals", "StringNotEquals",
                                 "StringLike", "IpAddress", "Bogus"]))
            st["Condition"] = {op: {"s3:prefix": ["2024/*", "a"]}}
        stmts.append(st)
    return {"Version": "2012-10-17", "Statement": stmts}


@pytest.mark.parametrize("seed", SEEDS)
def test_policy_decisions_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(15):
        doc = json.dumps(rpolicy(rng))
        mine = policy.Policy.from_json(doc)
        theirs = ref_policy.Policy.from_json(doc)
        for _ in range(12):
            action = str(rng.choice(ACTIONS[:4] + ["s3:GetBucketPolicy"]))
            res = str(rng.choice(["photos/a.jpg", "photos", "logs/2024/x",
                                  "phatos/b", "other/k"]))
            who = str(rng.choice(["", "alice", "bob", "carol"]))
            ctx = {"s3:prefix": str(rng.choice(["2024/x", "a", "b"]))} \
                if rng.random() < 0.5 else None
            assert mine.is_allowed(action, res, who, ctx) == \
                theirs.is_allowed(action, res, who, ctx)


@pytest.mark.parametrize("seed", SEEDS)
def test_wildcard_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        pat = rstr(rng, 0, 6, list("ab*?[]"))
        s = rstr(rng, 0, 8, list("ab[]/"))
        assert policy.wildcard_match(pat, s) == \
            ref_policy.wildcard_match(pat, s)


# ---------------------------------------------------------------------------
# Bucket-event rules

EVENTS = ["s3:ObjectCreated:*", "s3:ObjectCreated:Put",
          "s3:ObjectRemoved:*", "s3:ObjectAccessed:Get",
          "s3:ObjectCreated:CompleteMultipartUpload"]


def rnotification(rng) -> str:
    out = ["<NotificationConfiguration>"]
    for i in range(rng.integers(1, 4)):
        tag, arn_tag = [("QueueConfiguration", "Queue"),
                        ("TopicConfiguration", "Topic"),
                        ("CloudFunctionConfiguration", "CloudFunction")
                        ][int(rng.integers(0, 3))]
        out.append(f"<{tag}><Id>r{i}</Id><{arn_tag}>arn:minio:sqs::"
                   f"{i}:webhook</{arn_tag}>")
        for e in rng.choice(EVENTS, rng.integers(1, 3), replace=False):
            out.append(f"<Event>{e}</Event>")
        rules_xml = ""
        if rng.random() < 0.6:
            rules_xml += ("<FilterRule><Name>prefix</Name><Value>"
                          f"{rstr(rng, 0, 4, list('ab/'))}</Value>"
                          "</FilterRule>")
        if rng.random() < 0.6:
            rules_xml += ("<FilterRule><Name>suffix</Name><Value>"
                          f"{rstr(rng, 0, 4, list('.jpgb'))}</Value>"
                          "</FilterRule>")
        if rules_xml:
            out.append(f"<Filter><S3Key>{rules_xml}</S3Key></Filter>")
        out.append(f"</{tag}>")
    out.append("</NotificationConfiguration>")
    return "".join(out)


@pytest.mark.parametrize("seed", SEEDS)
def test_event_rules_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        xml = rnotification(rng)
        mine = rules.parse_notification_xml(xml)
        theirs = ref_rules.parse_notification_xml(xml)
        assert mine.rules == theirs.rules
        for _ in range(20):
            name = str(rng.choice([e.replace("*", "Put") for e in EVENTS]
                                  + ["s3:ObjectRemoved:Delete"]))
            key = rstr(rng, 0, 8, list("ab/.jpg"))
            assert mine.match(name, key) == theirs.match(name, key)
    for name in EVENTS + ["s3:ObjectRemoved:DeleteMarkerCreated"]:
        assert ev.expand_event_name(name) == ref_ev.expand_event_name(name)


def test_event_records_match():
    kw = dict(event_name="s3:ObjectCreated:Put", bucket="b", key="a b/c",
              size=12, etag="abc", version_id="v1", user_identity="AK",
              sequencer="0001", event_time=1_760_000_000.25)
    assert ev.Event(**kw).to_record() == ref_ev.Event(**kw).to_record()


# ---------------------------------------------------------------------------
# Object lock

NOW = 1_760_000_000.0


@pytest.mark.parametrize("raw", [
    b"<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>"
    b"2030-01-01T00:00:00Z</RetainUntilDate></Retention>",
    b"<Retention><Mode>COMPLIANCE</Mode><RetainUntilDate>"
    b"2030-01-01T00:00:00.123Z</RetainUntilDate></Retention>",
    b"<Retention><Mode>BOGUS</Mode><RetainUntilDate>"
    b"2030-01-01T00:00:00Z</RetainUntilDate></Retention>",
    b"<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>"
    b"not a date</RetainUntilDate></Retention>",
    b"<LegalHold><Status>ON</Status></LegalHold>",
    b"<LegalHold><Status>maybe</Status></LegalHold>",
])
def test_retention_and_legal_hold_parsing(raw):
    fn = "parse_legal_hold_xml" if b"LegalHold" in raw \
        else "parse_retention_xml"
    got = outcome(getattr(ol, fn), raw)
    want = outcome(getattr(ref_ol, fn), raw)
    assert got == want


@pytest.mark.parametrize("raw", [
    "", ol.ENABLED_XML,
    "<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled>"
    "<Rule><DefaultRetention><Mode>GOVERNANCE</Mode><Days>3</Days>"
    "</DefaultRetention></Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled>"
    "<Rule><DefaultRetention><Mode>COMPLIANCE</Mode><Years>1</Years>"
    "</DefaultRetention></Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>COMPLIANCE"
    "</Mode><Days>1</Days><Years>1</Years></DefaultRetention></Rule>"
    "</ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>X</Mode>"
    "<Days>1</Days></DefaultRetention></Rule></ObjectLockConfiguration>",
])
def test_lock_config_parsing(raw):
    got = outcome(ol.ObjectLockConfig.from_xml, raw)
    want = outcome(ref_ol.ObjectLockConfig.from_xml, raw)
    assert (got[0] and repr(got[0]), got[1]) == \
        (want[0] and repr(want[0]), want[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_lock_put_headers_and_checks(seed):
    rng = np.random.default_rng(seed)
    cfg_xml = str(rng.choice([
        "", ol.ENABLED_XML,
        "<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
        "</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE"
        "</Mode><Days>2</Days></DefaultRetention></Rule>"
        "</ObjectLockConfiguration>"]))
    cfg, rcfg = (ol.ObjectLockConfig.from_xml(cfg_xml),
                 ref_ol.ObjectLockConfig.from_xml(cfg_xml))
    for _ in range(15):
        hdrs = {}
        if rng.random() < 0.6:
            hdrs[ol.META_MODE] = str(rng.choice(
                ["GOVERNANCE", "COMPLIANCE", "NOPE", ""]))
        if rng.random() < 0.6:
            hdrs[ol.META_RETAIN_UNTIL] = str(rng.choice(
                ["2030-01-01T00:00:00Z", "2001-01-01T00:00:00Z", "junk"]))
        if rng.random() < 0.3:
            hdrs[ol.META_LEGAL_HOLD] = str(rng.choice(["ON", "OFF", "x"]))
        m1, m2 = {}, {}
        a = outcome(ol.apply_put_headers, hdrs, cfg, m1, now=NOW)
        b = outcome(ref_ol.apply_put_headers, hdrs, rcfg, m2, now=NOW)
        assert (a, m1) == (b, m2)
        bypass = bool(rng.random() < 0.5)
        for now in (NOW, NOW + 10 * 365 * 86400.0):
            assert ol.retention_active(m1, now) == \
                ref_ol.retention_active(m2, now)
            assert outcome(ol.check_version_delete, m1, bypass, now) == \
                outcome(ref_ol.check_version_delete, m2, bypass, now)
        mode = str(rng.choice(["GOVERNANCE", "COMPLIANCE"]))
        until = NOW + float(rng.integers(-86400, 86400 * 30))
        assert outcome(ol.check_retention_update, m1, mode, until, bypass,
                       NOW) == outcome(ref_ol.check_retention_update, m2,
                                       mode, until, bypass, NOW)


# ---------------------------------------------------------------------------
# QoS admission


@pytest.mark.parametrize("seed", SEEDS)
def test_request_classes_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        method = str(rng.choice(["GET", "HEAD", "PUT", "POST", "DELETE"]))
        bucket = str(rng.choice(["", "b"]))
        key = str(rng.choice(["", "k", "a/b"])) if bucket else ""
        params = tuple(rng.choice(["select", "uploads", "tagging"],
                                  rng.integers(0, 2)))
        assert adm.classify(method, bucket, key, params) == \
            ref_adm.classify(method, bucket, key, params)


def drive_gates(mod, deadline_cls, script) -> list:
    """Run one admission script (single-threaded, so every decision is
    deterministic): acquire with a deadline of 0 or 2 ms, release,
    reconfigure. Returns what happened at each step."""
    ac = mod.AdmissionController()
    held, out = [], []
    for op, arg in script:
        if op == "configure":
            ac.configure(*arg)
            out.append(("cfg", ac.engaged, [ac.limit_for(c) for c in
                                            mod.API_CLASSES]))
        elif op == "acquire":
            cls, budget = arg
            # A waiter gets no release (one thread), so any budget runs
            # out: every over-cap decision is the same shed, at once or
            # after ``budget``.
            ddl = deadline_cls(budget)
            try:
                held.append(ac.acquire(cls, ddl).__enter__())
                out.append(("ok", cls, ac.foreground_inflight()))
            except mod.AdmissionShed as e:
                out.append(("shed", e.api_class, e.reason, e.retry_after))
        elif op == "release" and held:
            held.pop(int(arg) % len(held)).__exit__(None, None, None)
            out.append(("rel", ac.foreground_inflight()))
    while held:
        held.pop().__exit__(None, None, None)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_admission_decisions_match(seed):
    rng = np.random.default_rng(seed)
    classes = list(ref_adm.API_CLASSES)
    assert list(adm.API_CLASSES) == classes
    script = []
    for _ in range(40):
        r = rng.random()
        if r < 0.1:
            script.append(("configure", (
                int(rng.integers(0, 4)),
                {c: int(rng.integers(0, 3)) for c in classes},
                float(rng.integers(0, 20)))))
        elif r < 0.7:
            script.append(("acquire", (str(rng.choice(classes)),
                                       float(rng.choice([0.0, 0.002])))))
        else:
            script.append(("release", int(rng.integers(0, 10))))
    assert drive_gates(adm, Deadline, script) == \
        drive_gates(ref_adm, RefDeadline, script)
