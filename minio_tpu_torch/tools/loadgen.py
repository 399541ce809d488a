"""Threaded S3 load generator: target QPS (or closed-loop), mixed
PUT/GET, latency percentiles on stdout. Dependency-free — drives the
server with the same stdlib SigV4 client the test suite uses.

The port's own copy of ``tools/loadgen.py``, with no change in behaviour:
the same names, arguments and report schema, its SigV4 client and signer
those of ``minio_tpu_torch.s3`` (stdlib only), so a client process imports
neither torch nor JAX nor the JAX package.

CLI:
    python -m minio_tpu_torch.tools.loadgen --port 9000 --bucket bench \\
        --concurrency 16 --duration 5 --put-fraction 0.5 --size 1048576

Library:
    from minio_tpu_torch.tools.loadgen import run_load
    report = run_load("127.0.0.1", port, access, secret, "bench", ...)
"""

from __future__ import annotations

import argparse
import json
import random
import threading
import time
import urllib.parse


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of a pre-sorted list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[idx]


class _Zipf:
    """Zipfian rank sampler: P(rank r) ~ 1/r^s over key_space ranks —
    the canonical hot-key GET mix (rank 1 is the hottest key). Sampling
    is an inverse-CDF bisect over the precomputed cumulative weights,
    so per-request cost stays O(log keys)."""

    def __init__(self, s: float, n: int):
        import bisect as _b
        self._bisect = _b.bisect_left
        weights = [1.0 / ((r + 1) ** s) for r in range(n)]
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        self._cdf = cdf

    def sample(self, rng: random.Random) -> int:
        return min(self._bisect(self._cdf, rng.random()),
                   len(self._cdf) - 1)


def _key_shares(counts: dict[str, int]) -> dict:
    """Per-key-percentile concentration of the achieved mix: the
    fraction of all requests that landed on the hottest 1% / 10% / 25%
    of keys (how 'hot' the hot set really was — the number a cache hit
    ratio should be judged against)."""
    if not counts:
        return {}
    ranked = sorted(counts.values(), reverse=True)
    total = sum(ranked)

    def share(pct: float) -> float:
        n = max(1, int(round(len(ranked) * pct / 100.0)))
        return round(sum(ranked[:n]) / total, 4)

    return {"distinct_keys": len(ranked),
            "top1pct_share": share(1),
            "top10pct_share": share(10),
            "top25pct_share": share(25)}


class _Pacer:
    """Token pacing toward a target QPS; qps <= 0 = closed loop (each
    worker fires as fast as its previous request completes)."""

    def __init__(self, qps: float):
        self.qps = qps
        self._mu = threading.Lock()
        self._next = time.monotonic()

    def wait(self) -> None:
        if self.qps <= 0:
            return
        with self._mu:
            now = time.monotonic()
            slot = max(self._next, now)
            self._next = slot + 1.0 / self.qps
        delay = slot - time.monotonic()
        if delay > 0:
            time.sleep(delay)


def run_load(host: str, port: int, access_key: str, secret_key: str,
             bucket: str, *, concurrency: int = 8, duration: float = 5.0,
             qps: float = 0.0, put_fraction: float = 0.5,
             object_bytes: int = 1024 * 1024, key_prefix: str = "loadgen",
             key_space: int = 32, seed: int = 0,
             zipf_s: float = 0.0, preload: bool = False,
             buckets: int | list = 1, access_keys: list | None = None,
             tenant_zipf_s: float = 0.0) -> dict:
    """Drive mixed PUT/GET load; returns the aggregate report dict.

    GETs address keys the run has already PUT (a GET before any PUT
    completes falls back to a PUT), so the mix self-bootstraps on an
    empty bucket. Latencies are per-request wall time in milliseconds;
    every non-2xx status is counted by code, 503s also by error code
    parsed from the XML body (SlowDown vs RequestTimeout).

    ``zipf_s`` > 0 switches key selection to a Zipfian rank
    distribution over a SHARED key space of ``key_space`` keys
    (``{key_prefix}/z{rank}``) — the realistic hot-key GET mix for
    cache benchmarks; the report then carries the achieved per-key
    concentration (``key_distribution``). ``preload`` PUTs the whole
    key space once before the timed window (outside the stats), so a
    pure-GET Zipfian run never 404s.

    **Multi-tenant mode**: ``buckets`` (an int N -> ``{bucket}-0`` ..
    ``{bucket}-{N-1}``, or an explicit name list) and/or
    ``access_keys`` (a list of ``(access, secret)`` pairs) define a
    tenant fleet; tenant i uses bucket ``i % len(buckets)`` and
    credential ``i % len(access_keys)``.  ``tenant_zipf_s`` > 0 skews
    the PER-TENANT request mix Zipfian (tenant 0 hottest) — the
    noisy-neighbor fleet shape — and the report carries per-tenant
    request counts and latency percentiles (``tenants``), so the
    bench can judge what the hot tenant did to everyone else."""
    from ..s3.client import S3Client

    body = bytes(bytearray(random.Random(seed).randbytes(object_bytes))
                 ) if object_bytes else b""
    zipf = _Zipf(zipf_s, key_space) if zipf_s > 0 else None
    if isinstance(buckets, int):
        bucket_names = ([bucket] if buckets <= 1
                        else [f"{bucket}-{i}" for i in range(buckets)])
    else:
        bucket_names = list(buckets) or [bucket]
    creds = [(ak, sk) for ak, sk in (access_keys
                                     or [(access_key, secret_key)])]
    n_tenants = max(len(bucket_names), len(creds))

    def tenant(i: int) -> tuple[str, tuple[str, str]]:
        return (bucket_names[i % len(bucket_names)],
                creds[i % len(creds)])

    def tenant_label(i: int) -> str:
        bkt, (ak, _) = tenant(i)
        return bkt if len(creds) == 1 else f"{bkt}|{ak}"

    tzipf = (_Zipf(tenant_zipf_s, n_tenants)
             if tenant_zipf_s > 0 and n_tenants > 1 else None)
    if preload:
        # Preloaded keys live in a SHARED namespace every worker GETs
        # from (z{rank} for Zipf, p{n} uniform) — per-worker {wid}-{n}
        # names would leave every worker but one 404ing. Every
        # tenant's bucket gets the key space (root creds: the fleet's
        # keys may not be allowed to PUT each other's buckets).
        pre = S3Client(host, port, access_key, secret_key)
        for bkt in bucket_names:
            for r in range(key_space):
                key = (f"{key_prefix}/z{r}" if zipf is not None
                       else f"{key_prefix}/p{r}")
                resp = pre.put_object(bkt, key, body)
                if resp.status != 200:
                    raise RuntimeError(
                        f"preload PUT {bkt}/{key} failed: "
                        f"{resp.status}")
    pacer = _Pacer(qps)
    stop_at = time.monotonic() + duration
    mu = threading.Lock()
    lat_ok: list[float] = []
    lat_shed: list[float] = []
    status_counts: dict[int, int] = {}
    error_codes: dict[str, int] = {}
    key_counts: dict[str, int] = {}
    # Per-bucket bootstrap pools + per-tenant stats (multi-tenant).
    put_keys: dict[str, list[str]] = {b: [] for b in bucket_names}
    tstats: dict[int, dict] = {
        i: {"lat_ok": [], "requests": 0, "ok": 0, "shed_503": 0}
        for i in range(n_tenants)}
    retry_after_seen = 0

    def worker(wid: int) -> None:
        nonlocal retry_after_seen
        rng = random.Random(seed * 1000 + wid)
        clients: dict[int, S3Client] = {}
        while time.monotonic() < stop_at:
            pacer.wait()
            ti = (tzipf.sample(rng) if tzipf is not None
                  else rng.randrange(n_tenants)) if n_tenants > 1 else 0
            bkt, cred = tenant(ti)
            ci = ti % len(creds)
            client = clients.get(ci)
            if client is None:
                client = clients[ci] = S3Client(host, port, *cred)
            pool = put_keys[bkt]
            # Bootstrap fallback: a GET with nothing to read yet PUTs
            # instead, so the classic mix self-starts on an empty
            # bucket. Zipf and preload runs assume the shared key
            # space already exists and must NEVER write — a stray PUT
            # would invalidate the very hot keys a cache bench just
            # warmed.
            do_put = rng.random() < put_fraction or (
                not pool and not preload and zipf is None)
            if zipf is not None:
                key = f"{key_prefix}/z{zipf.sample(rng)}"
            elif preload and not do_put:
                key = f"{key_prefix}/p{rng.randrange(key_space)}"
            else:
                key = f"{key_prefix}/{wid}-{rng.randrange(key_space)}"
            t0 = time.perf_counter()
            try:
                if do_put:
                    r = client.put_object(bkt, key, body)
                else:
                    if zipf is not None or preload:
                        gkey = key
                    else:
                        with mu:
                            gkey = rng.choice(pool) if pool else key
                    key = gkey   # report the key actually requested
                    r = client.get_object(bkt, gkey)
                status = r.status
            except Exception:
                status = -1
                r = None
            ms = (time.perf_counter() - t0) * 1e3
            with mu:
                status_counts[status] = status_counts.get(status, 0) + 1
                key_counts[f"{bkt}/{key}"] = \
                    key_counts.get(f"{bkt}/{key}", 0) + 1
                ts = tstats[ti]
                ts["requests"] += 1
                if 200 <= status < 300:
                    lat_ok.append(ms)
                    ts["ok"] += 1
                    ts["lat_ok"].append(ms)
                    if do_put:
                        pool.append(key)
                else:
                    lat_shed.append(ms)
                    if status == 503:
                        ts["shed_503"] += 1
                    if r is not None and status >= 400:
                        code = _xml_code(r.body)
                        error_codes[code] = error_codes.get(code, 0) + 1
                        if "retry-after" in r.headers:
                            retry_after_seen += 1

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(concurrency)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration + 60)
    elapsed = time.monotonic() - t_start

    lat_ok.sort()
    total = sum(status_counts.values())
    ok = len(lat_ok)
    shed = status_counts.get(503, 0)
    report = {
        "requests": total,
        "ok": ok,
        "shed_503": shed,
        "shed_rate": round(shed / total, 4) if total else 0.0,
        "errors_other": total - ok - shed,
        "status_counts": {str(k): v for k, v in
                          sorted(status_counts.items())},
        "error_codes": dict(sorted(error_codes.items())),
        "retry_after_headers": retry_after_seen,
        "qps_achieved": round(total / elapsed, 2) if elapsed else 0.0,
        "latency_ms": {
            "p50": round(_percentile(lat_ok, 50), 3),
            "p90": round(_percentile(lat_ok, 90), 3),
            "p99": round(_percentile(lat_ok, 99), 3),
            "max": round(lat_ok[-1], 3) if lat_ok else 0.0,
        },
        "elapsed_s": round(elapsed, 3),
        "key_distribution": _key_shares(key_counts),
        "config": {"concurrency": concurrency, "duration_s": duration,
                   "qps_target": qps, "put_fraction": put_fraction,
                   "object_bytes": object_bytes, "key_space": key_space,
                   "zipf_s": zipf_s, "tenants": n_tenants,
                   "tenant_zipf_s": tenant_zipf_s},
    }
    if n_tenants > 1:
        tenants: dict[str, dict] = {}
        for i, ts in tstats.items():
            vals = sorted(ts["lat_ok"])
            tenants[tenant_label(i)] = {
                "requests": ts["requests"], "ok": ts["ok"],
                "shed_503": ts["shed_503"],
                "latency_ms": {
                    "p50": round(_percentile(vals, 50), 3),
                    "p90": round(_percentile(vals, 90), 3),
                    "p99": round(_percentile(vals, 99), 3)}}
        report["tenants"] = tenants
    return report


class _LatStats:
    """Percentile accumulator for one metric of one request class."""

    def __init__(self):
        self.vals: list[float] = []

    def add(self, ms: float) -> None:
        self.vals.append(ms)

    def report(self) -> dict:
        vals = sorted(self.vals)
        return {
            "count": len(vals),
            "p50": round(_percentile(vals, 50), 3),
            "p90": round(_percentile(vals, 90), 3),
            "p99": round(_percentile(vals, 99), 3),
            "max": round(vals[-1], 3) if vals else 0.0,
        }


def run_async_load(host: str, port: int, access_key: str,
                   secret_key: str, bucket: str, *,
                   connections: int = 100, duration: float = 5.0,
                   qps: float = 0.0, put_fraction: float = 0.0,
                   object_bytes: int = 64 * 1024,
                   key_prefix: str = "fdload", key_space: int = 32,
                   seed: int = 0, preload: bool = True,
                   connect_batch: int = 512) -> dict:
    """High-concurrency driver for the async front door: one asyncio
    event loop opens and HOLDS ``connections`` keep-alive sockets and
    runs a closed-loop (or ``qps``-paced) GET/PUT mix over them,
    reporting connect / TTFB / total-latency percentiles per class.

    The threaded ``run_load`` tops out at a few hundred sockets (one
    OS thread each) — far below the server it is meant to saturate;
    this driver holds 10k+ with coroutines.  ``qps`` spreads an
    AGGREGATE request rate across all connections (the realistic
    mostly-idle keep-alive regime); ``qps=0`` is fully closed-loop.
    Each request is individually SigV4-signed like every other client
    in this repo."""
    import asyncio

    from ..s3 import sigv4
    from ..s3.asyncserver import raise_nofile_limit

    raise_nofile_limit(connections + 256)
    body = (bytes(random.Random(seed).randbytes(object_bytes))
            if object_bytes else b"")
    if preload:
        from ..s3.client import S3Client
        pre = S3Client(host, port, access_key, secret_key)
        for r in range(key_space):
            resp = pre.put_object(bucket, f"{key_prefix}/p{r}", body)
            if resp.status != 200:
                raise RuntimeError(
                    f"preload PUT p{r} failed: {resp.status}")

    stats = {
        "connect": _LatStats(),
        "get": {"ttfb": _LatStats(), "total": _LatStats()},
        "put": {"ttfb": _LatStats(), "total": _LatStats()},
    }
    counters = {"requests": 0, "ok": 0, "shed_503": 0, "errors": 0,
                "reconnects": 0, "connect_failures": 0}
    status_counts: dict[int, int] = {}

    def _signed(method: str, path: str, payload: bytes) -> bytes:
        hdrs = {"host": f"{host}:{port}",
                "content-length": str(len(payload))}
        hdrs = sigv4.sign_request(method, path, "", hdrs, payload,
                                  access_key, secret_key)
        head = [f"{method} {path} HTTP/1.1\r\n"]
        head.extend(f"{k}: {v}\r\n" for k, v in hdrs.items())
        head.append("\r\n")
        return "".join(head).encode("latin-1")

    async def _read_response(reader) -> tuple[int, bool, float]:
        """(status, keep_alive, ttfb_monotonic) after draining the
        body per Content-Length."""
        head = await reader.readuntil(b"\r\n\r\n")
        ttfb = time.monotonic()
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        hdrs = {}
        for line in lines[1:]:
            k, sep, v = line.partition(":")
            if sep:
                hdrs[k.strip().lower()] = v.strip()
        if status == 100:
            return await _read_response(reader)
        cl = int(hdrs.get("content-length", 0) or 0)
        if cl:
            await reader.readexactly(cl)
        keep = hdrs.get("connection", "").lower() != "close"
        return status, keep, ttfb

    # Aggregate pacer: monotonic slot allocator (single loop, no lock).
    pacer_next = [time.monotonic()]

    async def _pace() -> bool:
        """Reserve the next aggregate-rate slot; False = the window
        closes before this slot (caller exits WITHOUT sending — the
        whole idle fleet piles onto the pacer at window-open, and
        slots past stop_at must not extend the run)."""
        if qps <= 0:
            return True
        slot = max(pacer_next[0], time.monotonic())
        if slot >= stop_at[0]:
            return False
        pacer_next[0] = slot + 1.0 / qps
        delay = slot - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        return True

    sem = asyncio.Semaphore(connect_batch)

    async def _connect(record: bool):
        async with sem:
            t0 = time.monotonic()
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), timeout=30)
            sock = writer.get_extra_info("socket")
            if sock is not None:
                try:
                    import socket as _socket
                    sock.setsockopt(_socket.IPPROTO_TCP,
                                    _socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            if record:
                stats["connect"].add((time.monotonic() - t0) * 1e3)
            return reader, writer

    stop_at = [0.0]
    arrived = [0]
    start_ev: list = []  # [asyncio.Event] once the loop exists

    async def _worker(wid: int) -> None:
        rng = random.Random(seed * 7919 + wid)
        try:
            reader, writer = await _connect(record=True)
        except Exception:
            counters["connect_failures"] += 1
            arrived[0] += 1
            if arrived[0] >= connections:
                start_ev[0].set()
            return
        # Connect barrier: the whole fleet establishes (and idles on
        # keep-alive) BEFORE the timed window opens, so request
        # percentiles measure steady state, not the connect storm.
        arrived[0] += 1
        if arrived[0] >= connections:
            start_ev[0].set()
        await start_ev[0].wait()
        if qps > 0:
            # Paced mode: jitter each connection's entry so 10k idle
            # workers don't stampede the first pacer slots in one
            # loop wakeup — the aggregate rate is the pacer's job,
            # the jitter only de-synchronizes the fleet.
            await asyncio.sleep(rng.random() * min(duration * 0.4,
                                                   2.0))
        try:
            while time.monotonic() < stop_at[0]:
                if not await _pace():
                    break
                do_put = rng.random() < put_fraction
                key = f"{key_prefix}/p{rng.randrange(key_space)}"
                path = f"/{bucket}/{urllib.parse.quote(key)}"
                cls = "put" if do_put else "get"
                payload = body if do_put else b""
                raw = _signed("PUT" if do_put else "GET", path, payload)
                t0 = time.monotonic()
                try:
                    writer.write(raw + payload)
                    await writer.drain()
                    # No per-response wait_for: it would create one
                    # extra task per request — real task churn at 10k
                    # conns. A hung response is bounded by the run's
                    # outer timeout instead.
                    status, keep, ttfb = await _read_response(reader)
                except (OSError, asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError,
                        asyncio.TimeoutError):
                    counters["errors"] += 1
                    counters["reconnects"] += 1
                    try:
                        writer.close()
                    except Exception:  # noqa: BLE001
                        pass
                    try:
                        reader, writer = await _connect(record=False)
                    except Exception:
                        return
                    continue
                now = time.monotonic()
                counters["requests"] += 1
                status_counts[status] = status_counts.get(status, 0) + 1
                if 200 <= status < 300:
                    counters["ok"] += 1
                    stats[cls]["ttfb"].add((ttfb - t0) * 1e3)
                    stats[cls]["total"].add((now - t0) * 1e3)
                elif status == 503:
                    counters["shed_503"] += 1
                else:
                    counters["errors"] += 1
                if not keep:
                    counters["reconnects"] += 1
                    writer.close()
                    try:
                        reader, writer = await _connect(record=False)
                    except Exception:
                        return
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _run() -> float:
        start_ev.append(asyncio.Event())

        win_t0 = [0.0]

        async def _open_window() -> None:
            await start_ev[0].wait()
            # The fleet is established: freeze it out of GC and stop
            # collection for the timed window — a gen-2 pass over 10k
            # connection objects is a multi-ms pause that would read
            # as server tail latency.
            import gc
            gc.collect()
            gc.freeze()
            gc.disable()
            win_t0[0] = time.monotonic()
            stop_at[0] = win_t0[0] + duration
            pacer_next[0] = win_t0[0]

        # Generous far-future stop until the barrier opens the real
        # window (workers check stop_at only after the barrier).
        stop_at[0] = time.monotonic() + duration + 600
        opener = asyncio.ensure_future(_open_window())
        workers = [asyncio.ensure_future(_worker(i))
                   for i in range(connections)]
        t0 = time.monotonic()
        await asyncio.gather(*workers, return_exceptions=True)
        opener.cancel()
        import gc
        gc.enable()
        end = time.monotonic()
        return end - (win_t0[0] or t0)

    elapsed = asyncio.run(_run())
    total = counters["requests"]
    return {
        "connections": connections,
        "established": stats["connect"].report()["count"],
        "connect_failures": counters["connect_failures"],
        "reconnects": counters["reconnects"],
        "requests": total,
        "ok": counters["ok"],
        "shed_503": counters["shed_503"],
        "shed_rate": round(counters["shed_503"] / total, 4)
        if total else 0.0,
        "errors_other": counters["errors"],
        "status_counts": {str(k): v for k, v in
                          sorted(status_counts.items())},
        "qps_achieved": round(total / elapsed, 2) if elapsed else 0.0,
        "connect_ms": stats["connect"].report(),
        "get": {"ttfb_ms": stats["get"]["ttfb"].report(),
                "total_ms": stats["get"]["total"].report()},
        "put": {"ttfb_ms": stats["put"]["ttfb"].report(),
                "total_ms": stats["put"]["total"].report()},
        "elapsed_s": round(elapsed, 3),
        "config": {"connections": connections, "duration_s": duration,
                   "qps_target": qps, "put_fraction": put_fraction,
                   "object_bytes": object_bytes,
                   "key_space": key_space},
    }


def _xml_code(body: bytes) -> str:
    """<Code>X</Code> out of an S3 error body, tag-sliced so the parser
    never chokes on a truncated response."""
    try:
        text = body.decode("utf-8", "replace")
        start = text.find("<Code>")
        end = text.find("</Code>")
        if 0 <= start < end:
            return text[start + len("<Code>"):end]
    except Exception:
        pass
    return "unknown"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--access-key", default="minioadmin")
    p.add_argument("--secret-key", default="minioadmin")
    p.add_argument("--bucket", default="loadgen")
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--qps", type=float, default=0.0,
                   help="target QPS; 0 = closed loop")
    p.add_argument("--put-fraction", type=float, default=0.5)
    p.add_argument("--size", type=int, default=1024 * 1024)
    p.add_argument("--key-space", type=int, default=32)
    p.add_argument("--zipf", type=float, default=0.0,
                   help="Zipfian key-rank exponent s (>0 enables the "
                        "hot-key mix; try 1.1)")
    p.add_argument("--buckets", type=int, default=1,
                   help="multi-tenant fleet: drive N buckets "
                        "({bucket}-0 .. {bucket}-{N-1}); the report "
                        "gains per-tenant percentiles")
    p.add_argument("--access-keys", default="",
                   help="comma list of ak:sk tenant credentials "
                        "(created beforehand via admin add-user); "
                        "default: the root key for every tenant")
    p.add_argument("--tenant-zipf", type=float, default=0.0,
                   help="Zipfian skew ACROSS tenants (tenant 0 "
                        "hottest) — the noisy-neighbor fleet shape")
    p.add_argument("--preload", action="store_true",
                   help="PUT the whole key space before the timed "
                        "window (for pure-GET runs)")
    p.add_argument("--make-bucket", action="store_true")
    p.add_argument("--connections", type=int, default=0,
                   help="high-concurrency mode: hold N keep-alive "
                        "sockets on one asyncio loop (closed-loop, or "
                        "--qps paced across the fleet); reports "
                        "connect/TTFB/total percentiles per class")
    args = p.parse_args()
    keys = [tuple(item.split(":", 1)) for item in
            args.access_keys.split(",") if ":" in item]
    if args.make_bucket:
        from ..s3.client import S3Client
        root = S3Client(args.host, args.port, args.access_key,
                        args.secret_key)
        names = ([args.bucket] if args.buckets <= 1 else
                 [f"{args.bucket}-{i}" for i in range(args.buckets)])
        for name in names:
            root.make_bucket(name)
    if args.connections > 0:
        report = run_async_load(args.host, args.port, args.access_key,
                                args.secret_key, args.bucket,
                                connections=args.connections,
                                duration=args.duration, qps=args.qps,
                                put_fraction=args.put_fraction,
                                object_bytes=args.size,
                                key_space=args.key_space,
                                preload=args.preload or
                                args.put_fraction < 1.0)
    else:
        report = run_load(args.host, args.port, args.access_key,
                          args.secret_key, args.bucket,
                          concurrency=args.concurrency,
                          duration=args.duration, qps=args.qps,
                          put_fraction=args.put_fraction,
                          object_bytes=args.size,
                          key_space=args.key_space, zipf_s=args.zipf,
                          preload=args.preload, buckets=args.buckets,
                          access_keys=keys or None,
                          tenant_zipf_s=args.tenant_zipf)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
