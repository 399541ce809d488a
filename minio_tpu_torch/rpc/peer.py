"""Peer control plane: node-to-node notifications, cluster-wide admin
fan-in, and the boot handshake.

The reference fans ~35 methods across peers (ref cmd/notification.go:48
NotificationSys, cmd/peer-rest-common.go:27-61 method list) and refuses
mismatched nodes at boot (ref cmd/bootstrap-peer-server.go:162
verifyServerSystemConfig, cmd/server-main.go:469-483). This rebuild
keeps the same responsibilities on the existing HMAC RPC transport
(rpc/transport.py), with the set of methods the rest of the codebase
actually consumes:

  handshake               boot-time version/topology verification
  load_iam                push IAM invalidation (replaces cross-node
                          freshness polling as the primary mechanism)
  load_bucket_metadata /  push bucket-config invalidation
  delete_bucket_metadata
  trace                   bounded trace collection for cluster-wide
                          `admin trace` (ref peerRESTMethodTrace)
  profiling_start/stop    cluster-wide CPU profiling fan-out
  metrics                 per-node codec dispatch + request counters
  server_info             per-node admin info for cluster aggregation

Fan-out is parallel and failure-tolerant: an unreachable peer degrades
that node's freshness to its fallback poll, never the caller's request.

The port's own copy of ``minio_tpu/rpc/peer.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import threading

from .. import __version__
from .transport import RPCClient

PROTOCOL_VERSION = 1


def topology_hash(disk_args_expanded: list[str]) -> str:
    """Deterministic digest of the cluster shape every node must agree
    on (the reference compares endpoint ordering, CmdLine and version
    in verifyServerSystemConfig)."""
    doc = "\n".join(disk_args_expanded)
    return hashlib.sha256(doc.encode()).hexdigest()


class PeerRPCService:
    """Server side of the peer control plane. Constructed (and
    registered on the RPC registry) before the S3 server has a layer —
    handshake works immediately; server-backed methods bind later via
    bind()."""

    def __init__(self, topo_hash: str):
        self.topo_hash = topo_hash
        self.server = None          # S3Server, set by bind()
        self._profiler = None

    def bind(self, server) -> None:
        self.server = server

    # -- bootstrap -----------------------------------------------------

    def rpc_handshake(self, args: dict, payload: bytes):
        return ({"version": __version__, "protocol": PROTOCOL_VERSION,
                 "topology": self.topo_hash}, b"")

    # -- invalidation pushes -------------------------------------------

    def _server(self):
        if self.server is None:
            raise RuntimeError("peer service not bound yet")
        return self.server

    def rpc_load_iam(self, args: dict, payload: bytes):
        iam = self._server().iam
        if iam is not None:
            iam.load()
        return ({"ok": True}, b"")

    def rpc_load_bucket_metadata(self, args: dict, payload: bytes):
        self._server().bucket_meta.invalidate(args["bucket"])
        return ({"ok": True}, b"")

    def rpc_delete_bucket_metadata(self, args: dict, payload: bytes):
        self._server().bucket_meta.invalidate(args["bucket"])
        # A deleted bucket's hot-object entries must die with it.
        from ..cache.hotcache import HOTCACHE
        HOTCACHE.invalidate_bucket(args["bucket"])
        return ({"ok": True}, b"")

    def rpc_cache_invalidate(self, args: dict, payload: bytes):
        """Hot-object cache invalidation push (cache/hotcache.py): a
        peer overwrote/deleted bucket/key — drop our cached decoded
        copies and poison in-flight fills. The epoch is the writer's
        per-key version stamp (max-merged on our side); applied
        WITHOUT re-propagation, so invalidations can't storm. Needs no
        server binding — the cache is process-wide."""
        from ..cache.hotcache import HOTCACHE
        HOTCACHE.apply_peer_invalidation(args["bucket"], args["key"],
                                         int(args.get("epoch", 0)))
        return ({"ok": True}, b"")

    # -- cluster-wide admin fan-in -------------------------------------

    def rpc_trace(self, args: dict, payload: bytes):
        """Bounded trace collect, same contract as admin h_trace."""
        timeout = min(float(args.get("timeout", 3)), 30.0)
        entries = self._server().trace_hub.collect(timeout)
        return ({"entries": entries}, b"")

    def rpc_profiling_start(self, args: dict, payload: bytes):
        from ..utils.profiler import SamplingProfiler
        if self._profiler is not None:
            raise ValueError("profiling already running")
        self._profiler = SamplingProfiler(
            interval=float(args.get("intervalMs", 5)) / 1000.0)
        self._profiler.start()
        return ({"ok": True}, b"")

    def rpc_profiling_stop(self, args: dict, payload: bytes):
        prof = self._profiler
        if prof is None:
            raise ValueError("profiling not running")
        self._profiler = None
        return ({"profile": prof.stop()}, b"")

    def rpc_metrics(self, args: dict, payload: bytes):
        # The port's own dispatch counters: every K1 (``rs``) and K2
        # (``bitrot``) dispatch of this process, by the reference's keys.
        from ..ops import batching
        srv = self._server()
        return ({"rs": batching.STATS.snapshot(),
                 "bitrot": batching.HH_STATS.snapshot(),
                 "requests": dict(srv.metrics.requests),
                 "rx_bytes": srv.metrics.rx_bytes,
                 "tx_bytes": srv.metrics.tx_bytes}, b"")

    def rpc_metrics2(self, args: dict, payload: bytes):
        """This node's metrics-v2 snapshot for cluster aggregation
        (ref the cluster collectors of cmd/metrics-v2.go scraping
        peers over peerRESTClient)."""
        from ..obs.metrics2 import METRICS2
        return ({"metrics2": METRICS2.snapshot()}, b"")

    def rpc_drivemon(self, args: dict, payload: bytes):
        """This node's drive-health snapshot for the cluster drive
        endpoint's fan-in merge (same peer-scrape shape as metrics2)."""
        from ..obs.drivemon import DRIVEMON
        return ({"drivemon": DRIVEMON.snapshot()}, b"")

    def rpc_timeline(self, args: dict, payload: bytes):
        """This node's timeline sample ring for the cluster timeline
        endpoint's bucket-aligned merge (obs/timeline.py
        merge_timelines).  `n` bounds the tail so a peer scrape never
        ships more history than the caller will merge."""
        from ..obs.timeline import TIMELINE
        n = None
        if args.get("n") is not None:
            n = max(1, min(int(args["n"]), 36000))
        return ({"timeline": TIMELINE.snapshot(n=n)}, b"")

    def rpc_alerts(self, args: dict, payload: bytes):
        """This node's watchdog alert census for the cluster alerts
        endpoint's fan-in merge (obs/watchdog.py merge_alerts — worst
        state per rule with honest node counts).  Needs no server
        binding: the watchdog is process-wide."""
        from ..obs.watchdog import WATCHDOG
        return ({"alerts": WATCHDOG.snapshot()}, b"")

    def rpc_usage(self, args: dict, payload: bytes):
        """This node's workload-attribution snapshot (obs/usage.py)
        for the cluster usage endpoint's fan-in merge — accounts sum,
        sketches merge via their count-min backing.  Needs no server
        binding: the accountant is process-wide."""
        from ..obs.usage import USAGE
        return ({"usage": USAGE.snapshot()}, b"")

    def rpc_server_info(self, args: dict, payload: bytes):
        srv = self._server()
        return ({"version": __version__,
                 "uptime": __import__("time").time()
                 - srv.metrics.start_time,
                 "endpoint": f"{srv.host}:{srv.port}"
                 if hasattr(srv, "host") else ""}, b"")

    # -- cluster-shared metacache --------------------------------------

    def rpc_list_entries(self, args: dict, payload: bytes):
        """Serve this node's metacache entries for one (pool, set,
        bucket, root) — paged like the storage walk RPC, so listings
        cross the wire in bounded frames. Non-owner nodes call this
        instead of walking their own disks (ref the owner-routed
        metacache: cmd/metacache-server-pool.go:38 listPath picking up
        an existing listing, cmd/metacache-set.go:247)."""
        import bisect
        from ..s3.admin import _pools
        layer = self._server().layer
        pools = _pools(layer)
        mgr = pools[int(args["pool"])].sets[int(args["set"])].metacache
        if args.get("force"):
            # The caller wrote through its own node since its last
            # fetch: our tracker never saw that, so drop the cache and
            # rescan (preserves read-after-write through any node).
            with mgr._mu:
                mgr._caches.pop((args["bucket"],
                                 args.get("root", "")), None)
        entries = mgr._entries_local(args["bucket"],
                                     args.get("root", ""))
        after = args.get("after", "")
        limit = max(1, min(int(args.get("limit") or LIST_PAGE_ENTRIES),
                           10 * LIST_PAGE_ENTRIES))
        lo = bisect.bisect_right(entries, after,
                                 key=lambda e: e["name"]) if after else 0
        page = entries[lo:lo + limit]
        return ({"entries": page,
                 "truncated": lo + limit < len(entries)}, b"")


# Entries per shared-listing RPC page (bounds frame size both ways).
LIST_PAGE_ENTRIES = 2000


class MetacacheShare:
    """Owner routing for cluster-shared listings: every (bucket, root)
    hashes to ONE node in the (topology-identical) node list; everyone
    else streams that owner's cache over the peer plane instead of
    re-walking the set. Installed on each
    set's MetacacheManager by the cluster wiring."""

    def __init__(self, notification: "NotificationSys",
                 my_keys: set[str], node_keys: list[str]):
        self.notification = notification
        # ALL aliases this node appears under in the endpoint list: a
        # root hashing to any alias is ours (a single-key check would
        # misroute aliased roots to a peers[] lookup that KeyErrors).
        self.my_keys = set(my_keys)
        self.node_keys = sorted(node_keys)

    def owner_key(self, bucket: str, root: str) -> str | None:
        """The owning node's key, or None when this node owns it."""
        if not self.node_keys:
            return None
        digest = hashlib.sha256(f"{bucket}\x00{root}".encode()).digest()
        owner = self.node_keys[int.from_bytes(digest[:8], "big")
                               % len(self.node_keys)]
        return None if owner in self.my_keys else owner

    def fetch_entries(self, owner: str, share_id: tuple[int, int],
                      bucket: str, root: str, after: str = "",
                      force: bool = False):
        """Generator streaming the owner's entries page by page,
        starting past `after`; pages stop being fetched as soon as the
        consumer stops (a list_path hitting max_keys never pulls the
        rest of a huge listing). `force` makes the FIRST page drop the
        owner's cache (writes went through the caller's node)."""
        client = self.notification.peers[owner]
        first = True
        while True:
            res, _ = client.call("peer", "list_entries", {
                "pool": share_id[0], "set": share_id[1],
                "bucket": bucket, "root": root, "after": after,
                "force": bool(force and first),
                "limit": LIST_PAGE_ENTRIES})
            first = False
            entries = res["entries"]
            yield from entries
            if not res.get("truncated") or not entries:
                return
            after = entries[-1]["name"]


class BootstrapMismatch(RuntimeError):
    """A peer disagrees about version/protocol/topology — refusing to
    join (ref bootstrap verify error, cmd/server-main.go:469-483)."""


class NotificationSys:
    """Client side: parallel fan-out to every peer (ref NotificationSys,
    cmd/notification.go:48). All pushes are fire-and-forget from the
    caller's perspective — failures degrade the peer to its fallback
    poll and are reported in the return value for tests/observability."""

    def __init__(self, peers: dict[str, RPCClient]):
        self.peers = dict(peers)

    def _fanout(self, method: str, args: dict,
                timeout: float | None = None,
                ) -> dict[str, dict | Exception]:
        results: dict[str, dict | Exception] = {}
        if not self.peers:
            return results

        # Async fabric (rpc/aio.py): N peers become N coroutines on
        # the process-wide RPC loop — the caller blocks on ONE future,
        # zero fan-out threads. Falls through to the thread path when
        # the fabric is off or a peer isn't a real RPCClient (test
        # doubles, in-process loopbacks).
        from . import aio
        fabric = aio.fanout(self.peers, method, args, timeout=timeout)
        if fabric is not None:
            return fabric

        def one(key: str, client: RPCClient) -> None:
            try:
                results[key], _ = client.call("peer", method, args,
                                              timeout=timeout)
            except Exception as exc:  # noqa: BLE001 - per-peer failure
                results[key] = exc

        # ctx_wrap: the RPC client reads the request deadline from a
        # contextvar (transport.py) — bare threads here ran cluster
        # fan-outs deadline-UNCAPPED and header-less (found by lint
        # rule R1, the same gap the quorum pool once had).
        from ..qos.ctx import ctx_wrap
        threads = [threading.Thread(target=ctx_wrap(one), args=kv,
                                    daemon=True)
                   for kv in self.peers.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    def _fanout_async(self, method: str, args: dict) -> None:
        """Push without blocking the mutating request on peer RPCs."""
        from . import aio
        if aio.fanout_nowait(self.peers, method, args):
            # Scheduled on the RPC loop deadline-free and span-free:
            # the push must OUTLIVE the mutating request (same
            # contract the daemon-thread fallback encodes below).
            return
        # mtpu-lint: disable=R1 -- fire-and-forget push must OUTLIVE the request; inheriting its deadline would cancel the notify
        threading.Thread(target=self._fanout, args=(method, args),
                         daemon=True).start()

    # -- bootstrap -----------------------------------------------------

    def verify_bootstrap(self, topo_hash: str) -> dict[str, str]:
        """Handshake every reachable peer; BootstrapMismatch on any
        disagreement. Unreachable peers are skipped (they verify us
        when they boot; the reference retries until the cluster
        converges). Returns {peer: status} for logging."""
        statuses: dict[str, str] = {}
        for key, res in self._fanout("handshake", {}).items():
            if isinstance(res, Exception):
                statuses[key] = f"unreachable: {res}"
                continue
            if res.get("protocol") != PROTOCOL_VERSION:
                raise BootstrapMismatch(
                    f"peer {key} speaks protocol {res.get('protocol')}, "
                    f"this node {PROTOCOL_VERSION}")
            if res.get("version") != __version__:
                raise BootstrapMismatch(
                    f"peer {key} runs version {res.get('version')}, "
                    f"this node {__version__}")
            if res.get("topology") != topo_hash:
                raise BootstrapMismatch(
                    f"peer {key} has a different endpoint topology "
                    f"({res.get('topology', '')[:12]}... vs "
                    f"{topo_hash[:12]}...) — same endpoint list "
                    "required on every node")
            statuses[key] = "ok"
        return statuses

    # -- pushes --------------------------------------------------------

    def load_iam(self) -> None:
        self._fanout_async("load_iam", {})

    def load_bucket_metadata(self, bucket: str) -> None:
        self._fanout_async("load_bucket_metadata", {"bucket": bucket})

    def delete_bucket_metadata(self, bucket: str) -> None:
        self._fanout_async("delete_bucket_metadata", {"bucket": bucket})

    def cache_invalidate(self, bucket: str, key: str,
                         epoch: int) -> None:
        """Fire-and-forget hot-object cache invalidation: a lost push
        degrades the peer to its ETag-revalidation backstop
        (cache/hotcache.py), never the writer's request."""
        self._fanout_async("cache_invalidate",
                           {"bucket": bucket, "key": key,
                            "epoch": int(epoch)})

    # -- synchronous fan-ins (admin aggregation) -----------------------

    def trace_all(self, timeout: float) -> list:
        entries = []
        # The peer blocks up to `timeout` by design: give the RPC its
        # own window instead of the data plane's self-tuning one.
        for res in self._fanout("trace", {"timeout": timeout},
                                timeout=timeout + 10).values():
            if isinstance(res, dict):
                entries.extend(res.get("entries", []))
        return entries

    def profiling_start_all(self, interval_ms: float) -> dict:
        return {k: (str(v) if isinstance(v, Exception) else "ok")
                for k, v in self._fanout(
                    "profiling_start",
                    {"intervalMs": interval_ms}).items()}

    def profiling_stop_all(self) -> dict:
        out = {}
        for k, v in self._fanout("profiling_stop", {}).items():
            out[k] = v.get("profile") if isinstance(v, dict) else str(v)
        return out

    def metrics_all(self) -> dict:
        return {k: (v if isinstance(v, dict) else {"error": str(v)})
                for k, v in self._fanout("metrics", {}).items()}

    def metrics2_all(self) -> dict:
        """Per-peer metrics-v2 snapshots; unreachable peers degrade to
        an error entry (the cluster endpoint reports how many nodes
        actually contributed)."""
        return {k: (v if isinstance(v, dict) else {"error": str(v)})
                for k, v in self._fanout("metrics2", {}).items()}

    def drivemon_all(self) -> dict:
        """Per-peer drive-health snapshots for the cluster drives
        endpoint (unreachable peers degrade, never the scrape)."""
        return {k: (v if isinstance(v, dict) else {"error": str(v)})
                for k, v in self._fanout("drivemon", {}).items()}

    def timeline_all(self, n: int | None = None) -> dict:
        """Per-peer timeline snapshots for the cluster timeline merge
        (unreachable peers degrade to an error entry; their buckets
        simply carry fewer nodes)."""
        args: dict = {} if n is None else {"n": n}
        return {k: (v if isinstance(v, dict) else {"error": str(v)})
                for k, v in self._fanout("timeline", args).items()}

    def alerts_all(self) -> dict:
        """Per-peer watchdog snapshots for the cluster alerts merge
        (unreachable peers degrade to an error entry — the endpoint
        counts them as unreachable, never as alert-free)."""
        return {k: (v if isinstance(v, dict) else {"error": str(v)})
                for k, v in self._fanout("alerts", {}).items()}

    def usage_all(self) -> dict:
        """Per-peer usage snapshots for the cluster attribution merge
        (unreachable peers degrade to an error entry — the endpoint
        counts them as unreachable, never as idle)."""
        return {k: (v if isinstance(v, dict) else {"error": str(v)})
                for k, v in self._fanout("usage", {}).items()}

    def server_info_all(self) -> dict:
        return {k: (v if isinstance(v, dict) else {"error": str(v)})
                for k, v in self._fanout("server_info", {}).items()}
