"""Distributed node assembly (ref cmd/endpoint.go Endpoint /
EndpointServerPools, cmd/server-main.go:388 serverMain boot order,
cmd/prepare-storage.go waitForFormatErasure).

Every node runs the same command with the same endpoint list, e.g.:
    minio-tpu server http://127.0.0.1:{9001...9003}/data/n{1...2}
Endpoints whose host:port match --address become local XLStorage disks;
the rest become RemoteStorage RPC clients. The node owning the FIRST
endpoint coordinates format minting; others poll until formats appear.

The port's own copy of ``minio_tpu/rpc/cluster.py``, with no change in
behaviour but the device seam: ``build_cluster_node(..., device=...)``
builds every local drive and erasure set on ``device`` (the card unless
the caller asks for the CPU). A remote drive's deep bitrot scan runs on
the node that owns it (``rpc/storage.py`` ``rpc_verify_file``).
"""

from __future__ import annotations

import hashlib
import re
import time
import urllib.parse
from dataclasses import dataclass

from ..erasure import bitrot
from ..erasure.codec import device_backend
from ..erasure.pools import ErasureServerPools
from ..erasure.sets import ErasureSets
from ..storage.format import (FormatErasure, init_or_load_formats,
                              load_format)
from ..storage.xl import XLStorage
from ..utils.ellipses import expand
from .locks import (DistNSLock, LocalLocker, LockRPCService,
                    _LocalLockerClient, _RemoteLockerClient)
from .storage import RemoteStorage, StorageRPCService
from .transport import RPCClient, RPCRegistry


def local_host_names(my_host: str) -> set[str]:
    """All names/addresses that mean 'this node' (handles --address
    0.0.0.0 by collecting the machine's own hostnames/IPs; ref
    cmd/endpoint.go isLocalHost resolution)."""
    import socket
    names = {"127.0.0.1", "localhost", "::1"}
    if my_host not in ("", "0.0.0.0", "::"):
        names.add(my_host)
    try:
        hn = socket.gethostname()
        names.add(hn)
        for info in socket.getaddrinfo(hn, None):
            names.add(info[4][0])
    except OSError:
        pass
    return names


@dataclass(frozen=True)
class Endpoint:
    host: str | None   # None => plain local path
    port: int | None
    path: str
    secure: bool = False   # https:// endpoint (TLS internode)

    @property
    def is_url(self) -> bool:
        return self.host is not None

    def is_local(self, my_hosts: set[str], my_port: int) -> bool:
        if not self.is_url:
            return True
        return self.host in my_hosts and self.port == my_port

    def node_key(self) -> str | None:
        return f"{self.host}:{self.port}" if self.is_url else None


def parse_endpoint(arg: str) -> Endpoint:
    if re.match(r"^https?://", arg):
        u = urllib.parse.urlparse(arg)
        if not u.port:
            raise ValueError(f"endpoint needs an explicit port: {arg}")
        if not u.path or u.path == "/":
            raise ValueError(f"endpoint needs a disk path: {arg}")
        return Endpoint(u.hostname, u.port, u.path,
                        secure=u.scheme == "https")
    return Endpoint(None, None, arg)


def derive_cluster_key(access_key: str, secret_key: str) -> bytes:
    """Node-auth key from the root credentials (the reference signs
    internal RPC with JWT minted from the same credentials)."""
    return hashlib.sha256(
        f"minio-tpu-cluster:{access_key}:{secret_key}".encode()).digest()


class ClusterNode:
    """Everything one node contributes: its object layer, its RPC
    services (local disks + locker + peer control plane), and peer
    clients."""

    def __init__(self, layer: ErasureServerPools, registry: RPCRegistry,
                 local_disks: dict[str, XLStorage],
                 peers: dict[str, RPCClient],
                 peer_service=None, notification=None):
        self.layer = layer
        self.registry = registry
        self.local_disks = local_disks
        self.peers = peers
        self.peer_service = peer_service    # rpc.peer.PeerRPCService
        self.notification = notification    # rpc.peer.NotificationSys


def build_cluster_node(disk_args: list[str], my_host: str, my_port: int,
                       access_key: str, secret_key: str,
                       block_size: int | None = None,
                       format_timeout: float = 30.0,
                       registry: RPCRegistry | None = None, *,
                       device="cuda",
                       backend: str | None = None) -> ClusterNode:
    """Pass `registry` (already wired into a RUNNING HTTP server) so
    peers can reach this node's storage RPC while everyone waits for
    formats — local disks and services register before the format loop.
    Local drives and every erasure set run their kernels on `device`, the
    sets under `backend` (by default pinned to `device`); under "auto" the
    local drives hash as bitrot's "auto" does."""
    cluster_key = derive_cluster_key(access_key, secret_key)

    # One pool per ellipses arg; plain args combine into a single pool
    # (ref createServerEndpoints legacy vs pools syntax).
    from ..utils.ellipses import has_ellipses
    pool_endpoints: list[list[Endpoint]] = []
    plain: list[Endpoint] = []
    for arg in disk_args:
        if has_ellipses(arg):
            pool_endpoints.append(
                [parse_endpoint(e) for e in expand(arg)])
        else:
            plain.append(parse_endpoint(arg))
    if plain:
        pool_endpoints.append(plain)

    backend = backend or device_backend(device)
    drive_device = bitrot.AUTO if backend == "auto" else device

    # Peer clients, one per distinct remote node.
    peers: dict[str, RPCClient] = {}
    local_disks: dict[str, XLStorage] = {}
    my_hosts = local_host_names(my_host)

    any_secure = any(ep.secure for eps in pool_endpoints for ep in eps)
    rpc_tls = None
    if any_secure:
        from ..utils.certs import client_context_from_env
        rpc_tls = client_context_from_env()

    def realize(ep: Endpoint):
        if ep.is_local(my_hosts, my_port):
            import os
            os.makedirs(ep.path, exist_ok=True)
            disk = XLStorage(ep.path, device=drive_device)
            local_disks[ep.path] = disk
            return disk
        key = ep.node_key()
        if key not in peers:
            peers[key] = RPCClient(ep.host, ep.port, cluster_key,
                                   tls=rpc_tls if ep.secure else None)
        return RemoteStorage(peers[key], ep.path)

    pool_disks = [[realize(ep) for ep in eps] for eps in pool_endpoints]

    # Register services FIRST — the format wait below depends on peers
    # being able to call us, and us them. The peer service must answer
    # handshakes before this node finishes booting (ref
    # bootstrap-peer-server registering ahead of waitForFormatErasure).
    from .peer import NotificationSys, PeerRPCService, topology_hash
    topo = topology_hash(sorted(
        f"{ep.host}:{ep.port}{ep.path}" if ep.is_url else ep.path
        for eps in pool_endpoints for ep in eps))
    peer_service = PeerRPCService(topo)
    locker = LocalLocker()
    if registry is None:
        registry = RPCRegistry(cluster_key)
    registry.register("lock", LockRPCService(locker))
    registry.register("storage", StorageRPCService(local_disks))
    registry.register("peer", peer_service)

    all_nodes: set[str] = set()
    my_keys = {f"{h}:{my_port}" for h in my_hosts}
    for eps in pool_endpoints:
        for ep in eps:
            if ep.is_url:
                all_nodes.add(ep.node_key())
    distributed = bool(all_nodes - my_keys)
    lock_clients = [_LocalLockerClient(locker)]
    for key in sorted(all_nodes):
        if key not in my_keys:
            lock_clients.append(_RemoteLockerClient(peers.setdefault(
                key, RPCClient(key.rsplit(":", 1)[0],
                               int(key.rsplit(":", 1)[1]), cluster_key,
                               tls=rpc_tls))))

    # Peer control plane shares the lock/storage RPC clients (the
    # setdefault loop above guarantees one per remote node).
    notification = NotificationSys(
        {k: c for k, c in peers.items() if k not in my_keys})

    # Bootstrap verify BEFORE joining the format dance: refuse peers
    # that disagree on version/protocol/topology (ref
    # cmd/bootstrap-peer-server.go:162, cmd/server-main.go:469-483).
    # Peers not yet answering (still booting) verify us when they do.
    if distributed:
        notification.verify_bootstrap(topo)

    kwargs = {"backend": backend, "device": device}
    if block_size:
        kwargs["block_size"] = block_size

    pools = []
    for eps, disks in zip(pool_endpoints, pool_disks):
        if len(disks) < 2:
            raise ValueError("each pool needs at least 2 disks")
        # Boot coordination: the owner of endpoint[0] mints formats;
        # everyone else waits for them (ref waitForFormatErasure retry,
        # cmd/prepare-storage.go).
        i_coordinate = eps[0].is_local(my_hosts, my_port)
        deadline = time.monotonic() + format_timeout
        while True:
            try:
                have_any = any(
                    _try_load(d) is not None for d in disks)
                if have_any or i_coordinate:
                    fmt, ordered, fresh = init_or_load_formats(disks)
                    break
            except Exception:
                if time.monotonic() >= deadline:
                    raise
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "timed out waiting for cluster formats")
            time.sleep(0.25)
        layout = [len(s) for s in fmt.sets]
        sets = ErasureSets(ordered, layout, fmt.deployment_id, **kwargs)
        if distributed:
            dist_lock = DistNSLock(lock_clients)
            for s in sets.sets:
                s.ns_lock = dist_lock
        pools.append(sets)

    layer = ErasureServerPools(pools)

    # Cluster-shared metacache: every (bucket, root) listing has one
    # owning node; the others stream its cache over the peer plane
    # instead of re-walking the set (ref owner-routed metacache,
    # cmd/metacache-server-pool.go:38, cmd/metacache-set.go:247).
    if distributed:
        from .peer import MetacacheShare
        share = MetacacheShare(notification, all_nodes & my_keys,
                               sorted(all_nodes))
        for pi, pool_sets in enumerate(layer.pools):
            for si, s in enumerate(pool_sets.sets):
                s.metacache.peer_share = share
                s.metacache.share_id = (pi, si)

    return ClusterNode(layer, registry, local_disks, peers,
                       peer_service=peer_service,
                       notification=notification)


def _try_load(disk) -> FormatErasure | None:
    try:
        return load_format(disk)
    except Exception:
        return None
