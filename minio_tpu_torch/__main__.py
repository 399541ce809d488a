"""CLI entry: `python -m minio_tpu_torch server /data/disk{1...4}`
(ref main.go:36, cmd/server-main.go:388 serverMain).

The port's own copy of ``minio_tpu/__main__.py``, with no change in
behaviour but the device seam. ``MINIO_TORCH_DEVICE`` (``cuda`` by
default, or ``cuda:N`` or ``cpu``) is read once at the top of ``main``
and names where every kernel of the node runs: it is the process dispatch
device (``batching.set_dispatch_device``) and the ``device`` of every
drive, erasure set, FS backend and NAS gateway the CLI builds; engines run
``backend="gpu"`` on a card and the reference's ``backend="auto"`` on the
CPU (``node_backend``). There is no
fallback: without the card it names, ``server`` and ``gateway nas`` print
an error and exit 1 before binding a port.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys


DEVICE_ENV = "MINIO_TORCH_DEVICE"


def _device_from_env() -> str:
    """The node's kernel device from ``MINIO_TORCH_DEVICE``: ``cuda`` (the
    default), ``cuda:N`` or ``cpu``. Raises ValueError for anything else."""
    want = os.environ.get(DEVICE_ENV, "").strip() or "cuda"
    import torch
    try:
        kind = torch.device(want).type
    except RuntimeError as e:
        raise ValueError(f"{DEVICE_ENV}={want!r}: {e}") from None
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{DEVICE_ENV}={want!r}: the node runs on "
                         "cuda, cuda:N or cpu")
    return want


def node_backend(device: str) -> str:
    """The backend of a node's erasure sets: pinned to the card on a card
    (nothing gives way to the host there), and the reference's default
    ``"auto"`` on the CPU, which plans over the native and ``torch-cpu``
    lanes as the reference's CPU node plans over its own."""
    import torch
    return "gpu" if torch.device(device).type == "cuda" else "auto"


def _claim_device(device: str) -> bool:
    """Make ``device`` the node's kernel device, or print why it cannot
    be and return False (no card, or no card of that index): the node
    never serves from the CPU in the card's place."""
    import torch

    from .ops import batching
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count == 0 or (dev.index is not None and dev.index >= count):
            print(f"error: {DEVICE_ENV}={device} names a CUDA device and "
                  f"this host has {count}; set {DEVICE_ENV}=cpu to run the "
                  "node on the CPU", file=sys.stderr)
            return False
        if dev.index is not None:
            torch.cuda.set_device(dev)
    batching.set_dispatch_device(dev.type)
    return True


def main(argv: list[str] | None = None) -> int:
    try:
        device = _device_from_env()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(
        prog="minio-tpu",
        description="S3-compatible erasure-coded object store on PyTorch "
                    "and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    srv = sub.add_parser("server", help="start the object-store server")
    srv.add_argument("disks", nargs="+",
                     help="disk paths; ellipses supported: /data/d{1...4}")
    srv.add_argument("--address", default="0.0.0.0:9000",
                     help="listen address (host:port)")
    srv.add_argument("--block-size", type=int, default=None,
                     help="erasure stripe block size in bytes")

    gw = sub.add_parser("gateway",
                        help="serve S3 over a foreign backend "
                             "(ref cmd/gateway-main.go)")
    gw.add_argument("backend",
                    choices=["nas", "s3", "azure", "gcs", "hdfs"])
    gw.add_argument("target",
                    help="nas: a directory; s3/azure/gcs/hdfs: "
                         "http(s)://host:port of the backend "
                         "(azure: MINIO_AZURE_ACCOUNT/_KEY; "
                         "gcs: MINIO_GCS_PROJECT/_TOKEN; "
                         "hdfs: MINIO_HDFS_ROOT/_USER env)")
    gw.add_argument("--address", default="0.0.0.0:9000")
    gw.add_argument("--meta-dir", default="",
                    help="s3 gateway: local dir for bucket metadata "
                         "(default <target-hash> under ~/.minio-tpu)")
    up = sub.add_parser("update",
                        help="check for / apply a newer release "
                             "(ref cmd/update.go)")
    up.add_argument("--endpoint",
                    default=os.environ.get(
                        "MINIO_UPDATE_URL",
                        "https://dl.min.io"),
                    help="release endpoint serving "
                         "/minio-tpu/release.json")
    up.add_argument("--dry-run", action="store_true",
                    help="only report whether an update exists")

    args = parser.parse_args(argv)

    if args.command == "server":
        return _serve(args, device)
    if args.command == "gateway":
        return _serve_gateway(args, device)
    if args.command == "update":
        return _update(args)
    return 2


def _update(args) -> int:
    from . import __version__
    from .utils.update import UpdateError, run_update
    try:
        info = run_update(args.endpoint, dry_run=args.dry_run)
    except UpdateError as e:
        print(f"update failed: {e}", file=sys.stderr)
        return 1
    if not info["newer"]:
        print(f"minio-tpu {__version__} is up to date "
              f"(latest: {info['latest'] or 'unknown'})")
    elif info["applied"]:
        print(f"updated {info['current']} -> {info['latest']}; "
              "restart the server to pick up the new code")
    else:
        print(f"update available: {info['current']} -> "
              f"{info['latest']} (run without --dry-run to apply)")
    return 0


def _parse_address(address: str) -> tuple[str, int]:
    host, _, port_s = address.rpartition(":")
    return host or "0.0.0.0", int(port_s)


def _env_creds() -> tuple[str, str]:
    return (os.environ.get("MINIO_ACCESS_KEY", "minioadmin"),
            os.environ.get("MINIO_SECRET_KEY", "minioadmin"))


def _announce(msg: str, access: str) -> None:
    from .logger import Logger
    Logger.get().info(msg)
    print(msg)
    print(f"   access key: {access}")
    sys.stdout.flush()


def _wait_for_sigterm() -> None:
    # An Event + timed wait, NOT signal.pause(): the kernel delivers a
    # process-directed SIGTERM to ANY thread with it unblocked, and
    # pause() only returns when THIS thread takes a signal — with the
    # front door's loop/worker threads in the mix, a SIGTERM landing
    # on one of them left the main thread paused forever (~1-in-3).
    # The Python-level handler always runs on the main thread; the
    # timed wait guarantees a bytecode boundary for it soon after.
    import threading
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass


def _serve_gateway(args, device: str = "cuda") -> int:
    """`minio-tpu gateway nas /mnt` / `gateway s3 http://host:port`
    (ref gateway-main.go startup: build layer from Gateway, same
    router). Every gateway's kernels run on ``device``: the NAS gateway's
    FS layer, and SelectObjectContent through the S3, Azure, GCS and
    HDFS gateways."""
    import hashlib

    from .s3.server import S3Server

    host, port = _parse_address(args.address)
    access, secret = _env_creds()

    if not _claim_device(device):
        return 1
    if args.backend == "nas":
        from .gateway import NASGateway
        os.makedirs(args.target, exist_ok=True)
        layer = NASGateway(args.target,
                           device=device).new_gateway_layer()
    elif args.backend in ("azure", "gcs", "hdfs"):
        from .bucket.replication import BucketTargetSys
        ep = BucketTargetSys.normalize_endpoint(args.target)
        h, _, prt = ep.partition(":")
        https = args.target.startswith("https://")
        meta_dir = args.meta_dir or os.path.join(
            os.path.expanduser("~/.minio-tpu"), "gateway",
            hashlib.sha256(ep.encode()).hexdigest()[:12])
        os.makedirs(meta_dir, exist_ok=True)
        if args.backend == "azure":
            from .gateway import AzureGateway
            layer = AzureGateway(
                h, int(prt),
                os.environ.get("MINIO_AZURE_ACCOUNT", ""),
                os.environ.get("MINIO_AZURE_KEY", ""), meta_dir,
                https=https, device=device).new_gateway_layer()
        elif args.backend == "gcs":
            from .gateway import GCSGateway
            layer = GCSGateway(
                h, int(prt),
                os.environ.get("MINIO_GCS_PROJECT", "default"),
                meta_dir, token=os.environ.get("MINIO_GCS_TOKEN", ""),
                https=https, device=device).new_gateway_layer()
        else:
            from .gateway import HDFSGateway
            layer = HDFSGateway(
                h, int(prt), meta_dir,
                root=os.environ.get("MINIO_HDFS_ROOT", "/minio-tpu"),
                user=os.environ.get("MINIO_HDFS_USER", "minio"),
                https=https, device=device).new_gateway_layer()
    else:
        from .bucket.replication import BucketTargetSys
        from .gateway import S3Gateway
        ep = BucketTargetSys.normalize_endpoint(args.target)
        h, _, prt = ep.partition(":")
        meta_dir = args.meta_dir or os.path.join(
            os.path.expanduser("~/.minio-tpu"), "gateway",
            hashlib.sha256(ep.encode()).hexdigest()[:12])
        os.makedirs(meta_dir, exist_ok=True)
        # Upstream credentials: same env pair (the reference reuses
        # MINIO_ACCESS_KEY/SECRET_KEY for the backend account too).
        layer = S3Gateway(h, int(prt), access, secret, meta_dir,
                          device=device).new_gateway_layer()

    layer = _maybe_wrap_cache(layer)
    server = S3Server(layer, access, secret,
                      iam=_make_iam(layer, access, secret))
    port = server.start(host, port, cert_manager=_certs())
    _announce(f"minio-tpu gateway [{args.backend}] -> {args.target}, "
              f"listening on {host}:{port}", access)
    _wait_for_sigterm()
    server.stop()
    return 0


def build_object_layer(disk_args: list[str],
                       block_size: int | None = None, *,
                       device="cuda", backend: str | None = None):
    """Construct the full topology: per-arg pools -> format.json
    bootstrap -> erasure sets -> server pools (ref newObjectLayer,
    cmd/server-main.go:538). A single plain path selects the FS
    backend (ref NEndpoints==1 -> NewFSObjectLayer). Every drive and set
    runs its kernels on ``device``, the sets under ``backend`` (by
    default pinned to ``device``: ``device_backend``); under ``"auto"``
    the drives hash as bitrot's "auto" does."""
    import threading

    from .erasure import bitrot
    from .erasure.codec import device_backend
    from .erasure.pools import ErasureServerPools
    from .erasure.sets import ErasureSets
    from .storage.format import init_or_load_formats
    from .storage.xl import XLStorage
    from .utils.ellipses import expand, has_ellipses

    if (len(disk_args) == 1 and not has_ellipses(disk_args[0])
            and not disk_args[0].startswith(("http://", "https://"))):
        from .fs.backend import FSObjects
        os.makedirs(disk_args[0], exist_ok=True)
        return FSObjects(disk_args[0], device=device)

    # Each ellipses arg is a pool; plain args group into one pool
    # (ref createServerEndpoints, cmd/endpoint-ellipses.go:252).
    pool_paths: list[list[str]] = []
    if any(has_ellipses(a) for a in disk_args):
        for a in disk_args:
            pool_paths.append(expand(a))
    else:
        pool_paths.append(list(disk_args))

    backend = backend or device_backend(device)
    drive_device = bitrot.AUTO if backend == "auto" else device
    kwargs = {"backend": backend, "device": device}
    if block_size:
        kwargs["block_size"] = block_size

    pools = []
    fresh_all: list[tuple[ErasureSets, int]] = []
    for paths in pool_paths:
        if len(paths) < 2:
            raise ValueError("each pool needs at least 2 disks")
        for p in paths:
            os.makedirs(p, exist_ok=True)
        disks = [XLStorage(p, device=drive_device) for p in paths]
        fmt, ordered, fresh = init_or_load_formats(disks)
        layout = [len(s) for s in fmt.sets]
        sets = ErasureSets(ordered, layout, fmt.deployment_id, **kwargs)
        pools.append(sets)
        for slot in fresh:
            fresh_all.append((sets, slot))

    layer = ErasureServerPools(pools)
    if fresh_all:
        # Replacement disks detected: heal each affected pool once, in
        # the background (ref monitorLocalDisksAndHeal).
        unique_sets = list(dict.fromkeys(s for s, _ in fresh_all))
        # mtpu-lint: disable=R1 -- boot-time background heal kickoff; no request context exists yet
        threading.Thread(target=lambda: [s.healer.heal_all()
                                         for s in unique_sets],
                         daemon=True).start()
    return layer


def _certs():
    """HTTPS when a cert pair exists (env or ~/.minio-tpu/certs; ref
    cmd/config-dir.go certsDir auto-detection)."""
    from .utils.certs import CertManager
    return CertManager.from_env()


def _make_iam(layer, access: str, secret: str):
    """IAM persisted on the store's own first erasure set — or on the
    single FS root (ref iam-object-store in .minio.sys)."""
    from .iam.iam import ConfigStore, IAMSys
    if hasattr(layer, "pools"):
        disks = layer.pools[0].sets[0].disks
    else:
        disks = [layer.meta_disk]
    return IAMSys(ConfigStore(disks), access, secret)


def _maybe_wrap_cache(layer):
    """The env-configured CacheObjectLayer wrapper is gone: caching is
    now the hot-object serving tier INSIDE the erasure data plane
    (cache/hotcache.py), configured via config-KV — e.g.
    `mc admin config set cache enable=on dirs=/mnt/d1/cache`. Warn
    anyone still setting the old env so the migration is visible."""
    if os.environ.get("MINIO_CACHE_DRIVES"):
        print("warning: MINIO_CACHE_DRIVES is no longer honored — "
              "the disk-cache wrapper was replaced by the hot-object "
              "serving tier; configure it with "
              "`mc admin config set cache enable=on "
              "dirs=<dir1,dir2,...>` instead", file=sys.stderr)
    return layer


def _serve(args, device: str = "cuda") -> int:
    if not _claim_device(device):
        return 1
    from .s3.server import S3Server

    host, port = _parse_address(args.address)
    access, secret = _env_creds()

    distributed = any(a.startswith(("http://", "https://"))
                      for a in args.disks)
    if any(a.startswith("https://") for a in args.disks) \
            and _certs() is None:
        print("error: https:// cluster endpoints require server "
              "certificates (MINIO_CERT_FILE/MINIO_KEY_FILE or "
              "~/.minio-tpu/certs/public.crt+private.key) — without "
              "them peers cannot complete TLS handshakes against this "
              "node", file=sys.stderr)
        return 1
    try:
        if distributed:
            # Start HTTP first (peers need our storage RPC during
            # format bootstrap; ref serverMain order,
            # cmd/server-main.go:463).
            from .rpc.cluster import build_cluster_node, derive_cluster_key
            from .rpc.transport import RPCRegistry
            boot_registry = RPCRegistry(
                derive_cluster_key(access, secret))
            server = S3Server(None, access, secret,
                              rpc_registry=boot_registry)
            port = server.start(host, port, cert_manager=_certs())
            my_host = "127.0.0.1" if host in ("0.0.0.0", "") else host
            node = build_cluster_node(args.disks, my_host, port,
                                      access, secret, args.block_size,
                                      registry=boot_registry,
                                      device=device,
                                      backend=node_backend(device))
            layer = _maybe_wrap_cache(node.layer)
            server.set_layer(layer)
            server.iam = _make_iam(node.layer, access, secret)
            # Peer control plane: bind the RPC service to this server
            # and wire push invalidation — the 1s freshness polls
            # become slow safety nets (ref NotificationSys,
            # cmd/notification.go:48).
            node.peer_service.bind(server)
            server.notification = node.notification
            server.iam.notify = node.notification.load_iam
            server.iam.reload_interval = 30.0
            server.bucket_meta.notify_update = \
                node.notification.load_bucket_metadata
            server.bucket_meta.notify_delete = \
                node.notification.delete_bucket_metadata
            # Hot-object cache coherence: every local overwrite/delete
            # pushes an invalidation (with its epoch stamp) to every
            # peer's cache (rpc/peer.py cache_invalidate).
            from .cache.hotcache import HOTCACHE
            HOTCACHE.peer_notify = node.notification.cache_invalidate
        else:
            layer = _maybe_wrap_cache(
                build_object_layer(args.disks, args.block_size,
                                   device=device,
                                   backend=node_backend(device)))
            server = S3Server(layer, access, secret,
                              iam=_make_iam(layer, access, secret))
            port = server.start(host, port, cert_manager=_certs())
    except (ValueError, TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if hasattr(layer, "pools"):
        n_disks = sum(len(s.disks) for p in layer.pools for s in p.sets)
        eng = layer.pools[0].sets[0]
        msg = (f"minio-tpu server: {len(layer.pools)} pool(s), "
               f"{sum(len(p.sets) for p in layer.pools)} set(s), "
               f"{n_disks} disks, EC {eng.k}+{eng.m}, "
               f"listening on {host}:{port}")
    else:
        msg = (f"minio-tpu server: FS backend at {layer.root}, "
               f"listening on {host}:{port}")
    _announce(msg, access)

    # Notification targets from env (ref config/notify webhook subsys:
    # MINIO_NOTIFY_WEBHOOK_ENABLE/ENDPOINT/QUEUE_DIR).
    if os.environ.get("MINIO_NOTIFY_WEBHOOK_ENABLE", "") == "on":
        from .event.targets import QueueStoreTarget, WebhookTarget
        endpoint = os.environ.get("MINIO_NOTIFY_WEBHOOK_ENDPOINT", "")
        if endpoint:
            target = WebhookTarget(endpoint)
            qdir = os.environ.get("MINIO_NOTIFY_WEBHOOK_QUEUE_DIR", "")
            if qdir:
                target = QueueStoreTarget(target, qdir)
            server.notifier.register_target(target)
    # Federation: etcd-backed bucket DNS (ref globalDNSConfig,
    # pkg/dns/etcd_dns.go). MINIO_PUBLIC_ADDRESS is the address other
    # clusters should reach this one at (defaults to the bind address).
    from .bucket.federation import BucketDNS
    dns = BucketDNS.from_env()
    if dns is not None and server.handlers is not None:
        pub = os.environ.get("MINIO_PUBLIC_ADDRESS",
                             f"{host or '127.0.0.1'}:{port}")
        ph, sep, pp = pub.rpartition(":")
        if not sep or not pp.isdigit():
            print(f"error: MINIO_PUBLIC_ADDRESS must be host:port, "
                  f"got {pub!r}", file=sys.stderr)
            return 1
        server.handlers.bucket_dns = dns
        server.handlers.public_addr = (ph or "127.0.0.1", int(pp))
        # Re-register every existing local bucket so a cluster joining
        # (or restarting into) the federation is resolvable at once
        # (ref initFederatorBackend, cmd/server-main.go).
        try:
            for b in layer.list_buckets():
                dns.register(b["name"],
                             *server.handlers.public_addr)
        except Exception:
            from .logger import Logger
            Logger.get().log_once("bucket DNS boot registration failed",
                                  "bucket-dns")

    # Broker sinks (nats/nsq/mqtt/redis/es/kafka/amqp/postgres/mysql;
    # ref pkg/event/target suite) share the same env conventions.
    from .event.brokers import targets_from_env
    from .event.targets import QueueStoreTarget as _QS
    for target in targets_from_env():
        qdir = os.environ.get(
            f"MINIO_NOTIFY_{target.env_name}_QUEUE_DIR", "")
        if qdir:
            target = _QS(target, qdir)
        server.notifier.register_target(target)

    # Background data crawler: usage + lifecycle + heal sampling
    # (ref initDataCrawler, cmd/server-main.go:497).
    from .scanner.crawler import DataCrawler
    crawler = DataCrawler(
        layer, server.bucket_meta, notifier=server.notifier,
        interval=float(os.environ.get("MINIO_CRAWLER_INTERVAL", "60")),
        tiers=server.handlers.tiers)
    crawler.start()
    server.crawler = crawler

    # Auto-heal freshly replaced disks (ref monitorLocalDisksAndHeal,
    # cmd/background-newdisks-heal-ops.go:113).
    monitors = []
    for pool in getattr(layer, "pools", [layer]):
        for es in getattr(pool, "sets", [pool]):
            mon = getattr(es, "new_disk_monitor", None)
            if mon is not None:
                mon.interval = float(os.environ.get(
                    "MINIO_HEAL_NEWDISK_INTERVAL", "10"))
                mon.start()
                monitors.append(mon)
            # Probation probes close the quarantine loop: a drive the
            # health monitor pulled from the data plane earns its way
            # back through bitrot-verified shadow reads.
            prober = getattr(es, "quarantine_prober", None)
            if prober is not None:
                prober.interval = float(os.environ.get(
                    "MINIO_HEAL_PROBATION_INTERVAL", "5"))
                prober.start()
                monitors.append(prober)

    _wait_for_sigterm()
    for mon in monitors:
        mon.stop()
    crawler.stop()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
