"""Storage RPC: every StorageAPI method over the wire, so a peer node's
disks join an erasure set exactly like local ones (ref
cmd/storage-rest-server.go route table :1025-1075, storage-rest-client).

StorageRPCService exposes a node's LOCAL disks (indexed by their path);
RemoteStorage implements StorageAPI against a peer's service.

The port's own copy of ``minio_tpu/rpc/storage.py``, with no change in
behaviour.
"""

from __future__ import annotations

import base64
import contextlib

from ..storage import errors as serr
from ..storage.interface import StorageAPI
from ..storage.metadata import FileInfo
from .transport import RPCClient


# Entries per walk_dir RPC page: bounds both the frame size (~300B per
# single-version entry -> ~300KiB pages) and server/client memory.
WALK_PAGE_ENTRIES = 1000

_NULL_CTX = contextlib.nullcontext()


def _fi_to_wire(fi: FileInfo) -> dict:
    d = fi.to_version_dict()
    d["_volume"] = fi.volume
    d["_name"] = fi.name
    return d


def _fi_from_wire(d: dict) -> FileInfo:
    fi = FileInfo.from_version_dict(d.get("_volume", ""),
                                    d.get("_name", ""), d)
    return fi


class StorageRPCService:
    """Server side: dispatches to this node's local disks by disk path."""

    def __init__(self, local_disks: dict[str, StorageAPI]):
        self.disks = local_disks

    def _disk(self, args: dict) -> StorageAPI:
        d = self.disks.get(args["disk"])
        if d is None:
            raise serr.DiskNotFound(args.get("disk", "?"))
        return d

    # Each rpc_* takes (args, payload) -> (result, body).

    def rpc_disk_info(self, a, p):
        return self._disk(a).disk_info(), b""

    def rpc_make_volume(self, a, p):
        self._disk(a).make_volume(a["volume"])
        return {}, b""

    def rpc_list_volumes(self, a, p):
        return {"volumes": self._disk(a).list_volumes()}, b""

    def rpc_stat_volume(self, a, p):
        return self._disk(a).stat_volume(a["volume"]), b""

    def rpc_delete_volume(self, a, p):
        self._disk(a).delete_volume(a["volume"], a.get("force", False))
        return {}, b""

    def rpc_write_all(self, a, p):
        self._disk(a).write_all(a["volume"], a["path"], p)
        return {}, b""

    def rpc_read_all(self, a, p):
        return {}, self._disk(a).read_all(a["volume"], a["path"])

    def rpc_read_file(self, a, p):
        return {}, self._disk(a).read_file(a["volume"], a["path"],
                                           a["offset"], a["length"])

    def rpc_repair_project(self, a, p):
        return {}, self._disk(a).repair_project(
            a["volume"], a["path"],
            [(int(o), int(ln)) for o, ln in a["ranges"]])

    def rpc_create_file(self, a, p):
        self._disk(a).create_file(a["volume"], a["path"], p)
        return {}, b""

    def rpc_append_file(self, a, p):
        self._disk(a).append_file(a["volume"], a["path"], p)
        return {}, b""

    def rpc_delete(self, a, p):
        self._disk(a).delete(a["volume"], a["path"],
                             a.get("recursive", False))
        return {}, b""

    def rpc_rename_file(self, a, p):
        self._disk(a).rename_file(a["src_volume"], a["src_path"],
                                  a["dst_volume"], a["dst_path"])
        return {}, b""

    def rpc_list_dir(self, a, p):
        return {"entries": self._disk(a).list_dir(a["volume"],
                                                  a["path"])}, b""

    def rpc_walk_dir(self, a, p):
        # STREAMED walk: bounded pages with a resume token instead of
        # the whole listing in one frame — a million-object bucket is
        # many small frames, O(page) memory on both ends (ref WalkDir
        # streamed over storage REST with trailing-error framing,
        # cmd/metacache-walk.go, cmd/storage-rest-server.go:1025; the
        # strict request/response transport here makes the resume
        # token carry the stream position instead).
        import itertools
        limit = max(1, min(int(a.get("limit") or WALK_PAGE_ENTRIES),
                           10 * WALK_PAGE_ENTRIES))
        it = self._disk(a).walk_dir_iter(a["volume"],
                                         a.get("prefix", ""),
                                         a.get("after", ""))
        entries = list(itertools.islice(it, limit + 1))
        truncated = len(entries) > limit
        return {"entries": entries[:limit], "truncated": truncated}, b""

    def rpc_rename_data(self, a, p):
        self._disk(a).rename_data(a["src_volume"], a["src_path"],
                                  _fi_from_wire(a["fi"]),
                                  a["dst_volume"], a["dst_path"])
        return {}, b""

    def rpc_write_metadata(self, a, p):
        self._disk(a).write_metadata(a["volume"], a["path"],
                                     _fi_from_wire(a["fi"]))
        return {}, b""

    def rpc_read_version(self, a, p):
        fi = self._disk(a).read_version(a["volume"], a["path"],
                                        a.get("version_id", ""))
        return {"fi": _fi_to_wire(fi)}, b""

    def rpc_read_versions(self, a, p):
        fis = self._disk(a).read_versions(a["volume"], a["path"])
        return {"fis": [_fi_to_wire(fi) for fi in fis]}, b""

    def rpc_delete_version(self, a, p):
        self._disk(a).delete_version(a["volume"], a["path"],
                                     _fi_from_wire(a["fi"]))
        return {}, b""

    def rpc_read_parts(self, a, p):
        return {"parts": self._disk(a).read_parts(
            a["volume"], a["path"], a["data_dir"])}, b""

    def rpc_verify_file(self, a, p):
        self._disk(a).verify_file(a["volume"], a["path"],
                                  _fi_from_wire(a["fi"]))
        return {}, b""


class RemoteStorage(StorageAPI):
    """StorageAPI over the wire: one peer disk (ref storageRESTClient,
    cmd/storage-rest-client.go)."""

    def __init__(self, client: RPCClient, disk_path: str):
        self.client = client
        self.disk_path = disk_path
        # Remote disks mean quorum fan-outs wait on the network: those
        # waits must overlap even on a single-core host. This is a
        # deliberate ONE-WAY latch for the process lifetime (see
        # parallel/quorum.py FORCE_THREADS): a node that ever had a
        # remote disk may still hold RPC-backed lockers/peers, and
        # threaded fan-outs are always correct — only ~ms slower on
        # the single-core all-local case.
        from ..parallel import quorum
        quorum.FORCE_THREADS = True

    def __repr__(self) -> str:
        return f"RemoteStorage({self.client.endpoint()}{self.disk_path})"

    def _drive_key(self) -> str:
        """Drive-health identity of this remote disk (duck-typed:
        in-process loopback clients in tests have no endpoint())."""
        host = getattr(self.client, "endpoint", lambda: "?")()
        return f"{host}{self.disk_path}"

    def _call(self, method: str, args: dict | None = None,
              payload: bytes = b"") -> tuple[dict, bytes]:
        a = {"disk": self.disk_path}
        a.update(args or {})
        # Deadline fast-fail: a shard fan-out whose request budget is
        # spent skips the remote I/O entirely (the transport would
        # refuse too, but this avoids even building the span).
        from ..qos.deadline import current_deadline
        ddl = current_deadline()
        if ddl is not None:
            ddl.check(f"rpc.storage.{method}")
        # Drive-health accounting at the CLIENT boundary: wire time
        # included, because that is what this node's quorum fan-outs
        # actually wait on for a remote disk (obs/drivemon.py).
        import time as _time
        from ..obs.drivemon import DRIVEMON, is_drive_fault
        from ..obs.span import TRACER, current_span
        t0 = _time.perf_counter()
        err = None
        try:
            if current_span() is None:  # untraced fast path: no tags
                return self.client.call("storage", method, a, payload)
            # Traced callers get a client-side RPC span here; the
            # peer's server-side subtree grafts under the SAME span
            # when the transport pops _trace_spans (rpc/transport.py),
            # so wire time vs remote disk time separate cleanly in the
            # stitched trace.
            with TRACER.span(f"rpc.storage.{method}",
                             endpoint=getattr(self.client, "endpoint",
                                              lambda: "?")(),
                             disk=self.disk_path):
                return self.client.call("storage", method, a, payload)
        except BaseException as e:
            err = e
            raise
        finally:
            DRIVEMON.record(self._drive_key(), method,
                            (_time.perf_counter() - t0) * 1e3,
                            error=is_drive_fault(err))

    def endpoint(self) -> str:
        return f"{self.client.endpoint()}{self.disk_path}"

    def is_online(self) -> bool:
        return self.client.is_online()

    def disk_info(self) -> dict:
        return self._call("disk_info")[0]

    def make_volume(self, volume):
        self._call("make_volume", {"volume": volume})

    def list_volumes(self):
        return self._call("list_volumes")[0]["volumes"]

    def stat_volume(self, volume):
        return self._call("stat_volume", {"volume": volume})[0]

    def delete_volume(self, volume, force=False):
        self._call("delete_volume", {"volume": volume, "force": force})

    def write_all(self, volume, path, data):
        self._call("write_all", {"volume": volume, "path": path},
                   bytes(data))

    def read_all(self, volume, path):
        data = self._call("read_all", {"volume": volume,
                                       "path": path})[1]
        # Corrupt-over-the-wire injection (faultinject/):
        # keyed by the remote drive identity so a plan can rot ONE
        # peer disk's reads — the caller's bitrot verification must
        # catch it exactly like on-platter rot.
        from ..faultinject import FAULTS
        return FAULTS.filter_read(self._drive_key(), "read_all", data)

    def read_file(self, volume, path, offset, length):
        data = self._call("read_file", {"volume": volume, "path": path,
                                        "offset": offset,
                                        "length": length})[1]
        from ..faultinject import FAULTS
        return FAULTS.filter_read(self._drive_key(), "read_file", data)

    def repair_project(self, volume, path, ranges):
        # The whole point of REGEN repair: ONE round trip carrying only
        # the projection bytes (d stored rows per group), not a ranged
        # read per row and never the helper's full chunk.
        data = self._call("repair_project",
                          {"volume": volume, "path": path,
                           "ranges": [[o, ln] for o, ln in ranges]})[1]
        from ..faultinject import FAULTS
        return FAULTS.filter_read(self._drive_key(), "repair_project",
                                  data)

    def create_file(self, volume, path, data):
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._call("create_file", {"volume": volume, "path": path},
                       bytes(data))
            return
        # Streamed write: first chunk creates/truncates, the rest append
        # — one bounded RPC frame per chunk, never the whole object
        # (ref storageRESTClient.CreateFile streaming body,
        # cmd/storage-rest-client.go). On the async fabric the chunk
        # frames ride ONE pipelined connection (up to aio.
        # PIPELINE_WINDOW in flight) so chunk N's upload overlaps the
        # peer's disk write for chunks N-1..N-3 instead of paying a
        # full round-trip stall per chunk.
        from . import aio
        if aio.fabric_async() and isinstance(self.client, RPCClient):
            self._create_file_pipelined(volume, path, data)
            return
        first = True
        for chunk in data:
            if first:
                self._call("create_file",
                           {"volume": volume, "path": path}, bytes(chunk))
                first = False
            else:
                self._call("append_file",
                           {"volume": volume, "path": path}, bytes(chunk))
        if first:  # empty stream still creates the file
            self._call("create_file", {"volume": volume, "path": path},
                       b"")

    def _create_file_pipelined(self, volume: str, path: str,
                               chunks) -> None:
        """Streamed create over one pipelined connection. Chunk frames
        carry no per-call trace header (a big object would mint one
        server span per append); traced callers get a single
        client-side span for the whole stream, and drive-health
        accounting records one create_file covering the wire time the
        quorum fan-out actually waited."""
        from . import aio
        from ..qos.deadline import current_deadline
        ddl = current_deadline()
        if ddl is not None:
            ddl.check("rpc.storage.create_file")
        import time as _time
        from ..obs.drivemon import DRIVEMON, is_drive_fault
        from ..obs.span import TRACER, current_span
        a = {"disk": self.disk_path, "volume": volume, "path": path}
        t0 = _time.perf_counter()
        err = None
        try:
            span = (TRACER.span("rpc.storage.create_file",
                                endpoint=self.client.endpoint(),
                                disk=self.disk_path, pipelined=True)
                    if current_span() is not None else None)
            with span if span is not None else _NULL_CTX:
                pipe = aio.Pipeline(self.client)
                try:
                    first = True
                    for chunk in chunks:
                        pipe.send("storage",
                                  "create_file" if first
                                  else "append_file", a, bytes(chunk))
                        first = False
                    if first:  # empty stream still creates the file
                        pipe.send("storage", "create_file", a, b"")
                    pipe.finish()
                except BaseException:
                    pipe.abort()
                    raise
        except BaseException as e:
            err = e
            raise
        finally:
            DRIVEMON.record(self._drive_key(), "create_file",
                            (_time.perf_counter() - t0) * 1e3,
                            error=is_drive_fault(err))

    def append_file(self, volume, path, data):
        self._call("append_file", {"volume": volume, "path": path},
                   bytes(data))

    def delete(self, volume, path, recursive=False):
        self._call("delete", {"volume": volume, "path": path,
                              "recursive": recursive})

    def rename_file(self, src_volume, src_path, dst_volume, dst_path):
        self._call("rename_file", {"src_volume": src_volume,
                                   "src_path": src_path,
                                   "dst_volume": dst_volume,
                                   "dst_path": dst_path})

    def list_dir(self, volume, path):
        return self._call("list_dir", {"volume": volume,
                                       "path": path})[0]["entries"]

    def walk_dir_iter(self, volume, prefix="", after=""):
        # Streaming walk over the paged RPC: yield each page as it
        # arrives; the resume token (last yielded name) makes every
        # frame independent, so peak RPC frame size and client memory
        # are O(page) regardless of bucket size.
        while True:
            res, _ = self._call("walk_dir", {
                "volume": volume, "prefix": prefix, "after": after,
                "limit": WALK_PAGE_ENTRIES})
            entries = res["entries"]
            yield from entries
            if not res.get("truncated") or not entries:
                return
            after = entries[-1]["name"]

    def walk_dir(self, volume, prefix=""):
        return list(self.walk_dir_iter(volume, prefix))

    def rename_data(self, src_volume, src_path, fi, dst_volume, dst_path):
        self._call("rename_data", {"src_volume": src_volume,
                                   "src_path": src_path,
                                   "fi": _fi_to_wire(fi),
                                   "dst_volume": dst_volume,
                                   "dst_path": dst_path})

    def write_metadata(self, volume, path, fi):
        self._call("write_metadata", {"volume": volume, "path": path,
                                      "fi": _fi_to_wire(fi)})

    def read_version(self, volume, path, version_id=""):
        res, _ = self._call("read_version", {"volume": volume,
                                             "path": path,
                                             "version_id": version_id})
        return _fi_from_wire(res["fi"])

    def read_versions(self, volume, path):
        res, _ = self._call("read_versions", {"volume": volume,
                                              "path": path})
        return [_fi_from_wire(d) for d in res["fis"]]

    def delete_version(self, volume, path, fi):
        self._call("delete_version", {"volume": volume, "path": path,
                                      "fi": _fi_to_wire(fi)})

    def read_parts(self, volume, path, data_dir):
        return self._call("read_parts", {"volume": volume, "path": path,
                                         "data_dir": data_dir,
                                         })[0]["parts"]

    def verify_file(self, volume, path, fi):
        self._call("verify_file", {"volume": volume, "path": path,
                                   "fi": _fi_to_wire(fi)})
