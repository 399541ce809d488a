"""Per-drive health monitor: rolling latency EWMAs + error tracking
with peer-relative outlier scoring.

The dominant failure mode in large erasure-coded arrays is not the dead
disk (quorum absorbs that) but the SLOW one: every quorum fan-out waits
on its laggard, so a single degraded drive silently drags the whole
set's tail (arXiv:1709.05365 measures exactly this on large SSD arrays;
the Mojette evaluation in arXiv:1504.07038 shows the same tail
sensitivity for hot data). The reference tracks per-drive health for
`mc admin obd`; this module closes the loop for the TPU stack.

Recording points (both boundaries the data plane actually crosses):
  - ``storage/xl.py`` ``_DiskOp`` — every local disk op;
  - ``rpc/storage.py`` ``RemoteStorage._call`` — every remote-disk RPC
    (wire time included, which is what the caller's quorum waits on).

Model: per (drive, op-class in read/write/stat/delete) latency EWMA,
advanced when a drive closes an evaluation window (``WINDOW_OPS`` ops).
On window close the drive is scored against its erasure-set peers
(registered by ``ErasureObjects.__init__``): a drive whose EWMA exceeds
``OUTLIER_K`` x the peer median for ``SUSPECT_WINDOWS`` consecutive
windows becomes *suspect*; a drive with a sustained window error rate
becomes *faulty*. Transitions emit a console-log line, a span event on
the active trace (if any), and metrics-v2 gauges/counters.

Cost discipline: ``record()`` is one lock + a handful of dict/float
updates; metrics and peer scoring run only on window close (1/16 ops).

The port's own copy of ``minio_tpu/obs/drivemon.py``, with no change in
behaviour.
"""

from __future__ import annotations

import hashlib
import statistics
import threading
import time

from ..storage import errors as serr

OP_CLASSES = ("read", "write", "stat", "delete")

# Storage-op / RPC-method name -> coarse op class. Unknown ops score
# as "stat" (cheap metadata-ish work).
_OP_CLASS = {
    "read_all": "read", "read_file": "read", "read_version": "read",
    "read_versions": "read", "read_parts": "read", "list_dir": "read",
    "list_volumes": "read", "walk_dir": "read", "verify_file": "read",
    "write_all": "write", "append_file": "write", "create_file": "write",
    "link_file": "write", "rename_file": "write", "rename_data": "write",
    "write_metadata": "write", "make_volume": "write",
    "disk_info": "stat", "stat_volume": "stat",
    "delete": "delete", "delete_version": "delete",
    "delete_volume": "delete",
}


def op_class(op: str) -> str:
    return _OP_CLASS.get(op, "stat")


# Namespace misses are the data plane working as designed (idempotent
# deletes, probes of keys that do not exist, racing bucket deletes) —
# they must never count against a drive's health. The builtin ENOENT
# family covers ops whose miss surfaces before xl.py re-types it.
_BENIGN = (serr.FileNotFound, serr.VersionNotFound, serr.VolumeNotFound,
           serr.VolumeExists, FileNotFoundError, IsADirectoryError,
           NotADirectoryError, FileExistsError)

# Connectivity loss is the TRANSPORT's failure domain, not the drive's:
# DiskNotFound is what a peer's drives surface while the peer is
# offline (rpc/transport.py health gate). Counting it as drive-fault
# evidence would quarantine every drive of a rebooting node — and
# probation (bitrot shadow probes) would then hold its WRITES off for
# whole probe windows after the peer is already back, while the
# transport gate re-opens in seconds. Media evidence only.
_CONNECTIVITY = (serr.DiskNotFound,)


def is_drive_fault(exc) -> bool:
    """True when an exception (instance or type) is evidence of a bad
    drive rather than a namespace miss or a caller-side cancel."""
    if exc is None:
        return False
    if isinstance(exc, type):
        if issubclass(exc, _BENIGN + _CONNECTIVITY):
            return False
        return exc.__name__ != "DeadlineExceeded"
    if isinstance(exc, _BENIGN + _CONNECTIVITY):
        return False
    return type(exc).__name__ != "DeadlineExceeded"


OK, SUSPECT, FAULTY = "ok", "suspect", "faulty"
_STATE_VALUE = {OK: 0, SUSPECT: 1, FAULTY: 2}


def drive_key(disk) -> str:
    """Canonical health identity for a disk object (local XLStorage,
    RemoteStorage, or a duck-typed test double): the key every
    data-plane boundary records under and every health consumer —
    read selection, quarantine gates, config stores — queries by."""
    try:
        return disk.endpoint()
    except Exception:
        return str(disk)


class _Drive:
    __slots__ = ("endpoint", "set_id", "state", "ewma", "win_lat",
                 "win_ops", "win_errs", "hot_windows", "err_windows",
                 "ops_total", "errs_total", "windows", "changed_at",
                 "last_score", "mu", "quarantined", "probation_passes")

    def __init__(self, endpoint: str, set_id: int):
        # PER-DRIVE lock: the record() hot path runs inside quorum
        # fan-outs where k+m worker threads hit k+m DIFFERENT drives
        # simultaneously — one registry-wide lock there serializes the
        # whole fan-out (measured ~1ms/PUT on a 2-core gVisor box,
        # ~10x futex cost). Per-drive locks make concurrent records
        # contention-free; the registry lock guards only topology.
        self.mu = threading.Lock()
        self.endpoint = endpoint
        self.set_id = set_id
        self.state = OK
        self.ewma: dict[str, float] = {}
        self.win_lat: dict[str, list] = {}  # class -> [sum_ms, count]
        self.win_ops = 0
        self.win_errs = 0
        self.hot_windows = 0
        self.err_windows = 0
        self.ops_total = 0
        self.errs_total = 0
        self.windows = 0
        self.changed_at = 0.0
        self.last_score = 0.0
        # Quarantine lifecycle (set on entering FAULTY when
        # AUTO_QUARANTINE): the data plane excludes this drive from
        # read selection and write fan-out; window scoring freezes
        # until probation probes reinstate it.
        self.quarantined = False
        self.probation_passes = 0


class DriveMonitor:
    """Process-wide drive-health tracker (singleton ``DRIVEMON``)."""

    # Ops per evaluation window per drive.
    WINDOW_OPS = 16
    # Suspect when EWMA > OUTLIER_K x median of erasure-set peers...
    OUTLIER_K = 3.0
    # ...for this many CONSECUTIVE windows (absorbs one-off stalls).
    SUSPECT_WINDOWS = 2
    # Floor under the peer median: sub-ms jitter between healthy
    # drives must not create outliers (ratios explode near zero).
    MEDIAN_FLOOR_MS = 0.2
    # Absolute excess a drive must ALSO show over the peer median
    # before the ratio counts: on fast local disks (tmpfs, NVMe) the
    # healthy spread is fractions of a millisecond, where scheduler
    # jitter alone produces 3x ratios — a drive that is "3x slower"
    # by 0.4ms is not dragging any quorum tail.
    MIN_EXCESS_MS = 5.0
    # A suspect must DOMINATE its set: also this factor over the WORST
    # peer. The target failure mode is the single laggard drive
    # (arXiv:1709.05365); requiring dominance means host-wide
    # starvation (every drive slow at once) and scheduler bias against
    # one healthy drive — both of which drag the median/max together —
    # cannot co-flag bystanders while a genuinely slow drive exists.
    # Known tradeoff: two drives degraded to the SAME latency flag
    # neither; the error path and operator EWMAs still surface them.
    DOMINANCE = 1.5
    # Faulty when a window's error rate stays at/above this...
    ERROR_RATE = 0.5
    # ...for this many consecutive windows.
    FAULTY_WINDOWS = 2
    # EWMA weight of each new window mean.
    ALPHA = 0.3
    # Peers needed (with data for the op class) before outlier scoring
    # engages — a lone drive has no one to be an outlier against.
    MIN_PEERS = 2
    # Entering FAULTY auto-quarantines the drive: the data plane stops
    # reading from / writing to it (erasure/engine.py consults
    # is_quarantined), and only probation probes can bring it back.
    AUTO_QUARANTINE = True
    # Consecutive probation probe rounds (shadow read + bitrot verify,
    # erasure/heal.py QuarantineProber) that must pass before a
    # quarantined drive rejoins the read/write set.
    PROBATION_PASSES = 3

    def __init__(self):
        self.enabled = True
        self._mu = threading.Lock()
        self._drives: dict[str, _Drive] = {}
        self._set_members: dict[int, list[str]] = {}
        self._next_set = 0

    # -- topology ------------------------------------------------------

    def register_set(self, endpoints: list[str]) -> int:
        """Declare one erasure set's drives as peers of each other
        (called by ErasureObjects.__init__). Re-registering an endpoint
        moves it to the new set."""
        with self._mu:
            set_id = self._next_set
            self._next_set += 1
            self._set_members[set_id] = list(endpoints)
            for ep in endpoints:
                d = self._drives.get(ep)
                if d is None:
                    self._drives[ep] = _Drive(ep, set_id)
                else:
                    old = self._set_members.get(d.set_id)
                    if old is not None and ep in old:
                        old.remove(ep)
                    d.set_id = set_id
            return set_id

    # -- recording -----------------------------------------------------

    def record(self, endpoint: str, op: str, latency_ms: float,
               error: bool = False) -> None:
        """Account one disk op (local ``_DiskOp`` or remote RPC)."""
        if not self.enabled:
            return
        cls = op_class(op)
        # Dict read without the registry lock is GIL-atomic; only the
        # first-ever record of an unknown drive takes the slow path.
        d = self._drives.get(endpoint)
        if d is None:
            with self._mu:
                d = self._drives.get(endpoint)
                if d is None:
                    # Unregistered drive (no engine): singleton group.
                    set_id = self._next_set
                    self._next_set += 1
                    self._set_members[set_id] = [endpoint]
                    d = self._drives[endpoint] = _Drive(endpoint,
                                                        set_id)
        transition = None
        with d.mu:
            acc = d.win_lat.get(cls)
            if acc is None:
                acc = d.win_lat[cls] = [0.0, 0]
            acc[0] += latency_ms
            acc[1] += 1
            d.win_ops += 1
            d.ops_total += 1
            if error:
                d.win_errs += 1
                d.errs_total += 1
            if d.win_ops >= self.WINDOW_OPS:
                transition = self._close_window(d)
        if error:
            from .metrics2 import METRICS2
            # Metric labels use the redacted identity: the metrics
            # pages are unauthenticated, and absolute disk paths must
            # not leak there (admin /drive-health maps them back).
            METRICS2.inc("minio_tpu_v2_drive_op_errors_total",
                         {"disk": redacted_endpoint(endpoint),
                          "op_class": cls})
        if transition is not None:
            self._announce(*transition)

    # -- window evaluation (caller holds the DRIVE's lock; peer EWMA
    # reads cross drives without their locks — plain float/dict reads
    # are GIL-safe and monitoring tolerates a window of staleness) ----

    def _close_window(self, d: _Drive):
        d.windows += 1
        for cls, (s, c) in d.win_lat.items():
            if c:
                mean = s / c
                prev = d.ewma.get(cls)
                d.ewma[cls] = mean if prev is None else (
                    self.ALPHA * mean + (1 - self.ALPHA) * prev)
        err_rate = d.win_errs / max(1, d.win_ops)
        d.err_windows = d.err_windows + 1 \
            if err_rate >= self.ERROR_RATE else 0
        d.last_score = self._outlier_score(d)
        d.hot_windows = d.hot_windows + 1 \
            if d.last_score >= self.OUTLIER_K else 0
        d.win_lat = {}
        d.win_ops = 0
        d.win_errs = 0
        if d.quarantined:
            # Frozen: a quarantined drive sees only probe/heal traffic,
            # and a quiet window of THAT must not silently clear the
            # state — reinstatement is the probation prober's decision
            # (bitrot-verified shadow reads), never a scoring artifact.
            return None
        new_state = OK
        if d.err_windows >= self.FAULTY_WINDOWS:
            new_state = FAULTY
        elif d.hot_windows >= self.SUSPECT_WINDOWS:
            new_state = SUSPECT
        if new_state == FAULTY and self.AUTO_QUARANTINE:
            d.quarantined = True
            d.probation_passes = 0
        if new_state == d.state:
            return None
        old, d.state = d.state, new_state
        d.changed_at = time.time()
        return d.endpoint, old, new_state, round(d.last_score, 2)

    def _outlier_score(self, d: _Drive) -> float:
        """max over op classes of ewma / median(peer ewmas)."""
        peers = [self._drives[ep]
                 for ep in self._set_members.get(d.set_id, ())
                 if ep != d.endpoint and ep in self._drives]
        worst = 0.0
        for cls, mine in d.ewma.items():
            vals = [p.ewma[cls] for p in peers if cls in p.ewma]
            if len(vals) < self.MIN_PEERS:
                continue
            med = max(statistics.median(vals), self.MEDIAN_FLOOR_MS)
            if mine - med < self.MIN_EXCESS_MS:
                continue  # jitter-scale spread, not a dragging drive
            if mine < self.DOMINANCE * max(vals):
                continue  # not the set's laggard (see DOMINANCE)
            worst = max(worst, mine / med)
        return worst

    # -- transition fan-out (outside the lock) -------------------------

    def _announce(self, endpoint: str, old: str, new: str,
                  score: float) -> None:
        from ..logger import Logger
        from .metrics2 import METRICS2
        from .span import current_span
        quarantined = self.is_quarantined(endpoint)
        note = " [quarantined]" if quarantined else ""
        red = redacted_endpoint(endpoint)
        Logger.get().info(
            f"drivemon: {endpoint} {old} -> {new}{note} "
            f"(peer-relative score {score}x)", "drivemon",
            disk=red, state=new, quarantined=quarantined)
        METRICS2.set_gauge("minio_tpu_v2_drive_state",
                           {"disk": red}, _STATE_VALUE[new])
        METRICS2.inc("minio_tpu_v2_drive_state_transitions_total",
                     {"disk": red, "state": new})
        if quarantined and new == FAULTY:
            METRICS2.inc("minio_tpu_v2_drive_quarantines_total",
                         {"disk": red})
        for cls, v in self.ewma_for(endpoint).items():
            METRICS2.set_gauge("minio_tpu_v2_drive_op_latency_ewma_ms",
                               {"disk": red, "op_class": cls}, v)
        span = current_span()
        if span is not None:
            span.add_event("drive.state", disk=endpoint, state=new,
                           score=score, quarantined=quarantined)

    # -- quarantine / probation lifecycle ------------------------------

    def is_quarantined(self, endpoint: str) -> bool:
        """Lock-free hot-path check (GIL-atomic dict/attr reads); the
        read/write selection paths call this per drive per request."""
        d = self._drives.get(endpoint)
        return d is not None and d.quarantined

    def quarantined_endpoints(self) -> list[str]:
        with self._mu:
            return [ep for ep, d in sorted(self._drives.items())
                    if d.quarantined]

    def quarantine(self, endpoint: str, reason: str = "manual") -> None:
        """Force a drive into quarantine (the FAULTY auto-path runs
        through _close_window; this is the explicit entry for admin /
        test use)."""
        with self._mu:
            d = self._drives.get(endpoint)
            if d is None or d.quarantined:
                return
            old = d.state
            with d.mu:
                d.quarantined = True
                d.probation_passes = 0
                d.state = FAULTY
                d.changed_at = time.time()
        self._announce(endpoint, old, FAULTY, 0.0)

    def probation_pass(self, endpoint: str) -> bool:
        """One successful probation probe (shadow read passed bitrot
        verification). Returns True when the drive just crossed
        PROBATION_PASSES and was reinstated."""
        from .metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_drive_probation_probes_total",
                     {"result": "pass"})
        with self._mu:
            d = self._drives.get(endpoint)
            if d is None or not d.quarantined:
                return False
            d.probation_passes += 1
            if d.probation_passes < self.PROBATION_PASSES:
                return False
        self.reinstate(endpoint)
        return True

    def probation_fail(self, endpoint: str) -> None:
        """A probation probe failed: the streak restarts."""
        from .metrics2 import METRICS2
        METRICS2.inc("minio_tpu_v2_drive_probation_probes_total",
                     {"result": "fail"})
        with self._mu:
            d = self._drives.get(endpoint)
            if d is not None:
                d.probation_passes = 0

    def reinstate(self, endpoint: str) -> None:
        """Probation passed: the drive rejoins the read/write set with
        a clean slate (EWMAs kept — they decay naturally; counters
        that drive state transitions reset so one old error window
        cannot instantly re-quarantine a healthy drive)."""
        with self._mu:
            d = self._drives.get(endpoint)
            if d is None or not d.quarantined:
                return
            old = d.state
            with d.mu:
                d.quarantined = False
                d.probation_passes = 0
                d.err_windows = 0
                d.hot_windows = 0
                d.win_lat = {}
                d.win_ops = 0
                d.win_errs = 0
                d.state = OK
                d.changed_at = time.time()
        self._announce(endpoint, old, OK, 0.0)

    # -- reads ---------------------------------------------------------

    def ewma_for(self, endpoint: str) -> dict[str, float]:
        with self._mu:
            d = self._drives.get(endpoint)
            return dict(d.ewma) if d is not None else {}

    def state_of(self, endpoint: str) -> str:
        with self._mu:
            d = self._drives.get(endpoint)
            return d.state if d is not None else OK

    def endpoints(self) -> list[str]:
        """Every registered drive endpoint (the hot-object cache maps
        its disk-tier dirs onto these by path prefix for
        health-informed placement)."""
        with self._mu:
            return list(self._drives)

    def counts(self) -> tuple[int, int]:
        """(suspect, faulty) drive counts."""
        with self._mu:
            s = sum(1 for d in self._drives.values()
                    if d.state == SUSPECT)
            f = sum(1 for d in self._drives.values()
                    if d.state == FAULTY)
            return s, f

    def snapshot(self) -> dict:
        """JSON-ready node view (the `/minio-tpu/v2/health/drives`
        payload; the cluster endpoint fan-in merges these)."""
        with self._mu:
            drives = []
            for ep, d in sorted(self._drives.items()):
                drives.append({
                    "endpoint": ep,
                    "set": d.set_id,
                    "state": d.state,
                    "quarantined": d.quarantined,
                    "probationPasses": d.probation_passes,
                    "opsTotal": d.ops_total,
                    "errsTotal": d.errs_total,
                    "windows": d.windows,
                    "hotWindows": d.hot_windows,
                    "errWindows": d.err_windows,
                    "score": round(d.last_score, 3),
                    "ewmaMs": {c: round(v, 3)
                               for c, v in sorted(d.ewma.items())},
                    "changedAt": d.changed_at,
                })
            suspect = sum(1 for x in drives if x["state"] == SUSPECT)
            faulty = sum(1 for x in drives if x["state"] == FAULTY)
            quarantined = sum(1 for x in drives if x["quarantined"])
        return {"drives": drives, "suspect": suspect, "faulty": faulty,
                "quarantined": quarantined}

    def reset(self) -> None:
        with self._mu:
            self._drives.clear()
            self._set_members.clear()
            self._next_set = 0


def redacted_endpoint(ep: str) -> str:
    """Short stable drive identity for UNAUTHENTICATED surfaces: the
    last two path components plus a digest prefix — enough to tell
    drives apart and correlate with the authenticated admin view,
    without disclosing absolute server filesystem paths or full
    internal topology to anonymous probes."""
    tail = "/".join(ep.replace("\\", "/").rstrip("/").split("/")[-2:])
    return f"{tail}#{hashlib.sha256(ep.encode()).hexdigest()[:8]}"


def redact_drives(doc: dict) -> dict:
    """Copy of a drivemon snapshot (or cluster merge) with every
    drive row's endpoint redacted (see redacted_endpoint)."""
    out = dict(doc)
    out["drives"] = [
        dict(d, endpoint=redacted_endpoint(str(d.get("endpoint", ""))))
        if isinstance(d, dict) else d
        for d in doc.get("drives", [])]
    return out


# The process-wide monitor every recording boundary shares.
DRIVEMON = DriveMonitor()
