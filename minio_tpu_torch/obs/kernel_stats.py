"""Data-plane kernel accounting: every kernel entry point records
through ``KERNEL`` into the v2 registry (``minio_tpu_v2_kernel_*``),
per kernel x device: invocations, bytes, wall seconds, batch-occupancy
blocks and coalesced request counts. Kernel identities:

- ``rs_encode``   — batched Reed-Solomon encode
- ``rs_decode``   — mask-grouped reconstruction
- ``hh256``       — batched HighwayHash bitrot hashing
- ``select_scan`` — the columnar S3 Select predicate scan

The port's own copy of ``minio_tpu/obs/kernel_stats.py``. The series
and their labels are the reference's (the accelerator lane keeps the
label value ``device="tpu"``), so a reader of one package's metrics
reads the other's. Every record also feeds the per-dispatch profiler
(``obs/kernprof.py``) with the lane that ran, and through it the codec
autotuner.
"""

from __future__ import annotations

import time

from .metrics2 import METRICS2

RS_ENCODE = "rs_encode"
RS_DECODE = "rs_decode"
HH256 = "hh256"
# Columnar S3 Select predicate scan (ops/select_kernels.py): the
# analytics workload's kernel identity in the kernel series.
SELECT_SCAN = "select_scan"


class KernelStats:
    """Recording facade over the v2 registry's kernel counters.

    ``backend`` refines the binary device flag into the real dispatch
    lane (obs/kernprof.py BACKENDS: device / native / torch-cpu / host);
    every record also feeds the kernprof per-dispatch profile layer --
    latency histogram per (kernel, backend, batch bucket), per-backend
    byte counters, and the backend health state machine's success
    outcomes.  Callers that don't know their lane omit it and the coarse
    device flag maps to device/host."""

    @staticmethod
    def record(kernel: str, device: bool, nbytes: int,
               wall_s: float = 0.0, blocks: int = 0,
               requests: int = 1, backend: str | None = None) -> None:
        lbl = {"kernel": kernel, "device": "tpu" if device else "host"}
        METRICS2.inc("minio_tpu_v2_kernel_invocations_total", lbl)
        METRICS2.inc("minio_tpu_v2_kernel_bytes_total", lbl, nbytes)
        if wall_s:
            METRICS2.inc("minio_tpu_v2_kernel_wall_seconds_total", lbl,
                         wall_s)
        if blocks:
            METRICS2.inc("minio_tpu_v2_kernel_batch_blocks_total", lbl,
                         blocks)
        if requests > 1:
            METRICS2.inc("minio_tpu_v2_kernel_coalesced_requests_total",
                         lbl, requests)
        from .kernprof import DEVICE, HOST, KERNPROF
        if backend is None:
            backend = DEVICE if device else HOST
        KERNPROF.record_dispatch(kernel, backend, nbytes, wall_s,
                                 blocks)

    @staticmethod
    def record_coalesced(kernel: str, requests: int) -> None:
        METRICS2.inc("minio_tpu_v2_kernel_coalesced_requests_total",
                     {"kernel": kernel, "device": "tpu"}, requests)

    @staticmethod
    def snapshot() -> dict:
        """{kernel/device: {invocations, bytes, wall_seconds, blocks}}
        — the admin-info / test view of the registry's kernel series."""
        out: dict[str, dict] = {}
        snap = METRICS2.snapshot()
        for metric, field in (
                ("minio_tpu_v2_kernel_invocations_total", "invocations"),
                ("minio_tpu_v2_kernel_bytes_total", "bytes"),
                ("minio_tpu_v2_kernel_wall_seconds_total",
                 "wall_seconds"),
                ("minio_tpu_v2_kernel_batch_blocks_total", "blocks")):
            for s in snap.get(metric, {}).get("series", []):
                lb = s["labels"]
                key = f"{lb.get('kernel')}/{lb.get('device')}"
                out.setdefault(key, {})[field] = s["value"]
        return out


KERNEL = KernelStats()


class timed:
    """``with timed() as t: ...; t.s`` — wall-clock for kernel calls."""

    __slots__ = ("t0", "s")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self.t0
        return False
