"""Device resolution and the build of the port's CUDA kernels.

The sources under ``minio_tpu_torch/csrc/`` are compiled for ``sm_90a``
at first use, one nvcc process per source, all started together, and
linked into one shared library with a plain C interface in
``minio_tpu_torch/build/`` (git-ignored). The library name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing file. It is loaded with ctypes; every
C entry point launches on the stream it is given and returns
``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module on a
machine without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("gf_apply.cu", "hh256.cu", "select_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_U64 = ctypes.c_uint64

# C signatures, one entry per exported launcher (see the .cu files).
_SIGNATURES = {
    # x, x_bstride, x_rstride, out, o_bstride, o_rstride, o_row0,
    # copy_data, packed, r, k, B, S, stream
    "gf_apply_launch": (_P, _I64, _I64, _P, _I64, _I64, _I64, _I, _P, _I,
                        _I, _I64, _I64, _P),
    # data, row_stride, B, L, key0..key3, out, stream
    "hh256_launch": (_P, _I64, _I64, _I64, _U64, _U64, _U64, _U64, _P, _P),
    # prog, n_ops, pool, args, cols, ncols, n, depth, out_pass, out_fb,
    # any_fb, stream
    "select_scan_launch": (_P, _I, _P, _P, _P, _I, _I64, _I, _P, _P, _P,
                           _P),
    # depth -> the stack's 32-bit words in the kernel (0: too deep)
    "select_scan_stack_words": (_I,),
}


class BuildFailed(RuntimeError):
    """A kernel library (the CUDA kernels here, the C++ host kernels in
    minio_tpu_torch/native) failed to build. Raised at first use and
    never taken as a lane's failure: a dispatch lane that cannot be built
    is a broken installation, not a DOWN lane to fail over from."""


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when it names CUDA and no
    card is present (entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_tensor(arr) -> torch.Tensor:
    """A contiguous host array as a CPU tensor over the same memory.

    Read-only numpy views (np.frombuffer over bytes) are wrapped without a
    copy; the port only ever reads such inputs, so torch's warning about
    non-writable arrays is silenced here."""
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(arr)


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A host uint8 array (or bytes-backed view) as a tensor on ``device``
    (no copy on the CPU)."""
    t = host_tensor(np.asarray(arr, dtype=np.uint8))
    return t.to(device) if device.type != "cpu" else t


class KernelLib:
    """The loaded kernel library plus how it was built."""

    def __init__(self, path: Path, build_seconds: float, ptxas_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self._dll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._dll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


_lib: KernelLib | None = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise BuildFailed("nvcc not found: the CUDA toolkit is needed to "
                     "build minio_tpu_torch/csrc")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile_and_link(so: Path) -> str:
    """nvcc -c for every source in parallel, then one link; returns the
    compilers' output (the ptxas register and spill report)."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC / src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    outs = [proc.communicate() for proc in procs]
    report = "".join(out + err for out, err in outs)
    try:
        for src, proc, (_, err) in zip(SOURCES, procs, outs):
            if proc.returncode != 0:
                raise BuildFailed(
                    f"nvcc failed on {src} ({proc.returncode}):\n{err}")
        tmp = so.with_suffix(f".{tag}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise BuildFailed(
                f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return report


def build() -> KernelLib:
    """Build (when needed) and load the kernel library; cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        tag = _source_hash()
        so = BUILD_DIR / f"libminio_tpu_torch_{tag}.so"
        log = BUILD_DIR / f"libminio_tpu_torch_{tag}.ptxas.txt"
        seconds = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            ptxas = _compile_and_link(so)
            seconds = time.perf_counter() - t0
            log.write_text(ptxas)
        try:
            _lib = KernelLib(so, seconds,
                             log.read_text() if log.exists() else "")
        except (OSError, AttributeError) as exc:
            # A library that built but does not load is a broken build.
            raise BuildFailed(f"{so} does not load: {exc!r}") from exc
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
