"""Native (C++) host-side kernels, built on demand with g++, loaded with
ctypes: the kernprof ``native`` lane.

Port of minio_tpu/native/__init__.py. ``rs.cc`` (GF(2^8) matrix apply,
nibble-shuffle tables) and ``highwayhash.cc`` are the reference's
sources, byte for byte. They are compiled at first use into
``minio_tpu_torch/build/native/`` (git-ignored), with ``-march=native``
for the CPU the process runs on.

A failed build, or a built library that does not load, raises
``BuildFailed`` at first use: a missing or broken compiler is an
installation fault, never a lane state. A library that
built but answers wrong is: ``_disable_native`` distrusts it for the
rest of the process (callers fall back to their numpy path, loudly, and
the kernprof ``native`` lane hears of it), and only ``probe()`` re-adopts
it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

from ..ops._cuda import BuildFailed

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "native")
_SOURCES = ("highwayhash.cc", "rs.cc")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _compile(srcs: list[str], so: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC",
             "-o", tmp] + srcs, capture_output=True, text=True,
            timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise BuildFailed(f"g++ could not build the native kernels: "
                         f"{exc!r}") from exc
    if proc.returncode != 0:
        raise BuildFailed(f"g++ failed on the native kernels "
                         f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.hh256_hash.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_size_t, ctypes.c_char_p]
    lib.hh256_hash.restype = None
    lib.hh256_chunks.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_size_t, ctypes.c_size_t,
                                 ctypes.c_char_p]
    lib.hh256_chunks.restype = ctypes.c_size_t
    lib.rs_gf_apply.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_void_p]
    lib.rs_gf_apply.restype = None
    lib.rs_gf_apply_mt.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t]
    lib.rs_gf_apply_mt.restype = None
    return lib


def _load(so: str) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(so)
    except OSError as exc:  # built but does not load: a broken build
        raise BuildFailed(f"{so} does not load: {exc!r}") from exc


def _build_and_load() -> ctypes.CDLL:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    so = os.path.join(_BUILD_DIR, "libminio_tpu_torch_native.so")
    if (not os.path.exists(so)
            or any(os.path.getmtime(so) < os.path.getmtime(s)
                   for s in srcs)):
        _compile(srcs, so)
    lib = _load(so)
    if not hasattr(lib, "rs_gf_apply_mt"):  # newest symbol
        # A stale cached .so predating a source (mtime preserved by a
        # copy): rebuild rather than fail every native path on the
        # missing symbol. The rebuild loads under a fresh name -- the
        # dynamic loader hands back the stale library already mapped
        # under `so` -- and then takes its place.
        fresh = f"{so}.{os.getpid()}.{time.monotonic_ns()}"
        _compile(srcs, fresh)
        lib = _load(fresh)
        os.replace(fresh, so)
    try:
        return _bind(lib)
    except AttributeError as exc:  # a symbol is missing after a rebuild
        raise BuildFailed(f"{so} lacks a native kernel: {exc}") from exc


def get_lib() -> ctypes.CDLL | None:
    """The loaded library; None only after ``_disable_native``. Builds
    on first use and raises ``BuildFailed`` when that fails."""
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        with _LOCK:
            if _LIB is None and not _TRIED:
                _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def _disable_native(reason: str) -> None:
    """A native kernel returned inconsistent results: distrust the
    whole library for the rest of the process (every caller degrades
    to its numpy/pure-Python path) and say so loudly once.  The
    kernprof backend state machine hears about it too, so the 'native'
    lane shows DEGRADED/DOWN and the recovery probe (``probe()``) owns
    re-adoption."""
    global _LIB, _TRIED
    import logging
    with _LOCK:
        _LIB = None
        _TRIED = True
    logging.getLogger("minio_tpu_torch.native").warning(
        "native kernel disabled: %s", reason)
    from ..obs.kernprof import KERNPROF, NATIVE
    KERNPROF.dispatch_failed(NATIVE, reason)


def probe() -> bool:
    """Recovery probe for the kernprof 'native' backend: re-attempt
    load (a ``_disable_native`` poisons the cached handle for the
    process -- this is the only path that clears it) and run a
    known-answer self-check through both exported kernel families.
    True only when the library loads AND answers correctly."""
    global _TRIED
    with _LOCK:
        if _LIB is None:
            _TRIED = False  # allow get_lib() to rebuild/reload
    if get_lib() is None:
        return False
    try:
        import numpy as np

        from ..ops.gf256 import gf_mat_vec_apply
        from ..ops.hh256 import MAGIC_KEY, HighwayHash256
        data = b"minio-tpu native probe"
        want = HighwayHash256(MAGIC_KEY).update(data).digest()
        if hh256_native(data, MAGIC_KEY) != want:
            _disable_native("probe: hh256 known-answer mismatch")
            return False
        mat = np.array([[1, 2], [3, 4]], dtype=np.uint8)
        cols = np.arange(2 * 64, dtype=np.uint8).reshape(2, 64)
        got = rs_apply_native(mat, cols)
        if got is None or not (got == gf_mat_vec_apply(mat,
                                                       cols)).all():
            _disable_native("probe: rs_gf_apply known-answer mismatch")
            return False
        return True
    except Exception as exc:  # noqa: BLE001 - a probe must not raise
        _disable_native(f"probe raised: {exc!r}")
        return False


def hh256_native(data: bytes, key: bytes) -> bytes | None:
    """One-shot HighwayHash-256 via C++; None if the library is
    disabled."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.hh256_hash(key, bytes(data), len(data), out)
    return out.raw


def hh256_chunks_native(data: bytes, chunk_size: int,
                        key: bytes) -> list[bytes] | None:
    """Hash consecutive chunk_size chunks (streaming-bitrot pattern)."""
    lib = get_lib()
    if lib is None:
        return None
    if len(data) == 0:
        return []
    n = -(-len(data) // chunk_size)
    out = ctypes.create_string_buffer(32 * n)
    got = lib.hh256_chunks(key, bytes(data), len(data), chunk_size, out)
    if got != n:
        # A short/garbled native return must NOT surface truncated
        # digests as valid: fall back by reporting unavailable.
        _disable_native(f"hh256_chunks returned {got}, expected {n}")
        return None
    return [out.raw[i * 32:(i + 1) * 32] for i in range(n)]


def hh256_rows_native(arr, key: bytes):
    """Hash each row of a (n, chunk) uint8 array -> (n, 32) uint8 array,
    with zero input copies for a contiguous array. None if the library
    is disabled. Byte-identical to hh256_chunks_native over
    arr.tobytes()."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    if arr.size == 0:
        return np.empty((0, 32), dtype=np.uint8)
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    n, chunk = a.shape
    out = np.empty((n, 32), dtype=np.uint8)
    got = lib.hh256_chunks(
        key, ctypes.cast(a.ctypes.data, ctypes.c_char_p), a.size,
        chunk, ctypes.cast(out.ctypes.data, ctypes.c_char_p))
    if got != n:
        _disable_native(f"hh256_chunks returned {got}, expected {n}")
        return None
    return out


# Large host applies (heal sweeps, mask-group folds) spread column ranges
# across threads; small ones stay single-threaded.
RS_MT_THRESHOLD = 8 * 1024 * 1024


def rs_apply_native(mat, data):
    """(r, k) GF(2^8) matrix applied to (k, n) byte rows -> (r, n), via
    the C++ nibble-shuffle kernel (native/rs.cc). None when the library
    is disabled. Byte-identical to gf256.gf_mat_vec_apply."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    r, k = mat.shape
    if data.shape[0] != k:
        raise ValueError(f"data rows {data.shape[0]} != k={k}")
    n = data.shape[1]
    out = np.empty((r, n), dtype=np.uint8)
    if data.nbytes >= RS_MT_THRESHOLD:
        nthreads = min(8, os.cpu_count() or 1)
        lib.rs_gf_apply_mt(mat.ctypes.data, r, k, data.ctypes.data, n,
                           out.ctypes.data, nthreads)
    else:
        lib.rs_gf_apply(mat.ctypes.data, r, k, data.ctypes.data, n,
                        out.ctypes.data)
    return out

