"""The port's native lane (minio_tpu_torch/native): the reference's C++
host kernels, built by the port's own loader into
minio_tpu_torch/build/native/, held byte for byte to the JAX package's
build of the same sources -- GF(2^8) apply (single- and multi-threaded),
HighwayHash-256 (one-shot, chunks, rows) -- plus the loader's contract:
a stale library is rebuilt, a failed build or a library that does not
load raises BuildFailed (never a lane state), and only probe() re-adopts
a library that ``_disable_native`` distrusted."""

from __future__ import annotations

import numpy as np
import pytest

from minio_tpu import native as ref_native
from minio_tpu.obs import kernprof as ref_kp
from minio_tpu.ops import batching as ref_batching
from minio_tpu.ops.gf256 import gf_mat_vec_apply
from minio_tpu.ops.hh256 import MAGIC_KEY
from minio_tpu.ops.rs_matrix import decode_matrix, parity_matrix
from minio_tpu_torch import native
from minio_tpu_torch.obs import kernprof as kp
from minio_tpu_torch.ops import _cuda, autotune, batching


@pytest.fixture(autouse=True)
def _fresh_health():
    kp.KERNPROF.reset()
    ref_kp.KERNPROF.reset()
    yield
    kp.KERNPROF.reset()
    ref_kp.KERNPROF.reset()


@pytest.fixture(scope="module")
def libs():
    """Both libraries, built (the port's build raises if g++ fails)."""
    port = native.get_lib()
    ref = ref_native.get_lib()
    assert port is not None and ref is not None
    return port, ref


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("k,m", [(4, 2), (8, 4), (12, 4), (16, 4)])
def test_rs_apply_matches_jax_native(libs, k, m):
    rng = _rng(k * 10 + m)
    pm = parity_matrix(k, m)
    for n in (1, 15, 16, 31, 32, 33, 1000, 65536):
        data = rng.integers(0, 256, (k, n)).astype(np.uint8)
        got = native.rs_apply_native(pm, data)
        assert np.array_equal(got, ref_native.rs_apply_native(pm, data)), n
        assert np.array_equal(got, gf_mat_vec_apply(pm, data)), n


def test_rs_apply_decode_matrix_matches_jax_native(libs):
    k, m = 8, 4
    avail = [i for i in range(k + m) if i not in (0, 5)]
    dec, used = decode_matrix(k, m, avail)
    rows = dec[[0, 5], :]
    data = _rng(1).integers(0, 256, (len(used), 515)).astype(np.uint8)
    assert np.array_equal(native.rs_apply_native(rows, data),
                          ref_native.rs_apply_native(rows, data))


@pytest.mark.parametrize("n,threads", [(1_000_037, 4), (8 * 131072 + 3, 8),
                                       (4099, 3)])
def test_rs_apply_threaded_matches_jax_native(libs, n, threads):
    """The column-split kernel, forced to `threads`, against the JAX
    package's single-threaded one (ragged chunk seams included)."""
    port, ref = libs
    k, m = 8, 4
    data = np.ascontiguousarray(
        _rng(7).integers(0, 256, (k, n)).astype(np.uint8))
    pm = np.ascontiguousarray(parity_matrix(k, m))
    out = np.empty((m, n), dtype=np.uint8)
    port.rs_gf_apply_mt(pm.ctypes.data, m, k, data.ctypes.data, n,
                        out.ctypes.data, threads)
    want = np.empty((m, n), dtype=np.uint8)
    ref.rs_gf_apply(pm.ctypes.data, m, k, data.ctypes.data, n,
                    want.ctypes.data)
    assert np.array_equal(out, want)


def test_rs_apply_over_mt_threshold_matches_jax_native(libs):
    pm = parity_matrix(8, 4)
    big = np.ascontiguousarray(_rng(2).integers(
        0, 256, (8, native.RS_MT_THRESHOLD // 8 + 1)).astype(np.uint8))
    assert np.array_equal(native.rs_apply_native(pm, big),
                          ref_native.rs_apply_native(pm, big))


@pytest.mark.parametrize("key", [MAGIC_KEY, b"\0" * 32, bytes(range(32))])
def test_hh256_matches_jax_native(libs, key):
    rng = _rng(3)
    for n in (0, 1, 31, 32, 33, 100, 1000, 65537):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert native.hh256_native(data, key) == \
            ref_native.hh256_native(data, key), n


@pytest.mark.parametrize("chunk", [1, 31, 32, 512, 4096])
def test_hh256_chunks_matches_jax_native(libs, chunk):
    rng = _rng(chunk)
    for n in (0, chunk, 3 * chunk, 3 * chunk + 7, 10_000):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert native.hh256_chunks_native(data, chunk, MAGIC_KEY) == \
            ref_native.hh256_chunks_native(data, chunk, MAGIC_KEY)


def test_hh256_rows_matches_jax_native(libs):
    wide = _rng(5).integers(0, 256, (9, 700)).astype(np.uint8)
    for rows in (wide[:, :640], wide[:, 3:643], wide[:0, :64]):
        got = native.hh256_rows_native(rows, MAGIC_KEY)
        want = ref_native.hh256_rows_native(rows, MAGIC_KEY)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_host_apply_tagged_and_host_encode_match_jax(libs):
    """The host lanes of the dispatch plane: native first, numpy when
    the plan pins HOST; the batch folds into one apply."""
    mat = np.array([[1, 2], [3, 4]], dtype=np.uint8)
    cols = np.arange(2 * 32, dtype=np.uint8).reshape(2, 32)
    for lane in (None, kp.HOST):
        out, backend = batching.host_apply_tagged(mat, cols, lane)
        ref_out, ref_backend = ref_batching.host_apply_tagged(
            mat, cols, lane)
        assert np.array_equal(out, ref_out) and backend == ref_backend
    blocks = _rng(2).integers(0, 256, (5, 8, 700)).astype(np.uint8)
    assert np.array_equal(batching.host_encode(blocks, 8, 4),
                          ref_batching.host_encode(blocks, 8, 4))
    assert np.array_equal(batching.host_encode_shardmajor(blocks, 8, 4),
                          ref_batching.host_encode_shardmajor(blocks, 8, 4))


def test_disable_then_probe_readopts_like_jax(libs):
    """``_disable_native`` distrusts the library (callers fall back to
    numpy, the native lane degrades) until probe() re-adopts it -- in
    both packages alike."""
    mat = parity_matrix(4, 2)
    cols = _rng(9).integers(0, 256, (4, 300)).astype(np.uint8)
    trace = []
    for mod, prof, batch in ((native, kp.KERNPROF, batching),
                             (ref_native, ref_kp.KERNPROF, ref_batching)):
        mod._disable_native("test poison")
        out, backend = batch.host_apply_tagged(mat, cols)
        seq = [mod.get_lib() is None, backend, prof.state_of("native")]
        seq.append(mod.probe())
        out2, backend2 = batch.host_apply_tagged(mat, cols)
        seq += [mod.get_lib() is not None, backend2,
                np.array_equal(out, out2)]
        trace.append(seq)
    assert trace[0] == trace[1] == [True, "host", "degraded", True, True,
                                    "native", True]


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A cached library without the newest symbol (an old build whose
    mtime a copy preserved) is rebuilt, not used."""
    import subprocess
    stub = tmp_path / "stub.cc"
    stub.write_text('extern "C" int hh256_hash() { return 0; }\n')
    so = tmp_path / "libminio_tpu_torch_native.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(stub)],
                   check=True)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    lib = native.get_lib()
    assert hasattr(lib, "rs_gf_apply_mt")
    data = _rng(4).integers(0, 256, (4, 99)).astype(np.uint8)
    pm = parity_matrix(4, 2)
    assert np.array_equal(native.rs_apply_native(pm, data),
                          ref_native.rs_apply_native(pm, data))


@pytest.mark.parametrize("failure", ["no compiler", "compile error",
                                     "does not load"])
def test_failed_build_raises_and_is_no_lane_state(tmp_path, monkeypatch,
                                                  failure):
    """A build that fails, or a built library that does not load, raises
    BuildFailed at first use -- from the library, from a host dispatch
    and from the probe ladder -- and the native lane's health is
    untouched."""
    import subprocess

    def broken(*a, **kw):
        if failure == "no compiler":
            raise FileNotFoundError("g++")
        return subprocess.CompletedProcess(a[0], 1, "", "boom")

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    if failure == "does not load":
        # Newer than every source, so it is taken as built.
        (tmp_path / "libminio_tpu_torch_native.so").write_bytes(
            b"not a shared object")
    else:
        monkeypatch.setattr(native.subprocess, "run", broken)
    with pytest.raises(_cuda.BuildFailed):
        native.get_lib()
    with pytest.raises(_cuda.BuildFailed):
        batching.host_apply_tagged(parity_matrix(2, 1),
                                   np.zeros((2, 8), np.uint8))
    with pytest.raises(_cuda.BuildFailed):
        autotune.AUTOTUNE._probe_lane(kp.NATIVE, 1, 64)
    assert kp.KERNPROF.snapshot()["backends"]["native"]["failures"] == 0
    assert kp.KERNPROF.state_of(kp.NATIVE) == kp.UP


def test_native_probe_lane_matches_jax(libs):
    got = autotune.AUTOTUNE._probe_lane(kp.NATIVE, 2, 4096)
    from minio_tpu.ops.autotune import AUTOTUNE as REF
    want = REF._probe_lane(ref_kp.NATIVE, 2, 4096)
    assert (got[0] is not None, got[1]) == (want[0] is not None, want[1]) \
        == (True, "")


def test_cuda_library_that_does_not_load_is_a_build_failure(tmp_path,
                                                            monkeypatch):
    """A kernel library that exists but does not load raises BuildFailed,
    as a failed nvcc does: it is no lane a dispatch could fail over
    from."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_lib", None)
    (tmp_path / f"libminio_tpu_torch_{_cuda._source_hash()}.so"
     ).write_bytes(b"not a shared object")
    with pytest.raises(_cuda.BuildFailed, match="does not load"):
        _cuda.build()
    assert _cuda._lib is None
