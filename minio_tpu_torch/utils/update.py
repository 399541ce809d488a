"""Self-update (ref cmd/update.go:520 — the reference checks its
release endpoint, compares versions, downloads the new binary, verifies
its checksum and execs it in place).

Python rebuild: the release endpoint serves
    GET /minio-tpu/release.json ->
        {"version": "x.y.z", "url": "...tar.gz", "sha256": "..."}
`update` downloads the tarball, verifies the digest BEFORE touching
anything, then atomically swaps the package directory (old tree kept as
.bak for rollback). A restart picks up the new code — the supervisor
pattern the reference's exec-replace maps to for a Python process.

The port's own copy of ``minio_tpu/utils/update.py``, with no change in
behaviour but the tree it swaps: the archive's ``minio_tpu_torch/`` for
the installed ``minio_tpu_torch/``. It never reads or replaces a
``minio_tpu/`` tree, in the archive or beside the installed package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tarfile
import tempfile
import urllib.parse
import urllib.request

from .. import __version__

# The package directory an update archive carries and replaces.
PACKAGE = "minio_tpu_torch"


class UpdateError(Exception):
    pass


def _fetch(url: str, timeout: float = 15.0) -> bytes:
    if not url.startswith(("http://", "https://")):
        raise UpdateError(f"unsupported update URL: {url}")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()
    except OSError as e:
        raise UpdateError(f"fetch {url}: {e}")


def _version_tuple(v: str) -> tuple:
    out = []
    for part in v.strip().lstrip("v").split("."):
        try:
            out.append(int(part))
        except ValueError:
            out.append(0)
    return tuple(out)


def check_update(endpoint: str) -> dict:
    """{'current', 'latest', 'newer', 'url', 'sha256'} from the release
    endpoint (ref getUpdateInfo, cmd/update.go)."""
    base = endpoint.rstrip("/")
    doc = json.loads(_fetch(f"{base}/minio-tpu/release.json"))
    latest = doc.get("version", "")
    url = doc.get("url", "")
    if url and not urllib.parse.urlsplit(url).netloc:
        url = base + "/" + url.lstrip("/")
    return {"current": __version__, "latest": latest,
            "newer": _version_tuple(latest) > _version_tuple(__version__),
            "url": url, "sha256": doc.get("sha256", "")}


def download_verified(url: str, sha256: str) -> str:
    """Download to a temp file; raises on digest mismatch BEFORE the
    caller touches anything (ref update.go sha256 verification)."""
    blob = _fetch(url)
    digest = hashlib.sha256(blob).hexdigest()
    if digest != sha256.lower():
        raise UpdateError(
            f"checksum mismatch: expected {sha256}, got {digest}")
    fd, path = tempfile.mkstemp(suffix=".tar.gz",
                                prefix="minio-tpu-update-")
    with os.fdopen(fd, "wb") as f:
        f.write(blob)
    return path


def apply_update(archive_path: str, package_dir: str | None = None,
                 ) -> str:
    """Swap the installed package tree with the archive's
    `minio_tpu_torch/` directory. The old tree survives as <dir>.bak
    until the next successful update (rollback path). Returns the
    installed dir."""
    if package_dir is None:
        package_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    parent = os.path.dirname(package_dir)
    stage = tempfile.mkdtemp(prefix="minio-tpu-stage-", dir=parent)
    try:
        with tarfile.open(archive_path, "r:gz") as tf:
            # filter='data' (3.12+) rejects absolute paths, traversal
            # AND symlink-escape members — a manual realpath check is
            # bypassable via a symlink member extracted first.
            try:
                tf.extractall(stage, filter="data")
            except tarfile.TarError as e:
                raise UpdateError(f"unsafe archive: {e}")
        new_pkg = os.path.join(stage, PACKAGE)
        if not os.path.isdir(new_pkg):
            raise UpdateError(f"archive does not contain {PACKAGE}/")
        if not os.path.exists(os.path.join(new_pkg, "__init__.py")):
            raise UpdateError(f"archive {PACKAGE}/ missing __init__.py")
        bak = package_dir + ".bak"
        if os.path.exists(bak):
            shutil.rmtree(bak)
        os.replace(package_dir, bak)
        try:
            os.replace(new_pkg, package_dir)
        except OSError:
            os.replace(bak, package_dir)   # rollback
            raise
        return package_dir
    finally:
        shutil.rmtree(stage, ignore_errors=True)


def run_update(endpoint: str, dry_run: bool = False,
               package_dir: str | None = None) -> dict:
    """The `minio-tpu update` flow: check -> download+verify -> swap.
    Returns the check_update dict plus 'applied'."""
    info = check_update(endpoint)
    info["applied"] = False
    if not info["newer"]:
        return info
    if dry_run:
        return info
    if not info["url"] or not info["sha256"]:
        raise UpdateError("release endpoint lacks url/sha256")
    archive = download_verified(info["url"], info["sha256"])
    try:
        apply_update(archive, package_dir)
        info["applied"] = True
    finally:
        os.unlink(archive)
    return info
