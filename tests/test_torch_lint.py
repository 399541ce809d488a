"""mtpu-lint over the port.

``tests/test_lint.py`` gates ``minio_tpu/`` and ``tools/`` with every rule
of ``tools/mtpu_lint``. Here the same rules, the same suppression syntax
and the same (empty) baseline run over ``minio_tpu_torch/``, each module
seen at the reference's relative path (``minio_tpu_torch/s3/server.py``
as ``minio_tpu/s3/server.py``, ``minio_tpu_torch/tools/loadgen.py`` as
``tools/loadgen.py``), so the path-scoped rules (async blocking
in ``s3/`` and ``rpc/``, commits in ``storage/``, dispatch policy in
``ops/`` and ``erasure/codec.py``, blocking under locks in the hot paths,
the metric-call rules of ``obs/``, ...) hold the port as they hold the
reference. Neither the linter nor its gate is edited.

Rules whose subject is JAX, and what they meet in the port:

- R4 (kernel purity: no host callbacks or side effects inside
  ``jax.jit`` / Pallas regions) finds no jit or Pallas region in a package
  without JAX; it runs all the same and must stay clean. The port's
  kernels are CUDA C++ (``minio_tpu_torch/csrc/``), outside any Python
  rule.
- Every other rule is about Python concurrency, error mapping, resources
  and metric names, and applies unchanged.
"""

from __future__ import annotations

import pytest

from tools.mtpu_lint import core
from tools.mtpu_lint.rules import all_rules

PORT, REF = "minio_tpu_torch/", "minio_tpu/"


class _PortCtx(core.ModuleCtx):
    """A port module at the reference's relative path; the port's
    ``tools/`` at the JAX system's ``tools/``."""

    def __init__(self, path: str, source: str):
        super().__init__(path, source)
        if self.relpath.startswith(PORT + "tools/"):
            self.relpath = self.relpath[len(PORT):]
        elif self.relpath.startswith(PORT):
            self.relpath = REF + self.relpath[len(PORT):]


@pytest.fixture(scope="module")
def port_lint():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(core, "ModuleCtx", _PortCtx)
        yield core.run(["minio_tpu_torch"])


def test_mtpu_lint_is_clean_over_the_port(port_lint):
    assert port_lint.errors == []
    assert port_lint.files > 100
    assert port_lint.findings == [], "\n".join(
        f.render().replace(REF, PORT, 1) for f in port_lint.findings)


def test_every_rule_ran_over_the_port(port_lint):
    ids = {r.id for r in all_rules()}
    assert ids <= set(port_lint.stats)


@pytest.mark.parametrize("relpath,rule", [
    ("minio_tpu/s3/server.py", "R8"),
    ("minio_tpu/storage/xl.py", "R7"),
    ("minio_tpu/ops/batching.py", "R9"),
    ("minio_tpu/erasure/engine.py", "R3"),
    ("minio_tpu/obs/kernprof.py", "O6"),
])
def test_path_scoped_rules_apply_to_the_port(relpath, rule):
    """A port module seen at its reference path is in each rule's scope."""
    ctx = _PortCtx(str(core.REPO) + "/" + PORT + relpath[len(REF):], "")
    assert ctx.relpath == relpath
    (r,) = [r for r in all_rules() if r.id == rule]
    assert r.applies(ctx)


def test_port_tools_are_linted_as_the_reference_tools():
    """The port's load generator is seen at ``tools/loadgen.py``, where R1
    (thread hops carry the request context) does not apply, as for the
    reference's."""
    ctx = _PortCtx(str(core.REPO) + "/" + PORT + "tools/loadgen.py", "")
    assert ctx.relpath == "tools/loadgen.py"
    (r1,) = [r for r in all_rules() if r.id == "R1"]
    assert not r1.applies(ctx)
