"""minio_tpu_torch — the erasure data plane of minio_tpu on PyTorch and CUDA.

Same module layout as ``minio_tpu`` (``ops/``, ``erasure/``, ``models/``),
so each module's counterpart is found at the same relative path. The
package imports ``torch`` and never ``jax`` or ``minio_tpu``.

Entry points take an explicit ``device`` and run on the card (``"cuda"``)
unless the caller passes ``device="cpu"``, which selects each kernel's
plain PyTorch version. Without a card and without ``device="cpu"`` they
raise ``RuntimeError``; nothing falls back to the CPU silently.
"""

__version__ = "0.1.0"
