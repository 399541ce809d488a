"""Regenerating-code storage class (REGEN): minimum-bandwidth repair.

Port of minio_tpu/erasure/regen/. The codec (`RegenErasure`) mirrors the
`Erasure` seams the engine consumes (shard sizes, batched encode, batched
whole-block decode, re-encode of lost nodes) over the repair-by-transfer
product-matrix MBR construction in ops/rs_regen.py, whose
``repair_rows`` plans the rebuild of a lost node from one stored stripe
symbol per helper. The heal-side collector that runs that plan over an
erasure set's disks (the reference's ``repair.py``) comes with the
erasure engine.
"""

from .codec import RegenErasure  # noqa: F401
