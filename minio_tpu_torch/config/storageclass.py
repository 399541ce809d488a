"""Storage-class config: per-request data/parity split via
`x-amz-storage-class` (ref cmd/config/storageclass/storage-class.go:
STANDARD/RRS classes, `EC:m` value syntax, GetParityForSC:33-96).

Env (same shape as the reference's MINIO_STORAGE_CLASS_*):
    MINIO_STORAGE_CLASS_STANDARD="EC:4"   parity for STANDARD puts
    MINIO_STORAGE_CLASS_RRS="EC:2"        parity for REDUCED_REDUNDANCY

The port's own copy of ``minio_tpu/config/storageclass.py``, with no
change in behaviour.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

STANDARD = "STANDARD"
RRS = "REDUCED_REDUNDANCY"
# Regenerating-code class (this repo's extension): same k+m durability
# as STANDARD but objects are coded with the repair-by-transfer
# product-matrix MBR code (ops/rs_regen.py) — single-shard repair moves
# a fraction of the traffic, at a higher raw-storage overhead.
REGEN = "REGEN"

# Stored in object metadata when the class is non-default (ref
# xhttp.AmzStorageClass handling in putObject).
META_STORAGE_CLASS = "x-amz-storage-class"

DEFAULT_RRS_PARITY = 2  # ref defaultRRSParity


class InvalidStorageClass(Exception):
    pass


def _parse_ec(v: str) -> int | None:
    """Parse 'EC:m' (ref parseStorageClass)."""
    if not v:
        return None
    if not v.startswith("EC:"):
        raise InvalidStorageClass(f"malformed storage class value {v!r}")
    try:
        return int(v[3:])
    except ValueError:
        raise InvalidStorageClass(f"malformed storage class value {v!r}")


def _parse_buckets(v: str) -> frozenset[str]:
    """Parse the comma-separated regen_buckets list (whitespace
    tolerated, empty entries dropped)."""
    return frozenset(b.strip() for b in (v or "").split(",")
                     if b.strip())


@dataclass
class StorageClassConfig:
    """Parity-per-class table for one erasure set size."""
    standard_parity: int | None = None  # None = set default (n/2)
    rrs_parity: int | None = None
    # Buckets whose PUTs default to the REGEN class without a header
    # (config-KV `storage_class regen_buckets=a,b`, live-reloadable).
    regen_buckets: frozenset[str] = frozenset()

    @classmethod
    def from_env(cls, env=os.environ) -> "StorageClassConfig":
        return cls(
            standard_parity=_parse_ec(
                env.get("MINIO_STORAGE_CLASS_STANDARD", "")),
            rrs_parity=_parse_ec(env.get("MINIO_STORAGE_CLASS_RRS", "")),
            regen_buckets=_parse_buckets(
                env.get("MINIO_STORAGE_CLASS_REGEN_BUCKETS", "")),
        )

    def parity_for(self, storage_class: str, n_disks: int,
                   set_default: int) -> int:
        """Parity for a PUT's storage class (ref GetParityForSC).
        Raises InvalidStorageClass for unknown classes or a parity that
        the set geometry cannot hold (need 0 < m <= n/2)."""
        sc = storage_class or STANDARD
        if sc in (STANDARD, REGEN):
            # REGEN keeps STANDARD's parity: equal k+m durability, the
            # repair math is what differs (erasure/regen/).
            m = (set_default if self.standard_parity is None
                 else self.standard_parity)
        elif sc == RRS:
            m = (min(DEFAULT_RRS_PARITY, set_default)
                 if self.rrs_parity is None else self.rrs_parity)
        else:
            raise InvalidStorageClass(f"unknown storage class {sc!r}")
        if not (0 < m <= n_disks // 2):
            raise InvalidStorageClass(
                f"parity {m} invalid for {n_disks}-disk set")
        return m

    def use_regen(self, storage_class: str, bucket: str) -> bool:
        """Should this PUT store under the REGEN class? Per-request
        header wins; otherwise the bucket's config-KV default applies
        (an explicit STANDARD/RRS header opts a single PUT back out)."""
        if storage_class:
            return storage_class == REGEN
        return bucket in self.regen_buckets
