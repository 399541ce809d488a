"""Ellipses pattern expansion for disk/host topology arguments
(ref pkg/ellipses: `minio server /data/disk{1...64}` or
`http://host{1...16}/disk{1...4}`).

The port's own copy of ``minio_tpu/utils/ellipses.py``, with no change in
behaviour.
"""

from __future__ import annotations

import itertools
import re

_PATTERN = re.compile(r"\{(\d+)\.\.\.(\d+)\}")


def has_ellipses(*args: str) -> bool:
    return any(_PATTERN.search(a) for a in args)


def expand(arg: str) -> list[str]:
    """Expand every {a...b} range in arg (cartesian product, left-major)."""
    spans = list(_PATTERN.finditer(arg))
    if not spans:
        return [arg]
    ranges = []
    for m in spans:
        lo, hi = int(m.group(1)), int(m.group(2))
        if hi < lo:
            raise ValueError(f"invalid ellipses range: {m.group(0)}")
        width = len(m.group(1)) if m.group(1).startswith("0") else 0
        ranges.append([str(v).zfill(width) for v in range(lo, hi + 1)])
    out = []
    for combo in itertools.product(*ranges):
        s, last = [], 0
        for m, val in zip(spans, combo):
            s.append(arg[last:m.start()])
            s.append(val)
            last = m.end()
        s.append(arg[last:])
        out.append("".join(s))
    return out


def expand_all(args: list[str]) -> list[str]:
    out: list[str] = []
    for a in args:
        out.extend(expand(a))
    return out
