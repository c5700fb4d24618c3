"""Compiled-HLO inspection helpers: collective-communication accounting.

Used by tests/test_sharding_hlo.py (asserting the sharded build never
replicates its (n, S) operand and that its collective bytes stay O(S)).
"""

from __future__ import annotations

import re

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "collective-permute", "all-to-all")
_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:\S+))\s+(" + "|".join(COLLECTIVE_OPS) + r")\(")


def shape_bytes(shape_str: str) -> int:
    """Total bytes of one HLO shape string or tuple-of-shapes string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        elems = 1
        for d in dims.split(","):
            if d:
                elems *= int(d)
        total += elems * _DTYPE_BYTES[dt]
    return total


def collective_stats(hlo_text: str) -> list[tuple[str, int, str]]:
    """[(op, result_bytes, line)] for every collective in the module text."""
    out = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if m:
            out.append((m.group(2), shape_bytes(m.group(1)), line.strip()))
    return out
