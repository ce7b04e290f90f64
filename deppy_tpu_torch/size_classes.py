"""Shared size-class ladder (copy of ``deppy_tpu/size_classes.py:1-115``).

The padded shape ladder the driver partitions a heterogeneous batch by:
each class declares the padded dims a problem assigned to it can pay at
most (``C`` clause rows, ``NV`` problem vars, ``NCON`` applied
constraints; ``V = NV + NCON`` variables, ``Wv = ceil(V/32)`` bitplane
words).  ``OCC`` is carried for parity with the reference table; the
watched clause bank that reads it is not part of this package yet.
Classes are ordered by :func:`class_cost`; adjacent classes differ by at
least :data:`SPLIT_RATIO` in padded cost.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

WORD = 32

# Only split a batch at a size-class boundary when the padded per-lane
# cost ratio across it is at least this factor (a smaller jump pays more
# in extra dispatches than it saves in padding).
SPLIT_RATIO = 2.0

# Declared size classes: padded dims per the driver's power-of-two
# bucketing (:func:`bucket`).  The xs floor matches the 64-clause
# catalog minimum; the xl caps (C <= 8192 rows, Wv <= 128 words =
# 4096 vars) are the reference ladder's.  ``OCC`` tunes
# the watched-literal bank width per class: small classes keep narrow
# adjacency (a 64-clause problem's literals occur in few clauses), the
# big classes pay wider banks because that is exactly where the dense
# scan-every-clause program wastes the most.
SIZE_CLASSES: Dict[str, Dict[str, int]] = {
    "xs": {"C": 64, "NV": 128, "NCON": 64, "OCC": 32},
    "s": {"C": 256, "NV": 256, "NCON": 128, "OCC": 32},
    "m": {"C": 1024, "NV": 1024, "NCON": 512, "OCC": 64},
    "l": {"C": 4096, "NV": 2048, "NCON": 1024, "OCC": 128},
    "xl": {"C": 8192, "NV": 3072, "NCON": 1024, "OCC": 128},
}


def bucket(n: int, minimum: int = 1) -> int:
    """Round up to the next power of two (>= minimum) — the driver's
    padding quantum, shared so class arithmetic and live padding can
    never disagree."""
    n = max(n, minimum)
    out = 1
    while out < n:
        out <<= 1
    return out


def wv(cls: Dict[str, int]) -> int:
    """Bitplane words of a class's variable set."""
    return -(-(cls["NV"] + cls["NCON"]) // WORD)


def cost_proxy(n_clauses: int, n_vars: int, n_cons: int) -> int:
    """Padded per-lane cost proxy: clause-plane area dominates BCP; the
    var count drives DPLL snapshot size and iteration count.  Inputs
    are LIVE sizes; the proxy buckets them exactly like the driver
    pads."""
    NV = bucket(max(n_vars, 1))
    NCON = bucket(max(n_cons, 1))
    Wv = -(-(NV + NCON) // WORD)
    C = bucket(max(n_clauses, 1))
    return (C + 2 * NV) * Wv


def class_cost(cls: Dict[str, int]) -> int:
    """:func:`cost_proxy` over a declared class's padded dims."""
    return (cls["C"] + 2 * cls["NV"]) * wv(cls)


def ordered_classes() -> List[Tuple[str, Dict[str, int]]]:
    """Classes sorted by padded cost (the ladder order)."""
    return sorted(SIZE_CLASSES.items(), key=lambda kv: class_cost(kv[1]))


# Precomputed ladder bounds: (upper cost, name), ascending.
_LADDER: List[Tuple[int, str]] = [
    (class_cost(cls), name) for name, cls in ordered_classes()
]


def class_of_cost(cost: int) -> str:
    """The smallest declared class whose padded cost covers ``cost``
    (problems past the xl cap stay in xl — the driver's per-bucket dims
    still shrink-to-fit, the ladder only draws partition boundaries)."""
    for bound, name in _LADDER:
        if cost <= bound:
            return name
    return _LADDER[-1][1]
