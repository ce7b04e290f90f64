"""Deep implication chains (copy of ``deppy_tpu/benchmarks/hard.py:43-63``).

The hard-instance family the reference's portfolio race is measured on:
each instance solves by pure propagation but pays a depth-long
implication walk, and its minimal model is the whole chain
(minimization cannot drop a link).  Several depths in one batch give
the lanes distinct trip counts, so one straggler depth pins a lockstep
batch while the gradient-relaxation entrant certifies every lane with
one fixpoint.
"""

from __future__ import annotations

from typing import List

DEPTHS = (192, 384, 768)


def chain_requests(depths=DEPTHS, lanes_per_depth: int = 8
                   ) -> List[list]:
    """``lanes_per_depth`` copies of a chain of each depth: ``a0``
    mandatory, each ``a_i`` depends on ``a_{i+1}``."""
    from .. import sat

    out = []
    for depth in depths:
        vs = [sat.variable("a0", sat.mandatory(), sat.dependency("a1"))]
        vs += [sat.variable(f"a{i}", sat.dependency(f"a{i + 1}"))
               for i in range(1, depth - 1)]
        vs += [sat.variable(f"a{depth - 1}")]
        out += [vs] * lanes_per_depth
    return out
