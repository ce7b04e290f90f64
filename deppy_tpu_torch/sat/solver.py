"""Single-problem solver facade (port of ``deppy_tpu/sat/solver.py:68-310``, ``Solver.solve``).

``Solver(variables).solve()`` returns the installed variables in input
order, raises :class:`NotSatisfiable` with a minimal core of applied
constraints, or :class:`Incomplete` when the step budget runs out.  The
solve runs on ``device`` ("cuda" by default; "cpu" runs the kernels'
plain versions).  Scopes (assume/test/untest), schedulers and the host
engine's own solve belong to later slices of the port (the driver uses
the host engine for giant unsat cores only).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .constraints import Variable
from .encode import Problem, encode


class Solver:
    """Preference-ordered, cardinality-minimized boolean-constraint solver."""

    def __init__(self, variables: Sequence[Variable], tracer=None,
                 device="cuda", max_steps: Optional[int] = None):
        if tracer is not None:
            raise NotImplementedError(
                "search tracing (a backtrack trace buffer, T > 0) lands in a "
                "later slice of the port; the fused search kernels keep no "
                "trace buffer, as in deppy_tpu's fused path")
        self.problem: Problem = encode(variables)
        self.device = device
        self.max_steps = max_steps
        # Engine iterations and search backtracks of the last solve.
        self.steps: int = 0
        self.backtracks: int = 0

    def solve(self) -> List[Variable]:
        from ..engine.driver import solve_one

        stats: dict = {}
        try:
            return solve_one(self.problem, max_steps=self.max_steps,
                             stats=stats, device=self.device)
        finally:
            self.steps = stats.get("steps", 0)
            self.backtracks = stats.get("backtracks", 0)
