"""Batch resolution facade (port of ``deppy_tpu/resolution/facade.py:76-200``, ``BatchResolver.solve``).

N independent problems (e.g. 10k cluster states over a shared catalog)
are encoded once and resolved together on ``device`` ("cuda" by default).
Each comes back as a ``Solution`` (every identifier → selected?), the
:class:`NotSatisfiable` error carrying its minimal core, or an
:class:`Incomplete` marker when it ran out of steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from ..sat.constraints import Identifier, Variable
from ..sat.errors import Incomplete, NotSatisfiable

Solution = Dict[Identifier, bool]


class BatchResolver:
    """Resolve many independent problems in one batched device solve."""

    def __init__(self, device="cuda", max_steps: Optional[int] = None):
        self.device = device
        self.max_steps = max_steps
        # Engine iterations consumed by the last solve, summed over the batch.
        self.last_steps: int = 0

    def solve(self, problems: Sequence[Sequence[Variable]]
              ) -> List[Union[Solution, NotSatisfiable, Incomplete]]:
        from ..engine.driver import solve_batch

        stats: dict = {}
        try:
            return solve_batch(problems, max_steps=self.max_steps,
                               stats=stats, device=self.device)
        finally:
            self.last_steps = stats.get("steps", 0)
