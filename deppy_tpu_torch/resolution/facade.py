"""Resolution facade: entities + generators → Solution (port of ``deppy_tpu/resolution/facade.py:32-251``).

Upstream deppy's ``pkg/solver/solver.go``.  :class:`Resolver` runs the
pipeline for one problem: aggregate variables from constraint generators,
solve, and report a ``Solution`` mapping every variable's entity id to
selected/not-selected (solver.go:36-64 initializes all to False and flips
the installed ones to True).

:class:`BatchResolver` resolves N independent problems (e.g. 10k cluster
states over a shared catalog): encoded once and resolved together on
``device`` ("cuda" by default) by the ``"device"`` backend, or lane by
lane on the inline host engine by the ``"host"`` backend.  Each comes
back as a ``Solution``, the :class:`NotSatisfiable` error carrying its
minimal core, or an :class:`Incomplete` marker when it ran out of steps.
``BatchResolver.last_report`` is the last batch's
:class:`telemetry.SolveReport` on either backend.  ``Resolver(tracer=)``
traces on either backend (see :class:`Solver`).

Left out (later slices): the scheduler, mesh, checkpoint and deadline
arguments, and the host worker pool.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

from .. import telemetry
from ..entity.entity import EntityID
from ..entity.source import EntityQuerier
from ..sat.constraints import Variable
from ..sat.encode import encode
from ..sat.errors import Incomplete, NotSatisfiable
from ..sat.host import HostEngine
from ..sat.solver import Solver, check_backend
from ..sat.tracer import Tracer
from .generator import ConstraintAggregator, GeneratorLike

# Solution maps every input entity id to whether it was selected
# (upstream solver.go:12-16).
Solution = Dict[EntityID, bool]


def _to_solution(variables: Sequence[Variable],
                 installed: Sequence[Variable]) -> Solution:
    """Every input variable appears, installed ones True
    (upstream solver.go:52-62)."""
    solution: Solution = {v.identifier: False for v in variables}
    for v in installed:
        solution[v.identifier] = True
    return solution


class Resolver:
    """Single-problem resolution facade (upstream DeppySolver,
    solver.go:24-64)."""

    def __init__(
        self,
        source: EntityQuerier,
        *generators: GeneratorLike,
        backend: str = "device",
        device="cuda",
        tracer: Optional[Tracer] = None,
        max_steps: Optional[int] = None,
        parallel_generators: bool = False,
    ):
        self.source = source
        self.aggregator = ConstraintAggregator(
            *generators, parallel=parallel_generators
        )
        self.backend = check_backend(backend)
        self.device = device
        self.tracer = tracer
        self.max_steps = max_steps

    def solve(self) -> Solution:
        """Aggregate variables, solve, and build the Solution map.  Raises
        :class:`NotSatisfiable` (with its minimal constraint core) when
        resolution is impossible."""
        variables = self.aggregator.get_variables(self.source)
        installed = Solver(
            variables,
            tracer=self.tracer,
            backend=self.backend,
            device=self.device,
            max_steps=self.max_steps,
        ).solve()
        return _to_solution(variables, installed)


class BatchResolver:
    """Resolve many independent problems in one batched solve."""

    def __init__(self, backend: str = "device", device="cuda",
                 max_steps: Optional[int] = None):
        self.backend = check_backend(backend)
        self.device = device
        self.max_steps = max_steps
        # Engine iterations consumed by the last solve, summed over the batch.
        self.last_steps: int = 0
        # The last solve's telemetry: outcomes, engine counters and, on
        # the device backend, the driver's padding data and stage walls.
        self.last_report: Optional[telemetry.SolveReport] = None

    def solve(self, problems: Sequence[Sequence[Variable]]
              ) -> List[Union[Solution, NotSatisfiable, Incomplete]]:
        self.last_steps = 0
        self.last_report = None
        if self.backend == "host":
            return self._solve_host_batch(problems)
        from ..engine.driver import solve_batch

        stats: dict = {}
        try:
            return solve_batch(problems, max_steps=self.max_steps,
                               stats=stats, device=self.device)
        finally:
            self.last_steps = stats.get("steps", 0)
            self.last_report = stats.get("report")

    def _solve_host_batch(
        self, problems: Sequence[Sequence[Variable]]
    ) -> List[Union[Solution, NotSatisfiable, Incomplete]]:
        """Every problem encoded first (a ``DuplicateIdentifier`` raises
        before any solve), then solved lane by lane on an inline
        :class:`HostEngine`: the reference's host batch run inline
        (``resolution/facade.py:193-250``, without the worker pool and
        deadlines), under a ``facade.host_solve`` span and a batch
        report.  A core carries the very objects of its problem's
        ``applied``."""
        batch_rep, owns_rep = telemetry.begin_report(
            backend="host", n_problems=len(problems))
        reg = telemetry.default_registry()
        out: List[Union[Solution, NotSatisfiable, Incomplete]] = []
        try:
            with reg.span("facade.host_solve", problems=len(problems)):
                encoded = [encode(vs) for vs in problems]
                for variables, p in zip(problems, encoded):
                    engine = HostEngine(p, max_steps=self.max_steps)
                    t0 = time.perf_counter()
                    try:
                        installed, _ = engine.solve()
                        out.append(_to_solution(variables, installed))
                        batch_rep.count_outcome("sat")
                    except NotSatisfiable as e:
                        out.append(e)
                        batch_rep.count_outcome("unsat")
                    except Incomplete as e:
                        out.append(e)
                        batch_rep.count_outcome("incomplete")
                    finally:
                        batch_rep.steps += engine.steps
                        batch_rep.decisions += engine.decisions
                        batch_rep.propagation_rounds += \
                            engine.propagation_rounds
                        batch_rep.backtracks += engine.backtracks
                        batch_rep.add_wall("solve", time.perf_counter() - t0)
                        self.last_steps += engine.steps
        finally:
            telemetry.end_report(batch_rep, owns_rep)
        self.last_report = batch_rep
        return out
