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

``BatchResolver(scheduler=)`` routes each solve through a
:class:`deppy_tpu_torch.sched.Scheduler`: concurrent resolvers coalesce
into shared dispatches and repeats are served from its result cache;
``deadline_s`` then bounds each solve (expired lanes come back
Incomplete).

Left out (later slices): the mesh and checkpoint arguments, deadlines
without a scheduler (ROADMAP A7, the driver's recovery wrapper), and the
host worker pool.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from .. import hostpool, telemetry
from ..entity.entity import EntityID
from ..entity.source import EntityQuerier
from ..sat.constraints import Variable
from ..sat.encode import encode
from ..sat.errors import Incomplete, NotSatisfiable
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
                 max_steps: Optional[int] = None, scheduler=None,
                 deadline_s: Optional[float] = None):
        self.backend = check_backend(backend)
        self.device = device
        self.max_steps = max_steps
        # Cross-request continuous batching: with a Scheduler, solve()
        # routes through its shared queue and result cache instead of
        # dispatching privately.  The scheduler owns backend and device
        # routing then (it was built with its own).
        self.scheduler = scheduler
        if deadline_s is not None and scheduler is None:
            raise NotImplementedError(
                "BatchResolver(deadline_s=) without a scheduler needs the "
                "driver's recovery wrapper (ROADMAP A7); pass "
                "scheduler=Scheduler(...) to bound a solve")
        # Wall-clock budget for one solve call: problems not dispatched
        # before it expires come back Incomplete.
        self.deadline_s = deadline_s
        # Engine iterations consumed by the last solve, summed over the batch.
        self.last_steps: int = 0
        # The last solve's telemetry: outcomes, engine counters and, on
        # the device backend, the driver's padding data and stage walls.
        self.last_report: Optional[telemetry.SolveReport] = None

    def solve(self, problems: Sequence[Sequence[Variable]]
              ) -> List[Union[Solution, NotSatisfiable, Incomplete]]:
        self.last_steps = 0
        self.last_report = None
        if self.scheduler is not None:
            stats: dict = {}
            try:
                return self.scheduler.submit(
                    problems, deadline_s=self.deadline_s,
                    max_steps=self.max_steps, stats=stats)
            finally:
                self.last_steps = stats.get("steps", 0)
                self.last_report = stats.get("report")
        if self.backend == "host":
            return self._solve_host_batch(problems)
        from ..engine.driver import solve_batch

        stats = {}
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
        before any solve), then solved through the host path's lanes
        (:func:`deppy_tpu_torch.hostpool.solve_inline`), accounted and
        decoded with the scheduler's host drain's helpers: the
        reference's host batch (``resolution/facade.py:180-250``)
        without the worker pool and deadlines (ROADMAP A5.3), under a
        ``facade.host_solve`` span and a batch report.  A core carries
        the very objects of its problem's ``applied``."""
        batch_rep, owns_rep = telemetry.begin_report(
            backend="host", n_problems=len(problems))
        reg = telemetry.default_registry()
        try:
            with reg.span("facade.host_solve", problems=len(problems)):
                encoded = [encode(vs) for vs in problems]
                lanes = hostpool.solve_inline(encoded,
                                              max_steps=self.max_steps)
                out = []
                for p, lane in zip(encoded, lanes):
                    hostpool.count_lane(batch_rep, lane)
                    batch_rep.add_wall("solve", lane.wall_s)
                    self.last_steps += lane.steps
                    out.append(hostpool.lane_answer(p, lane))
        finally:
            telemetry.end_report(batch_rep, owns_rep)
        self.last_report = batch_rep
        return out
