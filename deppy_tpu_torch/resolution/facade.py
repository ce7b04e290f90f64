"""Resolution facade: entities + generators → Solution (port of ``deppy_tpu/resolution/facade.py:32-251``).

Upstream deppy's ``pkg/solver/solver.go``.  :class:`Resolver` runs the
pipeline for one problem: aggregate variables from constraint generators,
solve, and report a ``Solution`` mapping every variable's entity id to
selected/not-selected (solver.go:36-64 initializes all to False and flips
the installed ones to True).

:class:`BatchResolver` resolves N independent problems (e.g. 10k cluster
states over a shared catalog): encoded once and resolved together on
``device`` ("cuda" by default) by the ``"device"`` backend, or lane by
lane on the host engine by the ``"host"`` backend; ``"auto"`` picks one
(:func:`deppy_tpu_torch.sat.solver.resolve_backend`).  Each comes
back as a ``Solution``, the :class:`NotSatisfiable` error carrying its
minimal core, or an :class:`Incomplete` marker when it ran out of steps.
``BatchResolver.last_report`` is the last batch's
:class:`telemetry.SolveReport` on either backend.  ``Resolver(tracer=)``
traces on either backend (see :class:`Solver`).

``deadline_s`` bounds each solve: problems not dispatched (or, on the
host backend, not started) before it expires come back Incomplete, and
so do they under ``DEPPY_GPU_BATCH_DEADLINE_S``.
``BatchResolver(scheduler=)`` routes each solve through a
:class:`deppy_tpu_torch.sched.Scheduler`: concurrent resolvers coalesce
into shared dispatches and repeats are served from its result cache.
``checkpoint_dir`` solves a device batch group by group with resume
(:mod:`deppy_tpu_torch.engine.checkpoint`).

The host backend's batch runs through the host worker pool when one is
available (:func:`deppy_tpu_torch.hostpool.solve_host_problems`).

Left out: the mesh argument (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import sys

from .. import faults, hostpool, telemetry
from ..entity.entity import EntityID
from ..entity.source import EntityQuerier
from ..sat.constraints import Variable
from ..sat.encode import encode
from ..sat.errors import Incomplete, NotSatisfiable
from ..sat.solver import Solver, check_backend, resolve_backend
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
                 deadline_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None):
        self.backend = check_backend(backend)
        self.device = device
        self.max_steps = max_steps
        # Cross-request continuous batching: with a Scheduler, solve()
        # routes through its shared queue and result cache instead of
        # dispatching privately.  The scheduler owns backend and device
        # routing then (it was built with its own); checkpoint_dir is a
        # private-dispatch feature and is not read on that path.
        self.scheduler = scheduler
        # Wall-clock budget for one solve call: problems not dispatched
        # before it expires come back Incomplete instead of the batch
        # aborting.
        self.deadline_s = deadline_s
        # Group-wise resume for fleet-scale batches: the completed groups
        # of a crashed run are loaded instead of re-solved (device
        # backend only; see deppy_tpu_torch.engine.checkpoint).
        self.checkpoint_dir = checkpoint_dir
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
        # The ambient deadline here rather than only in the driver, so
        # DEPPY_GPU_BATCH_DEADLINE_S also bounds the host backend's batch
        # (``auto`` degraded to host by the breaker included).
        with faults.deadline_scope(self.deadline_s), \
                faults.ambient_deadline():
            return self._solve_inner(problems)

    def _solve_inner(self, problems: Sequence[Sequence[Variable]]
                     ) -> List[Union[Solution, NotSatisfiable, Incomplete]]:
        if resolve_backend(self.backend, device=self.device) == "host":
            if self.checkpoint_dir is not None:
                print("warning: checkpoint_dir is a device-backend feature; "
                      "the host engine solves without persisting groups — "
                      "a crashed run will restart from scratch",
                      file=sys.stderr)
            return self._solve_host_batch(problems)
        from ..engine.driver import solve_batch

        stats: dict = {}
        try:
            return solve_batch(problems, max_steps=self.max_steps,
                               stats=stats, device=self.device,
                               checkpoint_dir=self.checkpoint_dir)
        finally:
            self.last_steps = stats.get("steps", 0)
            self.last_report = stats.get("report")

    def _solve_host_batch(
        self, problems: Sequence[Sequence[Variable]]
    ) -> List[Union[Solution, NotSatisfiable, Incomplete]]:
        """The host backend's batch (``resolution/facade.py:180-250``),
        under a ``facade.host_solve`` span and a batch report: problems
        are encoded in order (a ``DuplicateIdentifier`` raises before any
        solve) until the batch deadline expires, then solved through the
        host path's entry (:func:`deppy_tpu_torch.hostpool.solve_host_problems`:
        the worker pool, or inline) each under that deadline, and
        accounted and decoded with the scheduler's host drain's helpers.
        Problems not started before the deadline come back Incomplete,
        counted as ONE deadline event for the whole degraded remainder.
        A core carries the very objects of its problem's ``applied``."""
        batch_rep, owns_rep = telemetry.begin_report(
            backend="host", n_problems=len(problems))
        reg = telemetry.default_registry()
        try:
            with reg.span("facade.host_solve", problems=len(problems)):
                dl = faults.current_deadline()
                encoded = []
                for vs in problems:
                    if dl is not None and dl.expired():
                        break
                    encoded.append(encode(vs))
                lanes = hostpool.solve_host_problems(
                    encoded, max_steps=self.max_steps,
                    deadlines=[dl] * len(encoded)) if encoded else []
                lanes += [hostpool.HostLaneResult("incomplete",
                                                  degraded=True)
                          for _ in range(len(problems) - len(encoded))]
                n_degraded = sum(1 for r in lanes if r.degraded)
                if n_degraded:
                    faults.note_deadline_exceeded("facade.host_solve",
                                                  n_degraded)
                out = []
                for i, lane in enumerate(lanes):
                    hostpool.count_lane(batch_rep, lane)
                    batch_rep.add_wall("solve", lane.wall_s)
                    self.last_steps += lane.steps
                    out.append(Incomplete() if i >= len(encoded)
                               else hostpool.lane_answer(encoded[i], lane))
        finally:
            telemetry.end_report(batch_rep, owns_rep)
        self.last_report = batch_rep
        return out
