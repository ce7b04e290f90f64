"""Single-problem solver facade (port of ``deppy_tpu/sat/solver.py:40-377``).

The analog of upstream deppy's ``sat.NewSolver``/``Solver.Solve``
(``pkg/sat/solve.go:32-34,121-163``).  ``Solver(variables).solve()``
returns the installed variables in input order, raises
:class:`NotSatisfiable` with a minimal core of applied constraints, or
:class:`Incomplete` when the step budget runs out.  Backends:

  * ``"device"`` (the default) — the batched tensor engine
    (:func:`deppy_tpu_torch.engine.driver.solve_one`) on ``device``:
    ``"cuda"`` by default, which raises without a card; ``"cpu"`` runs
    the kernels' plain versions;
  * ``"host"`` — the NumPy spec engine (:class:`HostEngine`), inline.

Any other name raises :class:`InternalSolverError`, the reference's
``"auto"`` and ``"tpu"`` included: ``auto`` picks the host engine for a
single problem, which would hide the card.

The assumption scopes (:meth:`Solver.assume`, :meth:`Solver.test`,
:meth:`Solver.untest`) run on the host engine on either backend, as in
the reference: a propagation-only Test is a host operation by design,
not a fallback.  A :meth:`Solver.solve` under an open scope answers for
the assumed problem (:func:`assumed_variables`), lowered by
:func:`encode_assumed` and solved on the configured backend.

Left out (later slices): the scheduler branch of ``solve_scoped``, the
host worker pool, ``SolveReport`` telemetry, deadlines, the ``auto``
probe and the breaker, and tracing on the device backend.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .constraints import Variable, mandatory, prohibited
from .encode import Problem, encode, encode_assumed
from .errors import Incomplete, InternalSolverError, NotSatisfiable
from .host import HostEngine
from .tracer import Tracer

BACKENDS = ("device", "host")


def check_backend(backend: str) -> str:
    """``backend`` if the port serves it, else :class:`InternalSolverError`."""
    if backend not in BACKENDS:
        raise InternalSolverError([f"unknown backend {backend!r}"])
    return backend


def assumed_variables(variables: Sequence[Variable],
                      assumptions: Sequence[tuple]) -> List[Variable]:
    """Derive the variable list a solve under ``assumptions`` answers
    for: each ``(identifier, installed)`` assumption appends a
    ``Mandatory`` (installed) or ``Prohibited`` (excluded) constraint to
    its subject variable — the wire-level form of gini's assumption
    literals.  The derived list is an ordinary problem: a one-shot cold
    solve of it is byte-for-byte the oracle for the scoped solve, and its
    unsat cores render the assumption as a real applied constraint
    (``"x is mandatory"``) instead of a synthetic literal."""
    extra: dict = {}
    for ident, installed in assumptions:
        extra.setdefault(ident, []).append(
            mandatory() if installed else prohibited())
    if not extra:
        return list(variables)
    out = []
    for v in variables:
        added = extra.get(v.identifier)
        if added:
            out.append(Variable(v.identifier,
                                tuple(v.constraints) + tuple(added)))
        else:
            out.append(v)
    return out


class Solver:
    """Preference-ordered, cardinality-minimized boolean-constraint solver.

    Construction validates input (raising ``DuplicateIdentifier`` like
    upstream lit_mapping.go:49-57) and the backend name.
    """

    def __init__(self, variables: Sequence[Variable],
                 tracer: Optional[Tracer] = None, backend: str = "device",
                 device="cuda", max_steps: Optional[int] = None):
        check_backend(backend)
        if tracer is not None and backend == "device":
            raise NotImplementedError(
                "search tracing on the device backend (a backtrack trace "
                "buffer, T > 0) is ROADMAP item A4; the fused search "
                "kernels keep no trace buffer, as in deppy_tpu's fused "
                "path.  backend='host' traces")
        self.problem: Problem = encode(variables)
        self.tracer = tracer
        self.backend = backend
        self.device = device
        self.max_steps = max_steps
        # Engine iterations and search backtracks of the last solve.
        self.steps: int = 0
        self.backtracks: int = 0
        self._inc_engine: Optional[HostEngine] = None

    # ------------------------------------------------------------ scopes
    #
    # The gini Assume/Test/Untest surface (upstream solve.go:79,99,104).
    # Scopes run on the host spec engine whatever the backend: a
    # propagation-only Test is host-cheap, and the tensor engine's
    # batched entry points have no notion of a pinned per-solver
    # assumption stack.

    def _scope_engine(self) -> HostEngine:
        if self._inc_engine is None:
            self._inc_engine = HostEngine(
                self.problem, tracer=self.tracer, max_steps=self.max_steps)
        return self._inc_engine

    def assume(self, *identifiers, installed: bool = True) -> None:
        """Assume each identifier's variable installed (or not, with
        ``installed=False``) for subsequent :meth:`test` scopes — the
        analog of gini ``Assume``."""
        lits = []
        for ident in identifiers:
            idx = self.problem.id_to_index.get(ident)
            if idx is None:
                raise InternalSolverError(
                    [f'variable "{ident}" referenced but not provided'])
            lits.append((idx + 1) if installed else -(idx + 1))
        self._scope_engine().assume(lits)

    def test(self) -> int:
        """Propagation-only check of the assumed scope — gini ``Test``.
        Returns 1 (sat by propagation), -1 (conflict), 0 (undetermined);
        pushes a scope that :meth:`untest` pops."""
        return self._scope_engine().test()

    def untest(self) -> int:
        """Pop the most recent :meth:`test` scope (gini ``Untest``);
        returns the remaining scope depth."""
        return self._scope_engine().untest()

    def assumptions(self) -> List[tuple]:
        """The open assumption stack as ``(identifier, installed)``
        pairs, in assumption order — empty when no scope is open."""
        eng = self._inc_engine
        if eng is None:
            return []
        vs = self.problem.variables
        return [(vs[abs(lit) - 1].identifier, lit > 0)
                for lit in eng._assumed_lits]

    def scope_depth(self) -> int:
        """Open :meth:`test` scopes (gini's scope depth)."""
        eng = self._inc_engine
        return len(eng._test_scopes) if eng is not None else 0

    def scope_state(self) -> tuple:
        """``(assumptions, scopes, scope_base)`` — the full scope-stack
        state: ``assumptions`` as :meth:`assumptions` renders them,
        ``scopes`` the engine's pushed scope bases, ``scope_base`` the
        current one.  Replayable through the public assume/test
        surface."""
        eng = self._inc_engine
        if eng is None:
            return [], [], 0
        return (self.assumptions(), list(eng._test_scopes),
                int(eng._scope_base))

    def solve_scoped(self, stats: Optional[dict] = None):
        """Solve under the OPEN assumption stack and return the raw
        result object (solution dict / ``NotSatisfiable`` /
        ``Incomplete``), un-decoded so a caller can render it with
        :func:`deppy_tpu_torch.io.result_to_dict`.

        The derived problem is lowered by :func:`encode_assumed` (the
        assumption splice, not a catalog re-walk) and solved on the
        configured backend: ``solve_one`` on ``device``, or an inline
        :class:`HostEngine`."""
        p = encode_assumed(self.problem, self.assumptions())
        if p.errors:
            raise InternalSolverError(p.errors)
        try:
            installed = self._solve_problem(p, tracer=None)
        except (NotSatisfiable, Incomplete) as e:
            return e
        finally:
            if stats is not None:
                stats["steps"] = self.steps
        solution = {v.identifier: False for v in p.variables}
        for v in installed:
            solution[v.identifier] = True
        return solution

    def solve(self) -> List[Variable]:
        if self.assumptions():
            # A solve under an open scope answers for the ASSUMED problem
            # (gini's Solve consumes assumptions), decoded back to the
            # installed-variables contract.
            r = self.solve_scoped()
            if isinstance(r, (NotSatisfiable, Incomplete)):
                raise r
            return [v for v in self.problem.variables
                    if r.get(v.identifier)]
        return self._solve_problem(self.problem, tracer=self.tracer)

    def _solve_problem(self, problem: Problem,
                       tracer: Optional[Tracer]) -> List[Variable]:
        if self.backend == "host":
            return self._solve_host(problem, tracer)
        from ..engine.driver import solve_one

        stats: dict = {}
        try:
            return solve_one(problem, max_steps=self.max_steps,
                             stats=stats, device=self.device)
        finally:
            self.steps = stats.get("steps", 0)
            self.backtracks = stats.get("backtracks", 0)

    def _solve_host(self, problem: Problem,
                    tracer: Optional[Tracer]) -> List[Variable]:
        """One inline host-engine solve (the reference's ``_solve_host``
        and ``_solve_host_traced``, without the worker pool and the
        report: the answer, its core objects and its counts are the
        same)."""
        engine = HostEngine(problem, tracer=tracer, max_steps=self.max_steps)
        try:
            installed, _ = engine.solve()
            return installed
        finally:
            self.steps = engine.steps
            self.backtracks = engine.backtracks
