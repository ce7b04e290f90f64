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
  * ``"host"`` — the NumPy spec engine (:class:`HostEngine`): an
    untraced solve through the host path's entry
    (:func:`deppy_tpu_torch.hostpool.solve_host_problems`, which runs a
    lone problem inline), a traced one on an inline engine.

A ``tracer`` receives one ``trace`` call per search backtrack on either
backend: the host engine calls it as it searches, the device backend
replays the search kernel's trace buffer (``trace_cap`` rows, default
``driver.DEFAULT_TRACE_CAP``; a search that overflows it warns).
:attr:`Solver.report` is the last solve's :class:`SolveReport`: the
driver's on the device backend, one built here on the host backend.

  * ``"auto"`` — :func:`resolve_backend` (``solver.py:379-561``) picks
    one of the two: the host engine for a single problem (so
    ``Solver(backend="auto")`` always solves on the host, as the
    reference's does) and while the card's circuit breaker is open, else
    the device when the engine probe's verdict for ``device`` says it is
    usable.  On ``"cpu"`` the verdict is True in-process (the plain
    versions always run); on ``"cuda"`` it comes from a killable
    subprocess that solves one tiny problem on the card, so True means
    the kernels loaded (or built) and launched.

Any other name raises :class:`InternalSolverError`, the reference's
``"tpu"`` included.

The assumption scopes (:meth:`Solver.assume`, :meth:`Solver.test`,
:meth:`Solver.untest`) run on the host engine on either backend, as in
the reference: a propagation-only Test is a host operation by design,
not a fallback.  A :meth:`Solver.solve` under an open scope answers for
the assumed problem (:func:`assumed_variables`), lowered by
:func:`encode_assumed`.  With a request scheduler attached
(``Solver(..., scheduler=s)``, the scope model of
``deppy_tpu/sat/solver.py:78-135,181-277``) a scoped solve routes
through :meth:`deppy_tpu_torch.sched.Scheduler.submit_session` — the
session class, the shared result cache bypassed both ways, warm starts
planned against :attr:`Solver.warm_index` — and answers on the
scheduler's device; without one it solves on the configured backend
(where the reference solves on an inline host engine: the same answer,
with the card kept in view).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

from .. import telemetry
from .constraints import Variable, mandatory, prohibited
from .encode import Problem, encode, encode_assumed
from .errors import Incomplete, InternalSolverError, NotSatisfiable
from .host import HostEngine
from .tracer import Tracer

BACKENDS = ("device", "host", "auto")


def check_backend(backend: str) -> str:
    """``backend`` if the port serves it, else :class:`InternalSolverError`."""
    if backend not in BACKENDS:
        raise InternalSolverError([f"unknown backend {backend!r}"])
    return backend


def resolve_backend(backend: str, *, batch: bool = True, block: bool = True,
                    device="cuda") -> str:
    """Resolve a backend name to ``"device"`` or ``"host"``: the one place
    the ``auto`` policy lives (``solver.py:379-423``; shared by
    :class:`Solver`, the resolution facade and the request scheduler).
    Raises on unknown names.

    Under ``auto``: a single problem (``batch=False``) goes to the host
    engine — a batch of one is dispatch-latency-bound, and the device's
    win is batch parallelism; an open circuit breaker means host, without
    a probe; ``block=False`` (a caller that must not stall on the first
    probe, the scheduler's dispatch loop) with no verdict yet for
    ``device``'s type means host, except on the CPU, whose verdict is
    instant; otherwise the probe's verdict decides.  ``"device"`` and
    ``"host"`` resolve to themselves."""
    check_backend(backend)
    if backend != "auto":
        return backend
    if not batch:
        return "host"
    from .. import faults

    if faults.default_breaker().blocks_device():
        return "host"
    kind = _device_type(device)
    if not block and kind not in _ENGINE_USABLE and kind != "cpu":
        return "host"
    return "device" if _engine_usable(device) else "host"


# The engine probe's verdict per device type ("cuda", "cpu"), cached for
# the process: ``auto`` is a routing policy, not a health monitor
# (:func:`reprobe_engine` replaces a verdict).  One lock serializes the
# probes, so concurrent ``auto`` callers share one subprocess.
_ENGINE_USABLE: Dict[str, bool] = {}
_ENGINE_USABLE_LOCK = threading.Lock()
# A card probe loads the kernels (building them into the git-ignored
# cache when the tree has none) and launches them; a wedged card can
# hang its first call, so the probe is a killable subprocess.
_PROBE_TIMEOUT_S = 75
# The child also ends itself shortly after the parent's timeout, so an
# orphan (its parent died mid-probe) cannot hang holding the card.
_PROBE_SELF_DESTRUCT_S = _PROBE_TIMEOUT_S + 5
# The probe's source: import the port, solve one tiny problem on the
# card — right, through the kernels, and not host-routed by the fault
# envelope — and leave through os._exit (skipping a teardown that could
# hang).
_PROBE_SRC = """
import os, signal
signal.signal(signal.SIGALRM, lambda *a: os._exit(3))
signal.alarm({alarm})
import torch
from deppy_tpu_torch import engine, telemetry
from deppy_tpu_torch.engine import driver
from deppy_tpu_torch.sat.constraints import dependency, mandatory, variable
out = driver.solve_batch(
    [[variable("a", mandatory(), dependency("b")), variable("b")]],
    device="cuda")
torch.cuda.synchronize()
routed = telemetry.default_registry().snapshot().get(
    "deppy_fault_host_routed_total", 0)
ok = (out == [{{"a": True, "b": True}}] and not routed
      and sum(engine.launch_counts().values()) > 0)
os._exit(0 if ok else 4)
"""


def _device_type(device) -> str:
    return str(device).split(":")[0]


def reprobe_engine(device="cuda") -> bool:
    """Probe engine usability on ``device`` again and replace its cached
    verdict (``solver.py:465-497``).  A long-lived ``auto``-routed
    process (the scheduler's deferred re-probe) calls this to upgrade
    routing once the card recovers.  A True verdict is independent
    evidence that the card works, so it also closes the circuit
    breaker.  Returns the fresh verdict."""
    kind = _device_type(device)
    with _ENGINE_USABLE_LOCK:
        fresh = _probe_verdict(kind)
        _ENGINE_USABLE[kind] = fresh
    if fresh:
        from .. import faults

        faults.default_breaker().reset()
    return fresh


def _engine_usable(device="cuda") -> bool:
    """The cached verdict for ``device``'s type, probing once on first
    use (``solver.py:500-525``)."""
    kind = _device_type(device)
    verdict = _ENGINE_USABLE.get(kind)
    if verdict is not None:
        return verdict
    with _ENGINE_USABLE_LOCK:
        if kind not in _ENGINE_USABLE:  # a concurrent caller probed first
            _ENGINE_USABLE[kind] = _probe_verdict(kind)
        return _ENGINE_USABLE[kind]


def _probe_verdict(kind: str) -> bool:
    """One engine-usability probe, no cache interaction
    (``solver.py:527-561``).  On the CPU the plain versions always run:
    True, in-process.  On ``cuda`` a subprocess with its output sent to
    DEVNULL (a captured pipe held by a wedged helper would hang the
    parent past the timeout) solves one tiny problem on the card."""
    if kind == "cpu":
        return True
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    try:
        probe = subprocess.run(
            [sys.executable, "-c",
             _PROBE_SRC.format(alarm=_PROBE_SELF_DESTRUCT_S)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            timeout=_PROBE_TIMEOUT_S, env=env)
        return probe.returncode == 0
    # A hung or failed probe IS the False verdict.
    except Exception:  # noqa: BLE001
        return False


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
                 device="cuda", max_steps: Optional[int] = None,
                 trace_cap: Optional[int] = None, scheduler=None,
                 tenant: str = "default"):
        check_backend(backend)
        self.problem: Problem = encode(variables)
        self.tracer = tracer
        self.backend = backend
        self.device = device
        self.max_steps = max_steps
        # Trace-buffer depth on the device backend (None: the driver's
        # default); the host engine traces unbuffered.
        self.trace_cap = trace_cap
        # Engine iterations and search backtracks of the last solve.
        self.steps: int = 0
        self.backtracks: int = 0
        # The last solve's telemetry (outcome, counters and, on the
        # device backend, the driver's padding data and stage walls).
        self.report: Optional[telemetry.SolveReport] = None
        self._inc_engine: Optional[HostEngine] = None
        # An attached request scheduler makes scoped solves route
        # through ``Scheduler.submit_session`` (racing, deadlines and
        # fair admission unchanged, the shared result cache bypassed).
        # ``warm_index`` is the session's private clause-set index,
        # handed to the scheduler so scoped solves warm-start from the
        # session's own last model.
        self.scheduler = scheduler
        self.tenant = tenant
        self.warm_index = None
        # (key, assumptions) of the last scheduled scoped solve: the
        # declared warm predecessor of the next one.
        self._scope_last: Optional[tuple] = None

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

    def _scope_key(self, assumptions: Sequence[tuple]) -> str:
        """Session-local lane key for a scoped solve: the base problem's
        canonical fingerprint (paid ONCE per solver, memoized) salted
        with the open assumption stack in order.  Scoped lanes bypass
        the shared result cache in both directions, so this key's only
        job is entry identity inside the session's private clause-set
        index — which makes an O(assumptions) digest legitimate where
        stateless lanes must pay the O(problem) ``fingerprint``.
        Deterministic per (catalog, stack), so revisiting an assumption
        state revisits its private-index entry."""
        base = self.problem.__dict__.get("_scope_base_key")
        if base is None:
            from ..sched.cache import fingerprint

            base = fingerprint(self.problem)
            self.problem.__dict__["_scope_base_key"] = base
        h = hashlib.sha256(base.encode())
        for ident, installed in assumptions:
            h.update(b"\x1f" + str(ident).encode("utf-8", "surrogatepass"))
            h.update(b"+" if installed else b"-")
        return "scope:" + h.hexdigest()

    def _scope_plan_args(self, assumptions: Sequence[tuple]) -> tuple:
        """``(session_key, scope_entry_key, scope_seed)`` for
        ``Scheduler.submit_session``: this solve's session-local key,
        the previous scoped solve's key (the declared warm predecessor
        in the private index — None on the session's first solve), and
        the variable indices whose assumptions CHANGED between the two
        stacks (multiset symmetric difference, so a re-assumed pair
        cancels and an assume-then-invert shows up once per side) — the
        exact seed the O(delta) cone closure needs, because every
        added/removed constraint row is a unit on one of these
        subjects."""
        key = self._scope_key(assumptions)
        prev = self._scope_last
        if prev is None:
            return key, None, ()
        prev_key, prev_assumptions = prev
        cur_c = Counter(assumptions)
        prev_c = Counter(prev_assumptions)
        seed = sorted({
            idx for ident, _ in
            list((cur_c - prev_c).keys()) + list((prev_c - cur_c).keys())
            if (idx := self.problem.id_to_index.get(ident)) is not None})
        return key, prev_key, tuple(seed)

    def solve_scoped(self, deadline_s: Optional[float] = None,
                     stats: Optional[dict] = None):
        """Solve under the OPEN assumption stack and return the raw
        result object (solution dict / ``NotSatisfiable`` /
        ``Incomplete``), un-decoded so a caller can render it with
        :func:`deppy_tpu_torch.io.result_to_dict`.

        The derived problem is lowered by :func:`encode_assumed` (the
        assumption splice, not a catalog re-walk).  With a scheduler
        attached it routes through ``Scheduler.submit_session``: the
        session class, the shared result cache bypassed in BOTH
        directions (an assumption-conditioned answer must never be
        admitted where stateless traffic could read it), and warm starts
        planned against :attr:`warm_index` when set — O(delta) against
        the previous scoped solve's entry when one is on record, the
        generic classifier otherwise; ``deadline_s`` rides on the lane.
        Without one it solves on the configured backend: ``solve_one``
        on ``device``, or an inline :class:`HostEngine`
        (``deadline_s`` is not read there, as in the reference's inline
        path)."""
        assumptions = self.assumptions()
        p = encode_assumed(self.problem, assumptions)
        if self.scheduler is not None:
            key, entry_key, seed = self._scope_plan_args(assumptions)
            try:
                return self.scheduler.submit_session(
                    p.variables, deadline_s=deadline_s,
                    max_steps=self.max_steps, stats=stats,
                    tenant=self.tenant, warm_index=self.warm_index,
                    session_key=key, scope_entry_key=entry_key,
                    scope_seed=seed, problem=p)
            finally:
                # Track the key/stack pair even for UNSAT or failed
                # answers: a missing private-index entry just means the
                # next step's scoped plan misses and the generic
                # classifier (then the cold path) answers.
                self._scope_last = (key, list(assumptions))
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
            # (gini's Solve consumes assumptions) — through the scheduler
            # when one is attached — decoded back to the
            # installed-variables contract.
            r = self.solve_scoped()
            if isinstance(r, (NotSatisfiable, Incomplete)):
                raise r
            return [v for v in self.problem.variables
                    if r.get(v.identifier)]
        return self._solve_problem(self.problem, tracer=self.tracer)

    def _solve_problem(self, problem: Problem,
                       tracer: Optional[Tracer]) -> List[Variable]:
        if resolve_backend(self.backend, batch=False,
                           device=self.device) == "host":
            return self._solve_host(problem, tracer)
        from ..engine.driver import solve_one

        stats: dict = {}
        try:
            return solve_one(problem, max_steps=self.max_steps,
                             stats=stats, device=self.device, tracer=tracer,
                             trace_cap=self.trace_cap)
        finally:
            self.steps = stats.get("steps", 0)
            self.backtracks = stats.get("backtracks", 0)
            self.report = stats.get("report")

    def _solve_host(self, problem: Problem,
                    tracer: Optional[Tracer]) -> List[Variable]:
        """One host-engine solve (``solver.py:311-376``): untraced through
        the host path's shared entry, whose one lane runs inline on the
        same :func:`~deppy_tpu_torch.hostpool.solve_lane` the pool's
        workers run; traced on an inline engine (tracer callbacks cannot
        cross a process boundary).  The answer, its core objects, its
        counts and its ``SolveReport`` are the engine's either way."""
        if tracer is not None:
            return self._solve_host_traced(problem, tracer)
        from .. import hostpool

        try:
            (lane,) = hostpool.solve_host_problems(
                [problem], max_steps=self.max_steps)
        except InternalSolverError:
            # The report exists (outcome-less) even when the problem was
            # malformed, as on the traced path.
            self.steps = self.backtracks = 0
            self.report = telemetry.SolveReport(backend="host",
                                                n_problems=1)
            raise
        self.steps = lane.steps
        self.backtracks = lane.backtracks
        rep = telemetry.SolveReport(backend="host", n_problems=1)
        hostpool.count_lane(rep, lane)
        rep.add_wall("solve", lane.wall_s)
        self.report = rep
        if lane.outcome == "sat":
            return [problem.variables[i] for i in lane.installed_idx]
        raise hostpool.lane_answer(problem, lane)

    def _solve_host_traced(self, problem: Problem,
                           tracer: Tracer) -> List[Variable]:
        engine = HostEngine(problem, tracer=tracer, max_steps=self.max_steps)
        t0 = time.perf_counter()
        outcome: Optional[str] = None
        try:
            installed, _ = engine.solve()
            outcome = "sat"
            return installed
        except NotSatisfiable:
            outcome = "unsat"
            raise
        except Incomplete:
            outcome = "incomplete"
            raise
        finally:
            self.steps = engine.steps
            self.backtracks = engine.backtracks
            rep = telemetry.SolveReport(backend="host", n_problems=1)
            if outcome is not None:
                rep.count_outcome(outcome)
            rep.steps = engine.steps
            rep.decisions = engine.decisions
            rep.propagation_rounds = engine.propagation_rounds
            rep.backtracks = engine.backtracks
            rep.add_wall("solve", time.perf_counter() - t0)
            self.report = rep
