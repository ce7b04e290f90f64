"""Bound-tightening optimization loop (copy of ``deppy_tpu/optimize/loop.py:1-353``).

One loop serves every optimize query class: solve for ANY model, then
repeatedly probe "is there a model with cost <= best - 1?" until a
probe's UNSAT proves optimality, the objective floor is reached, or a
budget degrades the request to best-so-far.

* The feasibility solve, every native probe (a unit-positive objective
  lowered to one ``AtMost`` row) and an explain's solve ride
  :meth:`deppy_tpu_torch.sched.Scheduler.submit_optimize`, the idle
  queue: a long optimization coalesces at flush boundaries and live
  resolution traffic preempts every iteration.  On a card scheduler
  they are dispatched to the card.
* Mixed-sign probes (an ``upgrade`` objective, weighted soft
  preferences) and warm probes run inline on the host objective
  engine, the registry's one ``bound_weights`` backend
  (``registry.optimize_candidates`` makes that routing data-driven).
* Warm probes re-search only the objective cone of the previous model;
  a warm probe's UNSAT is never a proof, the cold fallback's is.
* Every probe emits an ``optimize.iteration`` span plus a sink
  ``optimize`` event, and the tier's counters
  (``deppy_optimize_{iterations,improvements,proofs}_total``) land on
  the given registry.

Answer canonicality: the loop's last act is a canonical cold bounded
solve at the proven best cost on the host engine.  Every model at that
bound has exactly the optimal cost, and the host DPLL's false-first,
lowest-index order returns the lexicographically least of them.

Knobs: ``DEPPY_GPU_OPT_MAX_ITERATIONS`` (64), ``DEPPY_GPU_OPT_ITER_BUDGET``
(2**20 steps a probe) and ``DEPPY_GPU_OPT_MAX_WEIGHT`` (64); a
malformed value degrades to the default.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from .. import telemetry
from ..engine import registry as engine_registry
from ..sat.constraints import Variable
from ..sat.encode import encode
from ..sat.errors import Incomplete, InternalSolverError, NotSatisfiable
from ..sat.host import HostEngine
from .objective import (
    Objective,
    OptimizeRequest,
    build_objective,
    cone_mask,
    explain_variables,
    native_bound_variables,
)

DEFAULT_MAX_ITERATIONS = 64
DEFAULT_ITER_BUDGET = 1 << 20
DEFAULT_MAX_WEIGHT = 64

# A warm cone covering more than this fraction of the problem is no
# cone at all — the probe would re-search nearly everything while
# dragging the pinned prefix's bias; go straight to the cold probe
# (the incremental tier draws the same line for delta cones).
MAX_CONE_FRACTION = 0.5


def _env_int(name: str, default: int) -> int:
    """An int knob; unset, blank or malformed reads ``default``."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class Planner:
    """The optimization tier's serving core: parse → objective →
    tightening loop → canonical answer.

    Constructed directly in library use over a scheduler (the service
    that constructs one behind ``DEPPY_GPU_OPT`` comes with ROADMAP
    A5.6.6); ``metrics`` is the registry the tier's counters land on.
    ``handle`` raises :class:`OptimizeFormatError` for malformed
    documents (the service's 400) and ``InternalSolverError`` for
    unresolvable references, mirroring the resolve path's screening."""

    def __init__(self, scheduler, metrics=None,
                 max_iterations: Optional[int] = None,
                 iter_budget: Optional[int] = None,
                 max_weight: Optional[int] = None):
        self.scheduler = scheduler
        self.max_iterations = (
            max_iterations if max_iterations is not None
            else _env_int("DEPPY_GPU_OPT_MAX_ITERATIONS", DEFAULT_MAX_ITERATIONS))
        self.iter_budget = (
            iter_budget if iter_budget is not None
            else _env_int("DEPPY_GPU_OPT_ITER_BUDGET", DEFAULT_ITER_BUDGET))
        self.max_weight = (
            max_weight if max_weight is not None
            else _env_int("DEPPY_GPU_OPT_MAX_WEIGHT", DEFAULT_MAX_WEIGHT))
        reg = metrics if metrics is not None \
            else telemetry.default_registry()
        self._c_iterations = reg.counter(
            "deppy_optimize_iterations_total",
            "Bound-tightening probes run, by mode (warm = cone probe "
            "seeded from the previous model, cold = complete probe).",
            labelname="mode")
        self._c_improvements = reg.counter(
            "deppy_optimize_improvements_total",
            "Probes that found a strictly better model.")
        self._c_proofs = reg.counter(
            "deppy_optimize_proofs_total",
            "Optimality proofs, by kind (unsat_probe = a cold probe "
            "below the best cost proved UNSAT; floor = the objective's "
            "lower bound was reached).", labelname="kind")

    # ------------------------------------------------------------- entry

    def handle(self, doc, deadline_s: Optional[float] = None,
               tenant: str = "default") -> dict:
        """Serve one optimize request document; returns the response
        payload (the service wraps it as ``{"optimize": ...}``)."""
        req = OptimizeRequest.from_doc(doc, self.max_weight)
        if req.query == "explain":
            return self._explain(req, deadline_s, tenant)
        return self._tighten(req, deadline_s, tenant)

    # ----------------------------------------------------------- explain

    def _explain(self, req: OptimizeRequest,
                 deadline_s: Optional[float], tenant: str) -> dict:
        """Explain-why-not: the goals become mandatory, and the family's
        unsat core — extracted by whatever definitive backend answered —
        IS the human-readable blocking set."""
        family = list(explain_variables(req))
        res = self.scheduler.submit_optimize(
            [family], deadline_s=deadline_s, tenant=tenant)[0]
        out: dict = {"query": "explain", "goal": list(req.goal)}
        if isinstance(res, dict):
            out["status"] = "feasible"
            out["plan"] = sorted(str(k) for k, v in res.items() if v)
        elif isinstance(res, NotSatisfiable):
            out["status"] = "blocked"
            out["blocking"] = [str(c) for c in res.constraints]
        else:
            out["status"] = "degraded"
            out["reason"] = "feasibility-budget"
        return out

    # ---------------------------------------------------------- tighten

    def _tighten(self, req: OptimizeRequest,
                 deadline_s: Optional[float], tenant: str) -> dict:
        variables = list(req.variables)
        p = encode(variables)
        if p.errors:
            raise InternalSolverError(p.errors)
        n = p.n_vars
        index = {str(v.identifier): i for i, v in enumerate(variables)}
        objective = build_objective(req, index, n)
        deadline_t = (time.monotonic() + deadline_s
                      if deadline_s is not None else None)
        reg = telemetry.default_registry()

        out: dict = {"query": req.query, "iterations": 0,
                     "improvements": 0, "optimal": False, "proof": None}

        res = self._submit(variables, deadline_t, tenant, None)
        if isinstance(res, NotSatisfiable):
            # Infeasible outright: explain-why-not for free.
            out["status"] = "unsat"
            out["blocking"] = [str(c) for c in res.constraints]
            return out
        if not isinstance(res, dict):
            out["status"] = "degraded"
            out["reason"] = "feasibility-budget"
            return out
        best = np.fromiter((bool(res[v.identifier]) for v in variables),
                           dtype=bool, count=n)
        cost = objective.value(best)
        floor = objective.floor
        iterations = 0
        improvements = 0
        proof: Optional[str] = None
        reason: Optional[str] = None
        try_warm = req.warm

        if cost <= floor:
            proof = "floor"
            self._c_proofs.inc(label="floor")
        while proof is None and reason is None:
            if iterations >= self.max_iterations:
                reason = "iteration-cap"
                break
            if deadline_t is not None \
                    and time.monotonic() >= deadline_t:
                reason = "deadline"
                break
            bound = cost - 1
            iterations += 1
            mode = "warm" if try_warm else "cold"
            if mode == "warm":
                cone = cone_mask(p, best, objective)
                if int(cone.sum()) > MAX_CONE_FRACTION * n:
                    mode = "cold"
            self._c_iterations.inc(label=mode)
            t0 = time.perf_counter()
            backend = "host"
            outcome = "unsat"
            delta = 0
            model: Optional[np.ndarray] = None
            with reg.span("optimize.iteration", iteration=iterations,
                          bound=bound, mode=mode, tenant=tenant) as sp:
                if mode == "warm":
                    status, m = self._host_probe(p, objective, bound,
                                                 seed=best, cone=cone)
                    if status == "sat":
                        model = m
                    else:
                        # A warm UNSAT/budget miss is NOT a proof — the
                        # pinned off-cone prefix may be what blocks the
                        # bound.  The next probe at this bound is cold.
                        try_warm = False
                        outcome = "warm-miss"
                else:
                    model, outcome, backend = self._cold_probe(
                        p, variables, objective, bound, deadline_t,
                        tenant)
                if model is not None:
                    best = model
                    new_cost = objective.value(best)
                    delta = cost - new_cost
                    cost = new_cost
                    improvements += 1
                    self._c_improvements.inc()
                    outcome = "improved"
                    sp.set(improvement=delta)
                    try_warm = req.warm
                    if cost <= floor:
                        proof = "floor"
                        self._c_proofs.inc(label="floor")
                elif outcome == "unsat":
                    proof = "unsat_probe"
                    self._c_proofs.inc(label="unsat_probe")
                elif outcome == "budget":
                    reason = "probe-budget"
                sp.set(backend=backend, outcome=outcome)
            reg.event("optimize", iteration=iterations, mode=mode,
                      backend=backend, outcome=outcome, bound=bound,
                      objective=cost, improvement=delta,
                      dur_s=round(time.perf_counter() - t0, 6),
                      tenant=tenant)

        canonical = self._canonicalize(p, objective, cost)
        if canonical is not None:
            best = canonical
            cost = objective.value(best)
        out["status"] = "optimal" if proof is not None else "degraded"
        out["optimal"] = proof is not None
        out["proof"] = proof
        if reason is not None:
            out["reason"] = reason
        if canonical is None:
            out["canonical"] = False
        out["iterations"] = iterations
        out["improvements"] = improvements
        out["objective"] = cost
        selected = [str(variables[i].identifier)
                    for i in np.nonzero(best)[0]]
        out["selected"] = selected
        if req.query == "upgrade":
            chosen = set(selected)
            out["missing_prefer"] = [i for i in req.prefer
                                     if i not in chosen]
            installed = set(req.installed)
            out["touched"] = (len(installed - chosen)
                              + len(chosen - installed))
        return out

    # ------------------------------------------------------------ probes

    def _submit(self, family: List[Variable],
                deadline_t: Optional[float], tenant: str,
                max_steps: Optional[int]):
        """One family through the scheduler's idle-priority optimize
        queue (portfolio-raced, preempted by live traffic)."""
        remaining = None
        if deadline_t is not None:
            remaining = max(deadline_t - time.monotonic(), 0.001)
        return self.scheduler.submit_optimize(
            [family], deadline_s=remaining, max_steps=max_steps,
            tenant=tenant)[0]

    def _host_probe(self, p, objective: Objective, bound: int,
                    seed: Optional[np.ndarray] = None,
                    cone: Optional[np.ndarray] = None):
        """One bounded probe on the host objective engine — the one
        backend with ``bound_weights`` (mixed-sign) support, and the
        only engine that can warm-start from a pinned cone.  A fresh
        engine per probe keeps the step budget per-probe, matching the
        scheduler's per-dispatch budgets.  Returns ``(status, model)``
        with status ``sat``/``unsat``/``budget`` — the unsat/budget
        distinction matters because only a COMPLETE cold probe's unsat
        is an optimality proof."""
        eng = HostEngine(p, max_steps=self.iter_budget)
        try:
            ok, m = eng.solve_bounded(objective.signed,
                                      objective.bound_for(bound),
                                      seed_model=seed, cone_mask=cone)
        except Incomplete:
            return "budget", None
        if not ok:
            return "unsat", None
        return "sat", np.asarray(m[: p.n_vars] > 0, dtype=bool)

    def _cold_probe(self, p, variables: List[Variable],
                    objective: Objective, bound: int,
                    deadline_t: Optional[float], tenant: str):
        """One complete probe at ``bound``.  Returns ``(model-or-None,
        outcome, backend)`` where outcome is ``improved`` (model
        found), ``unsat`` (definitive — the caller's optimality proof),
        or ``budget``.  Routing is registry-driven: a unit-positive
        objective lowers to a plain AtMost family served through the
        scheduler (raced across ``optimize_candidates``); otherwise the
        host objective engine — the single ``bound_weights``
        candidate — runs it inline."""
        native = native_bound_variables(variables, objective,
                                        objective.bound_for(bound))
        signed = not objective.unit_positive
        names, _ = engine_registry.optimize_candidates(
            "m", signed=signed,
            device=getattr(self.scheduler, "device", "cuda"))
        if native is not None and self.scheduler is not None \
                and len(names) > 1:
            res = self._submit(list(native), deadline_t, tenant,
                               self.iter_budget)
            if isinstance(res, dict):
                model = np.fromiter(
                    (bool(res[v.identifier]) for v in variables),
                    dtype=bool, count=p.n_vars)
                return model, "improved", "sched"
            if isinstance(res, NotSatisfiable):
                return None, "unsat", "sched"
            return None, "budget", "sched"
        status, m = self._host_probe(p, objective, bound)
        if status == "sat":
            return m, "improved", "host"
        return None, status, "host"

    def _canonicalize(self, p, objective: Objective,
                      cost: int) -> Optional[np.ndarray]:
        """The canonical answer at the final cost: a cold bounded solve
        whose lex-least model is THE tie-break the differential oracle
        pins.  Every model at the proven-optimal bound has exactly the
        optimal cost, so lex-least-under-bound = lex-least-among-
        optima.  None on budget exhaustion — the caller keeps the raw
        best model and flags it non-canonical."""
        status, m = self._host_probe(p, objective, cost)
        if status != "sat":
            return None
        return m
