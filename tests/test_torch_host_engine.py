"""The port's host engine, ``encode_assumed`` and ``Solver`` scopes against the JAX package's.

``deppy_tpu_torch.sat.host.HostEngine`` against ``deppy_tpu.sat.host
.HostEngine`` (numpy on both sides, no JAX compile): the same problem,
made from one seed and carried across with ``variables_from_objects``,
through every entry of the engine — the cold solve, budgets, the
assume/test/untest scopes, ``solve_bounded``, ``solve_warm``,
``solve_guided``, cancellation and the ``LoggingTracer`` transcript.
Each comparison takes the outcome, the installed indices, the core's
indices (rebuilt by object identity against ``problem.applied``), and
``steps``, ``decisions``, ``propagation_rounds`` and ``backtracks``,
with tolerance 0.  Then ``encode_assumed`` byte for byte, and the
``Solver`` scope surface on both port backends against the reference's
host backend.
"""

from __future__ import annotations

import io
import random
import threading

import numpy as np
import pytest
from test_conformance import CASES
from test_incremental import bundle_catalog

from deppy_tpu import sat as jsat
from deppy_tpu.incremental import ClauseSetIndex
from deppy_tpu.models import (giant_pinned_conflict, gvk_conflict_catalog,
                              operatorhub_catalog, pinned_tenant_catalog,
                              random_instance, version_pinned_chains)
from deppy_tpu.sat import host as jhost
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sat.encode import encode_assumed as jencode_assumed
from deppy_tpu.sat.solver import assumed_variables as jassumed
from deppy_tpu.sched.cache import fingerprint
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.sat import host as thost
from deppy_tpu_torch.sat.encode import encode as tencode
from deppy_tpu_torch.sat.encode import encode_assumed as tencode_assumed

TENSORS = ("clauses", "clause_con", "card_ids", "card_n", "card_act",
           "card_con", "anchors", "choice_cand", "var_choices")


def _problems(jvars):
    """(reference problem, port problem) of one variable list, whose
    tensors must already agree."""
    jp = jencode(jvars)
    tp = tencode(variables_from_objects(jvars))
    for name in TENSORS:
        assert np.array_equal(getattr(jp, name), getattr(tp, name)), name
    return jp, tp


def _outcome(problem, call):
    """What one engine entry did: its return value, or the exception it
    raised, as plain data.  A core comes back as applied indices, each
    core object required to BE an entry of ``problem.applied``."""
    try:
        out = call()
    except Exception as e:  # noqa: BLE001 - compared by name below
        name = type(e).__name__
        if name == "NotSatisfiable":
            ids = {id(c) for c in e.constraints}
            core = [j for j, c in enumerate(problem.applied) if id(c) in ids]
            assert len(core) == len(e.constraints), "core not by identity"
            return ("NotSatisfiable", tuple(core), str(e))
        if name in ("WarmStartConflict", "GuidanceUnverified"):
            return (name, e.reason)
        if name in ("Incomplete", "SolveCancelled", "InternalSolverError"):
            return (name, str(e))
        raise
    if isinstance(out, tuple) and isinstance(out[0], (bool, np.bool_)):
        ok, model = out   # solve_bounded
        return ("bounded", bool(ok),
                None if model is None else tuple(model.tolist()))
    if isinstance(out, tuple):
        variables, idx = out
        assert [v.identifier for v in variables] == [
            problem.variables[i].identifier for i in idx]
        return ("sat", tuple(idx))
    return ("value", out)


def _counters(eng):
    return (eng.steps, eng.decisions, eng.propagation_rounds, eng.backtracks)


def _same(jvars, entry, **kw):
    """Run ``entry(engine, host_module)`` on a fresh engine of each
    package; the outcome and the counters must be equal.  Returns the
    reference's (outcome, counters)."""
    jp, tp = _problems(jvars)
    je = jhost.HostEngine(jp, **kw)
    te = thost.HostEngine(tp, **kw)
    want = _outcome(jp, lambda: entry(je, jhost))
    got = _outcome(tp, lambda: entry(te, thost))
    assert got == want
    assert _counters(te) == _counters(je)
    return want, _counters(je)


def _solve(eng, _mod):
    return eng.solve()


# ------------------------------------------------------------ cold solve


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_solve_matches_on_conformance_cases(case):
    _same(case.variables, _solve)


@pytest.mark.parametrize("seed", range(20))
def test_solve_matches_on_random_instances(seed):
    _same(random_instance(length=24, seed=seed), _solve)


def _tenant_unsat_seed():
    for seed in range(20):
        try:
            jhost.HostEngine(jencode(pinned_tenant_catalog(seed=seed))).solve()
        except jsat.NotSatisfiable:
            return seed
    raise AssertionError("no UNSAT pinned-tenant seed in 0..19")


FAMILIES = {
    "operatorhub": lambda: operatorhub_catalog(12, 3, seed=1),
    "chains": lambda: version_pinned_chains(8, 3, seed=2),
    "gvk": lambda: gvk_conflict_catalog(10, 4, 5, seed=3),
    "pinned_tenant": lambda: pinned_tenant_catalog(seed=_tenant_unsat_seed()),
    "giant_pinned_conflict": lambda: giant_pinned_conflict(12, 3, seed=4),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_solve_matches_on_catalog_families(family):
    _same(FAMILIES[family](), _solve)


@pytest.mark.parametrize("max_steps", [0, 1, 3, 9, 40])
@pytest.mark.parametrize("family", ["chains", "pinned_tenant"])
def test_step_budget_cuts_at_the_same_point(family, max_steps):
    """``Incomplete`` is raised at the same step under every budget, the
    core's deletion sweep (pinned_tenant) included."""
    _same(FAMILIES[family](), _solve, max_steps=max_steps)


def test_malformed_problem_raises_the_same_error():
    vs = [jsat.variable("a", jsat.dependency("missing"))]
    (outcome, _), _ = _same(vs, _solve)
    assert outcome == "InternalSolverError"


# ----------------------------------------------------------------- scopes


def _scope_script(seed: int, n_vars: int, n_ops: int):
    """A random assume/test/untest sequence over ``n_vars`` variables;
    ``untest`` may come with no scope open."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:
            ops.append(("assume", [rng.choice((1, -1)) * rng.randint(1, n_vars)
                                   for _ in range(rng.randint(1, 3))]))
        elif r < 0.75:
            ops.append(("test", None))
        else:
            ops.append(("untest", None))
    return ops


def _run_scopes(eng, ops):
    trail = []
    for op, arg in ops:
        try:
            if op == "assume":
                eng.assume(arg)
                r = None
            else:
                r = getattr(eng, op)()
        except Exception as e:  # noqa: BLE001 - compared by name and text
            r = (type(e).__name__, str(e))
        trail.append((op, r, list(eng._assumed_lits), list(eng._test_scopes),
                      eng._scope_base, _counters(eng)))
    return trail


@pytest.mark.parametrize("seed", range(6))
def test_assume_test_untest_sequences(seed):
    jvars = random_instance(length=16, seed=seed)
    jp, tp = _problems(jvars)
    ops = _scope_script(seed, jp.n_vars, 24)
    assert (_run_scopes(thost.HostEngine(tp), ops)
            == _run_scopes(jhost.HostEngine(jp), ops))


def test_untest_without_test_and_bad_literals_raise_the_same():
    jp, tp = _problems(operatorhub_catalog(6, 2, seed=0))
    ops = [("untest", None), ("assume", [0]), ("assume", [jp.n_total + 1]),
           ("assume", [1]), ("test", None), ("untest", None),
           ("untest", None)]
    got = _run_scopes(thost.HostEngine(tp), ops)
    assert got == _run_scopes(jhost.HostEngine(jp), ops)
    assert got[0][1] == ("InternalSolverError", "1 errors encountered: "
                         "untest without a matching test")


# ---------------------------------------------------------- solve_bounded


@pytest.mark.parametrize("seed", range(4))
def test_solve_bounded(seed):
    jvars = random_instance(length=16, seed=seed)
    n = len(jvars)
    rng = np.random.default_rng(seed)
    obj_w = rng.integers(-2, 4, size=n)
    for bound in (-3, 0, 2, int(np.abs(obj_w).sum())):
        _same(jvars, lambda e, _m: e.solve_bounded(obj_w, bound))
    # The warm (cone) variant: off-cone variables pinned to a seed model.
    seed_model = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    cone = rng.random(n) < 0.6
    _same(jvars, lambda e, _m: e.solve_bounded(obj_w, 1, seed_model, cone))


# ------------------------------------------------------------- solve_warm


def _cold_model(jvars):
    eng = jhost.HostEngine(jencode(jvars))
    _, idx = eng.solve()
    model = np.full(len(jvars), -1, np.int8)
    model[list(idx)] = 1
    return model, eng


@pytest.mark.parametrize("seed", range(3))
def test_solve_warm_all_true_cone(seed):
    jvars = bundle_catalog(random.Random(seed))
    model, _ = _cold_model(jvars)
    cone = np.ones(len(jvars), bool)
    _same(jvars, lambda e, _m: e.solve_warm(model, cone))


def test_solve_warm_with_an_incremental_cone_and_a_conflict():
    """A cone planned by the reference's ``deppy_tpu.incremental`` index:
    the warm solve serves on both engines, and a poisoned off-cone anchor
    raises the same ``WarmStartConflict``."""
    from deppy_tpu import telemetry

    base_vars = bundle_catalog()
    base = jencode(base_vars)
    model, eng = _cold_model(base_vars)
    index = ClauseSetIndex(registry=telemetry.Registry())
    index.store(fingerprint(base), base, model == 1, eng.steps,
                eng.backtracks)
    new_vars = bundle_catalog(tweak=("add-conflict", 2))
    new = jencode(new_vars)
    plan = index.plan(new, fingerprint(new), 1 << 24)
    assert plan is not None and 0 < plan.cone.sum() < new.n_vars
    (outcome, *_), _ = _same(
        new_vars, lambda e, _m: e.solve_warm(plan.warm_assign, plan.cone))
    assert outcome == "sat"
    poisoned = plan.warm_assign.copy()
    anchor = next(int(a) for a in new.anchors if not plan.cone[a])
    poisoned[anchor] = -1
    (outcome, reason), _ = _same(
        new_vars, lambda e, _m: e.solve_warm(poisoned, plan.cone))
    assert (outcome, reason) == ("WarmStartConflict", "warm-prefix-conflict")


# ----------------------------------------------------------- solve_guided


@pytest.mark.parametrize("seed", range(4))
def test_solve_guided_right_and_wrong_hints(seed):
    jvars = random_instance(length=16, seed=seed)
    model, _ = _cold_model(jvars)
    right = model == 1
    _same(jvars, lambda e, _m: e.solve_guided(right))
    _same(jvars, lambda e, _m: e.solve_guided(None))
    wrong = ~right
    _same(jvars, lambda e, _m: e.solve_guided(wrong))


def test_solve_guided_rejects_a_wrong_rounding():
    vs = [jsat.variable("a", jsat.mandatory(), jsat.dependency("b", "c")),
          jsat.variable("b"), jsat.variable("c")]
    hint = np.array([True, False, False])
    (outcome, reason), _ = _same(vs, lambda e, _m: e.solve_guided(hint))
    assert (outcome, reason) == ("GuidanceUnverified", "rounding-unverified")
    unsat = [jsat.variable("a", jsat.mandatory(), jsat.prohibited())]
    (outcome, reason), _ = _same(unsat, lambda e, _m: e.solve_guided(None))
    assert (outcome, reason) == ("GuidanceUnverified", "baseline-unsat")


# ----------------------------------------------------- cancel and tracing


def test_cancel_set_before_the_solve():
    stop = threading.Event()
    stop.set()
    (outcome, _), _ = _same(version_pinned_chains(6, 2, seed=0),
                                   _solve, cancel=stop)
    assert outcome == "SolveCancelled"


def _backtracking_cases():
    """The conformance cases whose search backtracks."""
    out = []
    for case in CASES:
        eng = jhost.HostEngine(jencode(case.variables))
        try:
            eng.solve()
        except jsat.NotSatisfiable:
            pass
        if eng.backtracks:
            out.append(case.variables)
    assert out, "no conformance case backtracks"
    return out


def test_logging_tracer_transcript_matches():
    for vs in _backtracking_cases():
        bufs = []
        for host, S in ((jhost, jsat), (thost, tsat)):
            buf = io.StringIO()
            p = jencode(vs) if host is jhost else tencode(
                variables_from_objects(vs))
            eng = host.HostEngine(p, tracer=S.LoggingTracer(buf))
            _outcome(p, eng.solve)
            bufs.append(buf.getvalue())
        assert "Assumptions:" in bufs[0]
        assert bufs[1] == bufs[0]


# --------------------------------------------------------- encode_assumed


def _random_catalog(rng, n):
    """A random catalog of every constraint kind (the reference's
    ``test_sessions`` shape)."""
    ids = [f"v{i}" for i in range(n)]
    variables = []
    for i, ident in enumerate(ids):
        cons = []
        others = ids[:i] + ids[i + 1:]
        if rng.random() < 0.15:
            cons.append(jsat.mandatory())
        if rng.random() < 0.05:
            cons.append(jsat.prohibited())
        if others and rng.random() < 0.5:
            cons.append(jsat.dependency(
                *rng.sample(others, min(rng.randint(1, 3), len(others)))))
        if others and rng.random() < 0.25:
            cons.append(jsat.conflict(rng.choice(others)))
        if others and rng.random() < 0.2:
            members = rng.sample(others, min(rng.randint(2, 4), len(others)))
            cons.append(jsat.at_most(rng.randint(1, len(members)), *members))
        variables.append(jsat.variable(ident, *cons))
    return ids, variables


def _assumptions(rng, ids):
    return [("nope" if rng.random() < 0.1 else rng.choice(ids),
             rng.random() < 0.6) for _ in range(rng.randint(0, 6))]


@pytest.mark.parametrize("seed", range(4))
def test_encode_assumed_is_byte_identical(seed):
    rng = random.Random(0x20AD + seed)
    for _ in range(15):
        ids, jvars = _random_catalog(rng, rng.randint(2, 14))
        tvars = variables_from_objects(jvars)
        assumptions = _assumptions(rng, ids)
        jbase, tbase = _problems(jvars)
        before = {k: getattr(tbase, k).copy() for k in TENSORS}
        got = tencode_assumed(tbase, assumptions)
        want = jencode_assumed(jbase, assumptions)
        derived = tencode(tsat.assumed_variables(tvars, assumptions))
        for name in TENSORS:
            g = getattr(got, name)
            assert g.dtype == getattr(want, name).dtype, name
            assert g.tobytes() == getattr(want, name).tobytes(), name
            assert g.tobytes() == getattr(derived, name).tobytes(), name
            assert np.array_equal(getattr(tbase, name), before[name]), name
        assert [str(a) for a in got.applied] == [str(a) for a in want.applied]
        assert [str(a) for a in got.applied] == [
            str(a) for a in derived.applied]
        assert [v.identifier for v in got.variables] == [
            v.identifier for v in want.variables]
        assert got.errors == want.errors == derived.errors
        # The splice points are memoized on the base problem.
        assert ("_assume_cum" in tbase.__dict__) == any(
            a in ids for a, _ in assumptions)
        assert [str(v) for v in tsat.assumed_variables(tvars, assumptions)] \
            == [str(v) for v in jassumed(jvars, assumptions)]


def test_encode_assumed_without_a_delta_returns_the_problem():
    _, jvars = _random_catalog(random.Random(7), 6)
    p = tencode(variables_from_objects(jvars))
    assert tencode_assumed(p, []) is p
    assert tencode_assumed(p, [("nope", True)]) is p


# ---------------------------------------------------------- Solver scopes


def _render(r):
    if isinstance(r, dict):
        return ("sat", sorted(r.items()))
    if type(r).__name__ == "NotSatisfiable":
        return ("unsat", [str(c) for c in r.constraints])
    if type(r).__name__ == "Incomplete":
        return ("incomplete",)
    return ("installed", [v.identifier for v in r])


def _solve_rendered(solver):
    try:
        return _render(solver.solve())
    except (jsat.NotSatisfiable, tsat.NotSatisfiable,
            jsat.Incomplete, tsat.Incomplete) as e:
        return _render(e)


def _solver_script(jvars, seed):
    """A scope script over a catalog: (op, argument) pairs, solving at
    each step."""
    rng = random.Random(seed)
    ids = [v.identifier for v in jvars]
    ops = []
    for _ in range(10):
        r = rng.random()
        if r < 0.5:
            ops.append(("assume", (rng.sample(ids, rng.randint(1, 2)),
                                   rng.random() < 0.7)))
        elif r < 0.8:
            ops.append(("test", None))
        else:
            ops.append(("untest", None))
    return ops


def _run_solver(solver, ops, check_steps):
    trail = []
    for op, arg in ops:
        try:
            if op == "assume":
                solver.assume(*arg[0], installed=arg[1])
                r = None
            else:
                r = getattr(solver, op)()
        except (jsat.InternalSolverError, tsat.InternalSolverError) as e:
            r = str(e)
        stats = {}
        scoped = _render(solver.solve_scoped(stats=stats))
        trail.append((op, r, solver.assumptions(), solver.scope_depth(),
                      solver.scope_state(), scoped, _solve_rendered(solver),
                      (stats["steps"], solver.steps) if check_steps else None))
    return trail


SCOPE_CATALOGS = {
    "operatorhub": lambda: operatorhub_catalog(8, 3, seed=5),
    "gvk": lambda: gvk_conflict_catalog(6, 3, 3, seed=6),
    "random": lambda: random_instance(length=14, seed=7),
}


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("catalog", sorted(SCOPE_CATALOGS))
def test_solver_scopes_match_the_reference(catalog, backend):
    jvars = SCOPE_CATALOGS[catalog]()
    ops = _solver_script(jvars, sorted(SCOPE_CATALOGS).index(catalog))
    host = backend == "host"
    want = _run_solver(jsat.Solver(jvars, backend="host"), ops, host)
    got = _run_solver(tsat.Solver(variables_from_objects(jvars),
                                  backend=backend, device="cpu"), ops, host)
    assert got == want


def test_scoped_solve_leaves_the_base_problem_unchanged():
    jvars = operatorhub_catalog(8, 3, seed=5)
    solver = tsat.Solver(variables_from_objects(jvars), device="cpu")
    before = {k: getattr(solver.problem, k).copy() for k in TENSORS}
    solver.assume("p1.v0")
    solver.assume("p2", installed=False)
    solver.test()
    solver.solve_scoped()
    for k in TENSORS:
        assert np.array_equal(getattr(solver.problem, k), before[k]), k


def test_unsat_assumption_core_names_the_assumption():
    jvars = operatorhub_catalog(8, 3, seed=5)
    for backend in ("host", "device"):
        solver = tsat.Solver(variables_from_objects(jvars), backend=backend,
                             device="cpu")
        solver.assume("p0", installed=False)
        solver.test()
        r = solver.solve_scoped()
        assert isinstance(r, tsat.NotSatisfiable)
        assert "p0 is prohibited" in [str(c) for c in r.constraints]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(20, 220))
def test_solve_fuzz_deep(seed):
    _same(random_instance(length=32, seed=seed), _solve)
