"""The port's whole resolve path on ``device="cpu"`` against the JAX driver.

``BatchResolver.solve`` / ``Solver.solve`` of ``deppy_tpu_torch`` (the
kernels' plain versions on the CPU) against ``deppy_tpu.engine.driver``'s
``solve_batch`` / ``solve_one`` / ``solve_problems``: outcome, installed
set, unsat core, step count and backtrack count, with tolerance 0.  The
data: the reference scenarios of ``tests/test_conformance.py`` and a mixed
batch of the catalog families, every lane at or below the drivers'
``HOST_CORE_NCONS``, so every core comes from the core phase
(``tests/test_torch_host_core.py`` covers the host-routed cores).
"""

from __future__ import annotations

import numpy as np
import pytest
from test_conformance import CASES

from deppy_tpu import sat as jsat
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import (gvk_conflict_catalog, pinned_tenant_catalog,
                              random_instance, version_pinned_chains)
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.resolution import BatchResolver
from deppy_tpu_torch.sat.encode import encode as tencode


def _render(result):
    """A solve's answer as plain data: the installed identifiers, or the
    unsat core as sorted (subject, constraint text) pairs."""
    if isinstance(result, dict):
        return ("sat", sorted(k for k, on in result.items() if on))
    if isinstance(result, (jsat.NotSatisfiable, tsat.NotSatisfiable)):
        return ("unsat", sorted((ac.variable.identifier, str(ac))
                                for ac in result.constraints))
    if isinstance(result, (jsat.Incomplete, tsat.Incomplete)):
        return ("incomplete",)
    return ("sat", sorted(v.identifier for v in result))


def _solve_one(solve):
    try:
        return _render(solve())
    except (jsat.NotSatisfiable, tsat.NotSatisfiable,
            jsat.Incomplete, tsat.Incomplete) as e:
        return _render(e)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_solver_matches_jax_solve_one(case):
    """Solver.solve on the reference scenarios: the same answer and the
    same step and backtrack counts as the JAX driver's solve_one."""
    stats = {}
    want = _solve_one(lambda: jdriver.solve_one(jencode(case.variables),
                                                stats=stats))
    solver = tsat.Solver(variables_from_objects(case.variables), device="cpu")
    got = _solve_one(solver.solve)
    assert got == want
    assert solver.steps == stats["steps"]
    (res,) = tdriver.solve_problems([tencode(variables_from_objects(
        case.variables))], device="cpu")
    assert res.trace_n == stats["backtracks"]


def _mixed_fleet():
    """(JAX variables, port variables) of a mixed catalog batch: large
    enough to be split into several size-class buckets."""
    from deppy_tpu_torch import models as tm

    pairs = []
    for s in range(4):
        pairs.append((gvk_conflict_catalog(8, 3, 4, seed=s),
                      tm.gvk_conflict_catalog(8, 3, 4, seed=s)))
        pairs.append((pinned_tenant_catalog(seed=s),
                      tm.pinned_tenant_catalog(seed=s)))
    for s in range(16):
        pairs.append((version_pinned_chains(6, 3, seed=s),
                      tm.version_pinned_chains(6, 3, seed=s)))
        pairs.append((random_instance(length=12, seed=s),
                      tm.random_instance(length=12, seed=s)))
    return [a for a, _ in pairs], [b for _, b in pairs]


def test_batch_resolver_matches_jax_solve_batch():
    jvars, tvars = _mixed_fleet()
    jp = [jencode(v) for v in jvars]
    assert max(p.n_cons for p in jp) <= jdriver.HOST_CORE_NCONS
    assert len(jdriver.partition_buckets(jp)) > 1
    want = [_render(r) for r in jdriver.solve_batch(jvars)]
    resolver = BatchResolver(device="cpu")
    got = [_render(r) for r in resolver.solve(tvars)]
    assert got == want
    assert {w[0] for w in want} == {"sat", "unsat"}
    # The lanes themselves: outcome, installed mask, core mask, steps and
    # backtracks, problem by problem.
    jres = jdriver.solve_problems(jp)
    tres = tdriver.solve_problems([tencode(v) for v in tvars], device="cpu")
    assert resolver.last_steps == sum(int(r.steps) for r in jres)
    for p, a, b in zip(jp, jres, tres):
        assert b.outcome == int(a.outcome)
        np.testing.assert_array_equal(b.installed.numpy()[: p.n_vars],
                                      np.asarray(a.installed)[: p.n_vars])
        np.testing.assert_array_equal(b.core.numpy()[: p.n_cons],
                                      np.asarray(a.core)[: p.n_cons])
        assert b.steps == int(a.steps)
        assert b.trace_n == int(a.trace_n)


@pytest.mark.parametrize("max_steps", [2, 9, 40])
def test_batch_budget_parity(max_steps):
    """A tight step budget yields the same Incomplete set as the JAX
    driver (the step counts are part of the contract)."""
    jvars = [random_instance(length=16, seed=s, p_mandatory=0.5,
                             p_conflict=0.5, n_conflict=4) for s in range(6)]
    want = [_render(r) for r in jdriver.solve_batch(jvars,
                                                    max_steps=max_steps)]
    got = [_render(r) for r in BatchResolver(
        device="cpu", max_steps=max_steps).solve(
            [variables_from_objects(v) for v in jvars])]
    assert got == want


def test_solve_problems_rejects_encoding_errors():
    p = tencode([tsat.variable("a", tsat.dependency("missing"))])
    if not p.errors:
        pytest.skip("the encoder accepted the unknown identifier")
    with pytest.raises(tsat.InternalSolverError):
        tdriver.solve_problems([p], device="cpu")


def test_tracer_is_a_later_slice():
    """Tracing on the device backend has landed: a tracer is accepted,
    and a search without backtracks calls it no time."""
    tracer = tsat.StatsTracer()
    solver = tsat.Solver([tsat.variable("a", tsat.mandatory())],
                         tracer=tracer, device="cpu")
    assert [v.identifier for v in solver.solve()] == ["a"]
    assert tracer.backtracks == solver.backtracks == 0
