"""Host-routed giant cores: the port's driver against the JAX driver.

The JAX driver routes the unsat core of an UNSAT problem with more than
``HOST_CORE_NCONS`` applied constraints to ``HostEngine.unsat_core_mask``
(a call with one problem always, a batch only when its UNSAT lanes are
few); the port routes them the same way, through its copy of the host
engine.  Outcome, installed set, unsat core, step count and backtrack
count must match exactly, under a generous budget and under tight ones.
Thresholds are set on the module attributes of both drivers.
"""

from __future__ import annotations

import numpy as np
import pytest

from deppy_tpu import sat as jsat
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import random_instance
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sat.host import HostEngine as JHostEngine
from deppy_tpu_torch import models as tm
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.sat import host as thost
from deppy_tpu_torch.sat.encode import encode as tencode


def _giant_unsat(S, fillers: int = 800):
    """``x0`` mandatory and conflicting with ``x1``, ``x1`` mandatory,
    and ``fillers`` mandatory fillers: 3 + fillers applied constraints,
    the core the first three."""
    vs = [S.variable("x0", S.mandatory(), S.conflict("x1")),
          S.variable("x1", S.mandatory())]
    return vs + [S.variable(f"f{i}", S.mandatory()) for i in range(fillers)]


@pytest.fixture
def host_calls(monkeypatch):
    """Counts the port's host-engine core extractions."""
    calls = []
    real = thost.HostEngine.unsat_core_mask

    def counted(self):
        calls.append(self.p.n_cons)
        return real(self)

    monkeypatch.setattr(thost.HostEngine, "unsat_core_mask", counted)
    return calls


def _lanes_equal(problems, want, got):
    for p, a, b in zip(problems, want, got):
        assert b.outcome == int(a.outcome)
        np.testing.assert_array_equal(b.installed.numpy()[: p.n_vars],
                                      np.asarray(a.installed)[: p.n_vars])
        np.testing.assert_array_equal(b.core.numpy()[: p.n_cons],
                                      np.asarray(a.core)[: p.n_cons])
        assert b.steps == int(a.steps)
        assert b.trace_n == int(a.trace_n)


def test_giant_single_problem_takes_the_host_core(host_calls):
    jp = jencode(_giant_unsat(jsat))
    tp = tencode(_giant_unsat(tsat))
    assert tp.n_cons == 803 > tdriver.HOST_CORE_NCONS
    want = jdriver.solve_problems([jp])
    got = tdriver.solve_problems([tp], device="cpu")
    _lanes_equal([jp], want, got)
    assert got[0].steps == 4
    assert np.flatnonzero(got[0].core.numpy()).tolist() == [0, 1, 2]
    assert host_calls == [803]

    stats = {}
    with pytest.raises(jsat.NotSatisfiable) as jerr:
        jdriver.solve_one(jp, stats=stats)
    solver = tsat.Solver(_giant_unsat(tsat), device="cpu")
    with pytest.raises(tsat.NotSatisfiable) as terr:
        solver.solve()
    assert str(terr.value) == str(jerr.value)
    assert solver.steps == stats["steps"] == 4


def test_host_engine_core_matches_jax_host_engine():
    for s in (0, 3, 4):
        jp = jencode(random_instance(length=24, seed=s, p_mandatory=0.3,
                                     p_conflict=0.3))
        tp = tencode(tm.random_instance(length=24, seed=s, p_mandatory=0.3,
                                        p_conflict=0.3))
        a, b = JHostEngine(jp), thost.HostEngine(tp)
        np.testing.assert_array_equal(b.unsat_core_mask(),
                                      a.unsat_core_mask())
        assert b.steps == a.steps and b.decisions == a.decisions
        assert b.propagation_rounds == a.propagation_rounds


def _batch(seeds_unsat, seeds_sat):
    """A batch of UNSAT (seeds 0, 3, 4, 5, 7, ...) and SAT (1, 2, 6)
    random instances, in both packages."""
    seeds = list(seeds_unsat) + list(seeds_sat)
    kw = dict(length=24, p_mandatory=0.3, p_conflict=0.3)
    return ([jencode(random_instance(seed=s, **kw)) for s in seeds],
            [tencode(tm.random_instance(seed=s, **kw)) for s in seeds])


def test_batch_with_few_unsat_lanes_routes_big_cores_to_host(monkeypatch,
                                                             host_calls):
    """2 of 8 lanes UNSAT: the lane past the threshold goes to the host,
    the other to the core kernel."""
    jp, tp = _batch([0, 5], [1, 2, 6, 1, 2, 6])
    threshold = 18
    assert jp[0].n_cons <= threshold < jp[1].n_cons
    monkeypatch.setattr(jdriver, "HOST_CORE_NCONS", threshold)
    monkeypatch.setattr(tdriver, "HOST_CORE_NCONS", threshold)
    want = jdriver.solve_problems(jp)
    got = tdriver.solve_problems(tp, device="cpu")
    _lanes_equal(jp, want, got)
    assert [int(r.outcome) for r in want[:2]] == [-1, -1]
    assert host_calls == [tp[1].n_cons]


def test_unsat_heavy_batch_keeps_cores_on_device(monkeypatch, host_calls):
    """6 of 8 lanes UNSAT (more than half the lanes): every core stays on
    the device, whatever the threshold."""
    jp, tp = _batch([0, 3, 4, 5, 7, 8], [1, 2])
    monkeypatch.setattr(jdriver, "HOST_CORE_NCONS", 10)
    monkeypatch.setattr(tdriver, "HOST_CORE_NCONS", 10)
    want = jdriver.solve_problems(jp)
    got = tdriver.solve_problems(tp, device="cpu")
    _lanes_equal(jp, want, got)
    assert sum(int(r.outcome) == -1 for r in want) == 6
    assert host_calls == []


@pytest.mark.parametrize("max_steps", [1, 2, 3, 4])
def test_tight_budget_agrees_with_jax(max_steps, host_calls):
    """The host engine gets only the budget its lane has left: the
    Incomplete verdict and the step count follow the reference."""
    jp = jencode(_giant_unsat(jsat))
    tp = tencode(_giant_unsat(tsat))
    want = jdriver.solve_problems([jp], max_steps=max_steps)
    got = tdriver.solve_problems([tp], max_steps=max_steps, device="cpu")
    _lanes_equal([jp], want, got)
    assert (got[0].outcome == 0) == (max_steps < 4)


def test_tight_budget_batch_agrees_with_jax(monkeypatch):
    jp, tp = _batch([0, 5], [1, 2, 6, 1, 2, 6])
    monkeypatch.setattr(jdriver, "HOST_CORE_NCONS", 18)
    monkeypatch.setattr(tdriver, "HOST_CORE_NCONS", 18)
    for max_steps in (6, 30):
        want = jdriver.solve_problems(jp, max_steps=max_steps)
        got = tdriver.solve_problems(tp, max_steps=max_steps, device="cpu")
        _lanes_equal(jp, want, got)
