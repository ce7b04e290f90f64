"""Search tracing on the device backend against the JAX driver.

The same problems go through ``deppy_tpu.engine.driver`` (JAX on the CPU,
the XLA path, which keeps the reference's trace buffer) and through the
port on ``device="cpu"`` (the search kernel's plain version, whose trace
buffer kernel 3 fills on the card): the backtrack count (``trace_n``),
the trace rows, and the positions a tracer receives (assumption stacks,
and the conflicts the host replay gives them), with tolerance 0.  The
instances backtrack (copies of ``tests/test_tracer_backends.py:22-52``,
and a doomed package put ahead of a small ``operatorhub_catalog``).
Every JAX call reuses one compiled program per (shape, trace depth).
"""

from __future__ import annotations

import functools
import io
import warnings

import numpy as np
import pytest

from deppy_tpu import sat as jsat
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import operatorhub_catalog as joperatorhub_catalog
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine import core
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.sat import host as thost
from deppy_tpu_torch.sat.encode import encode as tencode

IMPLS = ("auto", "bits", "watched", "blockwise", "pallas", "gather")


def _doomed(b: str) -> list:
    """``b`` needs one of {x, y} and one of {w, z}, and every cross pair
    conflicts: doomed one guess deeper than propagation sees."""
    return [
        jsat.variable(b, jsat.dependency("x", "y"),
                      jsat.dependency("w", "z")),
        jsat.variable("x", jsat.conflict("w"), jsat.conflict("z")),
        jsat.variable("y", jsat.conflict("w"), jsat.conflict("z")),
        jsat.variable("w"),
        jsat.variable("z"),
    ]


def _backtracking_instance():
    return [
        jsat.variable("a", jsat.mandatory(), jsat.dependency("b", "c")),
        jsat.variable("c"),
    ] + _doomed("b")


def _unsat_instance():
    return [
        jsat.variable("a", jsat.mandatory(), jsat.dependency("b")),
    ] + _doomed("b")


def _doomed_catalog():
    """The doomed package ahead of ``operatorhub_catalog(4, 3)``: the
    search backtracks through the catalog's choices under ``b`` (41
    backtracks) before it falls back to ``c``."""
    return _backtracking_instance() + joperatorhub_catalog(4, 3)


INSTANCES = {"backtrack-sat": _backtracking_instance,
             "exhaust-unsat": _unsat_instance,
             "doomed-catalog": _doomed_catalog}


class _RecordingTracer:
    def __init__(self) -> None:
        self.positions: list = []

    def trace(self, position) -> None:
        self.positions.append((
            [v.identifier for v in position.variables()],
            [str(c) for c in position.conflicts()]))


def _outcome(solve):
    try:
        return ("sat", sorted(v.identifier for v in solve()))
    except (jsat.NotSatisfiable, tsat.NotSatisfiable) as e:
        return ("unsat", sorted(str(c) for c in e.constraints))


def _truncations(caught) -> list:
    """The truncation warnings among ``caught``, as text."""
    return [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)
            and "trace buffer holds" in str(w.message)]


@functools.lru_cache(maxsize=None)
def _reference(name: str, T: int):
    """The JAX driver's trace of one instance at depth ``T``: (outcome,
    positions, backtracks, trace rows, warnings)."""
    jp = jencode(INSTANCES[name]())
    rec = _RecordingTracer()
    stats: dict = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outcome = _outcome(lambda: jdriver.solve_one(
            jp, stats=stats, tracer=rec, trace_cap=T))
    (res,) = jdriver.solve_problems([jp], trace_cap=T)
    return (outcome, rec.positions, stats["backtracks"],
            np.asarray(res.trace_stack), int(res.trace_n),
            _truncations(caught))


def _port(name: str, T: int):
    """The port's trace of the same instance on ``device="cpu"``."""
    vs = variables_from_objects(INSTANCES[name]())
    rec = _RecordingTracer()
    solver = tsat.Solver(vs, tracer=rec, device="cpu", trace_cap=T)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outcome = _outcome(solver.solve)
    (res,) = tdriver.solve_problems([tencode(vs)], device="cpu", trace_cap=T)
    return (outcome, rec.positions, solver.backtracks,
            res.trace_stack.numpy(), res.trace_n, _truncations(caught))


@pytest.mark.parametrize("T", [2, 256])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_trace_matches_reference(name, T):
    """trace_n, the rows, every position and the truncation warning."""
    want = _reference(name, T)
    got = _port(name, T)
    assert want[2] > 2, "instance did not backtrack past T = 2"
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3].shape == want[3].shape == (T, want[3].shape[1])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4] == want[2]
    assert got[5] == want[5]
    assert len(got[5]) == (1 if want[2] > T else 0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(INSTANCES))
def test_trace_under_each_impl(name, impl):
    """The trace does not depend on the BCP impl: every name gives the
    reference's default trace."""
    want = _reference(name, 256)
    core.set_bcp_impl(impl)
    try:
        got = _port(name, 256)
    finally:
        core.set_bcp_impl("auto")
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


def test_batch_trace_rows_match_reference():
    """A batch through both drivers' split paths: lanes that backtrack,
    and lanes whose baseline decides (they never search: -1 rows and 0
    backtracks), each lane's rows and count equal."""
    jvs = [_backtracking_instance(), [jsat.variable("s", jsat.mandatory())],
           _unsat_instance(), _doomed_catalog()]
    T = 8
    want = jdriver.solve_problems([jencode(v) for v in jvs], trace_cap=T)
    got = tdriver.solve_problems(
        [tencode(variables_from_objects(v)) for v in jvs], device="cpu",
        trace_cap=T)
    for a, b in zip(want, got):
        assert b.trace_n == int(a.trace_n)
        np.testing.assert_array_equal(b.trace_stack.numpy(),
                                      np.asarray(a.trace_stack))
    assert got[1].trace_n == 0 and (got[1].trace_stack.numpy() == -1).all()


def test_trace_off_keeps_no_rows():
    """T = 0 (no tracer): an empty buffer, the backtracks still counted."""
    vs = variables_from_objects(_unsat_instance())
    (res,) = tdriver.solve_problems([tencode(vs)], device="cpu")
    assert res.trace_stack.shape[0] == 0
    assert res.trace_n == _reference("exhaust-unsat", 256)[2]


def test_stats_tracer_costs_zero_host_replays(monkeypatch):
    """A stats-only tracer never asks for conflicts, so the device
    backend replays no host Test (tests/test_tracer_backends.py:102-120);
    its count equals the host backend's."""
    calls = {"n": 0}
    real_test = thost.HostEngine._test

    def counting_test(self, *a, **kw):
        calls["n"] += 1
        return real_test(self, *a, **kw)

    vs = variables_from_objects(_unsat_instance())
    host_t = tsat.StatsTracer()
    _outcome(tsat.Solver(vs, tracer=host_t, backend="host").solve)
    monkeypatch.setattr(thost.HostEngine, "_test", counting_test)
    dev_t = tsat.StatsTracer()
    _outcome(tsat.Solver(vs, tracer=dev_t, device="cpu").solve)
    assert dev_t.backtracks > 0
    assert dev_t.backtracks == host_t.backtracks
    assert calls["n"] == 0, "stats-only tracer triggered host replays"


@pytest.mark.parametrize("name", ["backtrack-sat", "exhaust-unsat"])
def test_logging_tracer_transcript_matches_reference(name):
    """The LoggingTracer transcript of the device backend, byte for byte
    the reference tensor backend's."""
    want, got = io.StringIO(), io.StringIO()
    _outcome(jsat.Solver(INSTANCES[name](), backend="tpu",
                         tracer=jsat.LoggingTracer(want)).solve)
    _outcome(tsat.Solver(variables_from_objects(INSTANCES[name]()),
                         device="cpu",
                         tracer=tsat.LoggingTracer(got)).solve)
    assert "---\nAssumptions:\n" in got.getvalue()
    assert got.getvalue() == want.getvalue()


def test_host_and_device_stacks_agree():
    """The device backend's assumption stacks equal the host backend's,
    event for event, and conflicts agree wherever the replay reports any
    (tests/test_tracer_backends.py:84-91)."""
    vs = variables_from_objects(_doomed_catalog())
    host_t, dev_t = _RecordingTracer(), _RecordingTracer()
    h = _outcome(tsat.Solver(vs, tracer=host_t, backend="host").solve)
    d = _outcome(tsat.Solver(vs, tracer=dev_t, device="cpu",
                             trace_cap=1024).solve)
    assert h == d
    assert [p[0] for p in dev_t.positions] == [p[0] for p in host_t.positions]
    for (_, h_conf), (_, d_conf) in zip(host_t.positions, dev_t.positions):
        if d_conf:
            assert d_conf == h_conf


def test_cuda_tracer_raises_without_card(monkeypatch):
    """``Solver(tracer=...)`` builds on the device backend; its solve
    needs the card, and says so, not NotImplementedError."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    solver = tsat.Solver(variables_from_objects(_unsat_instance()),
                         tracer=tsat.StatsTracer())
    assert solver.device == "cuda" and solver.backend == "device"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available") as e:
        solver.solve()
    assert e.type is tdriver.NoDeviceError
