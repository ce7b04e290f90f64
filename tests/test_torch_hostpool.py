"""The port's host worker pool against its inline path and the reference's.

The cases of ``tests/test_hostpool.py`` on the port
(``deppy_tpu_torch.hostpool``): a pool of 2 workers answers every lane
exactly as the inline engine does (outcome, installed indices, core
indices, steps, decisions, propagation rounds, backtracks; tolerance 0),
and both equal the reference's inline path on the same encoded
problems; zero workers, a pool that cannot start and an injected
``hostpool.dispatch`` fault fall back to the inline engine loudly; a
scripted ``hostpool.worker_crash`` retries on a fresh worker; workers
recycle; an expired lane degrades alone.  Then the consumers that now
call ``solve_host_problems`` (the scheduler's host drain,
``BatchResolver``'s host batch, the ``Solver``'s host lane), the
forkserver start, and a fresh process that imports the worker
module and loads neither torch nor jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from deppy_tpu import hostpool as jhostpool
from deppy_tpu.models import random_instance as jrandom_instance
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import hostpool as thostpool
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.hostpool import pool as tpool
from deppy_tpu_torch.models import pinned_tenant_catalog, random_instance
from deppy_tpu_torch.sat.encode import encode as tencode

ROOT = Path(__file__).resolve().parents[1]
WORKERS = 2


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """The port's fault plan and default registry per test, and a
    default pool of :data:`WORKERS` workers that is shut down after."""
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", str(WORKERS))
    prev_plan = tfaults.configure_plan(None)
    prev_reg = ttelemetry.set_default_registry(ttelemetry.Registry())
    yield
    thostpool.shutdown_default_pool()
    ttelemetry.set_default_registry(prev_reg)
    tfaults.configure_plan(prev_plan)


def _fuzz(n, length=48):
    return [tencode(random_instance(length=length, seed=s))
            for s in range(n)]


def _keys(lanes):
    return [r.key() for r in lanes]


def _snap():
    return ttelemetry.default_registry().snapshot()


def _plan(spec):
    tfaults.configure_plan(tfaults.plan_from_spec(json.dumps(spec)))


def _mixed(n):
    """``n`` lanes, SAT and UNSAT: random instances and pinned-tenant
    states (mostly UNSAT)."""
    out = []
    for s in range(n):
        vs = (random_instance(length=32, seed=s) if s % 2
              else pinned_tenant_catalog(seed=s))
        out.append(tencode(vs))
    return out


# ------------------------------------------------- differential identity


def test_inline_matches_the_reference_inline_path():
    """The port's inline lanes equal the reference's on the same
    problems (models, cores, every counter)."""
    tp = _fuzz(8) + _mixed(4)
    jp = [jencode(jrandom_instance(length=48, seed=s)) for s in range(8)]
    from deppy_tpu.models import pinned_tenant_catalog as jpinned

    jp += [jencode(jrandom_instance(length=32, seed=s) if s % 2
                   else jpinned(seed=s)) for s in range(4)]
    assert _keys(thostpool.solve_inline(tp)) == \
        _keys(jhostpool.solve_inline(jp))


@pytest.mark.parametrize("max_steps", [None, 1, 7])
def test_pool_matches_inline(max_steps):
    """Answers, steps and budget exhaustion through 2 workers equal the
    inline engine's; at 1 step every lane is Incomplete."""
    problems = _mixed(10)
    inline = thostpool.solve_inline(problems, max_steps=max_steps)
    if max_steps == 1:
        assert all(r.outcome == "incomplete" for r in inline)
    else:
        assert {r.outcome for r in inline} >= {"sat", "unsat"} or \
            max_steps is not None
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        assert _keys(pool.solve(problems, max_steps=max_steps)) == \
            _keys(inline)
    finally:
        pool.shutdown()
    assert _snap()["deppy_hostpool_lanes_total"] == len(problems)


def test_pool_matches_host_engine_ground_truth():
    """Each lane decodes to what a direct HostEngine run yields."""
    from deppy_tpu_torch.sat.errors import NotSatisfiable
    from deppy_tpu_torch.sat.host import HostEngine

    problems = _mixed(6)
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        lanes = pool.solve(problems)
    finally:
        pool.shutdown()
    for p, lane in zip(problems, lanes):
        eng = HostEngine(p)
        try:
            _, idx = eng.solve()
            assert lane.outcome == "sat" and lane.installed_idx == list(idx)
        except NotSatisfiable as e:
            assert lane.outcome == "unsat"
            assert [p.applied[j] for j in lane.core_idx] == e.constraints
        assert (lane.steps, lane.decisions, lane.propagation_rounds,
                lane.backtracks) == (eng.steps, eng.decisions,
                                     eng.propagation_rounds, eng.backtracks)


def test_per_lane_steps_ride_the_pipe():
    problems = _mixed(6)
    steps = [None, 1, 5, None, 2, 40]
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        got = pool.solve(problems, max_steps=steps)
    finally:
        pool.shutdown()
    assert _keys(got) == _keys(thostpool.solve_inline(problems,
                                                      max_steps=steps))


# -------------------------------------------------------- inline fallback


def test_zero_workers_disables_the_pool(monkeypatch):
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "0")
    assert thostpool.default_pool() is None
    assert thostpool.effective_workers() == 0
    problems = _fuzz(6)
    assert _keys(thostpool.solve_host_problems(problems)) == \
        _keys(thostpool.solve_inline(problems))
    assert "deppy_hostpool_dispatches_total" not in _snap()


def test_worker_count_policy(monkeypatch):
    """An explicit count is honored (1 included); unset, the default is
    min(cpu_count, 8), and an implicit 1 disables the pool."""
    assert thostpool.pool_workers() == WORKERS
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "1")
    assert thostpool.effective_workers() == 1
    monkeypatch.delenv("DEPPY_GPU_HOST_WORKERS")
    monkeypatch.setattr(tpool.os, "cpu_count", lambda: 1)
    assert thostpool.pool_workers() == 1
    assert thostpool.effective_workers() == 0
    monkeypatch.setattr(tpool.os, "cpu_count", lambda: 64)
    assert thostpool.pool_workers() == tpool.DEFAULT_MAX_WORKERS
    thostpool.configure_pool(3)
    try:
        assert thostpool.effective_workers() == 3
    finally:
        thostpool.configure_pool(None)


def test_unavailable_pool_falls_back_inline(monkeypatch):
    """A pool whose workers cannot start (a fork-restricted sandbox) is
    unavailable for good, and its consumers fall back inline, loudly."""
    def refuse(self):
        raise OSError("fork refused")

    monkeypatch.setattr(thostpool.HostPool, "_spawn_locked", refuse)
    pool = thostpool.HostPool(workers=WORKERS)
    problems = _fuzz(6)
    out = thostpool.solve_host_problems(problems, pool=pool)
    assert _keys(out) == _keys(thostpool.solve_inline(problems))
    assert _snap()["deppy_hostpool_inline_fallback_total"] == 1
    assert not pool.available
    with pytest.raises(thostpool.HostPoolError, match="fork refused"):
        pool.solve(problems)


def test_injected_dispatch_fault_falls_back_inline():
    problems = _fuzz(6)
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        _plan([{"point": "hostpool.dispatch", "kind": "error", "times": 1}])
        out = thostpool.solve_host_problems(problems, pool=pool)
        assert _keys(out) == _keys(thostpool.solve_inline(problems))
        snap = _snap()
        assert snap["deppy_hostpool_inline_fallback_total"] == 1
        assert snap["deppy_faults_injected_total"] == \
            {"hostpool.dispatch": 1}
        # The plan is spent: the next batch uses the pool again.
        assert _keys(thostpool.solve_host_problems(problems, pool=pool)) \
            == _keys(out)
        assert _snap()["deppy_hostpool_dispatches_total"] == 1
    finally:
        pool.shutdown()


def test_one_lane_stays_inline():
    (p,) = _fuzz(1)
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        out = thostpool.solve_host_problems([p], pool=pool)
        assert not pool.running
    finally:
        pool.shutdown()
    assert _keys(out) == _keys(thostpool.solve_inline([p]))


def test_workers_start_from_the_forkserver():
    """The workers are children of the forkserver (never forks of this
    process, whose CUDA context they must not inherit): one process
    each, none of them this one."""
    import os

    pool = thostpool.HostPool(workers=WORKERS)
    try:
        problems = _fuzz(4)
        assert _keys(pool.solve(problems)) == \
            _keys(thostpool.solve_inline(problems))
        assert pool._ctx.get_start_method() == "forkserver"
        pids = pool.worker_pids()
        assert len(set(pids)) == WORKERS and os.getpid() not in pids
    finally:
        pool.shutdown()


# --------------------------------------------------------------- faults


def test_worker_crash_retries_on_a_fresh_worker():
    problems = _fuzz(12)
    inline = thostpool.solve_inline(problems)
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        pool.solve(problems[:2])
        before = set(pool.worker_pids())
        _plan([{"point": "hostpool.worker_crash", "kind": "error",
                "times": 1}])
        assert _keys(pool.solve(problems)) == _keys(inline)
        after = set(pool.worker_pids())
    finally:
        pool.shutdown()
    assert before != after
    snap = _snap()
    assert snap["deppy_hostpool_worker_crashes_total"] == 1
    assert snap["deppy_fault_retries"] >= 1


def test_crash_storm_solves_inline():
    """Every chunk's worker crashes: after the retry policy's
    ``max_attempts`` tries each lane is solved inline, and the answers
    still equal the inline path's."""
    problems = _fuzz(4)
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        _plan([{"point": "hostpool.worker_crash", "kind": "error",
                "times": -1}])
        assert _keys(pool.solve(problems)) == \
            _keys(thostpool.solve_inline(problems))
    finally:
        pool.shutdown()
    assert _snap()["deppy_hostpool_worker_crashes_total"] >= \
        tfaults.RetryPolicy.from_env().max_attempts


def test_deadline_expired_lane_cancels_without_poisoning():
    problems = _fuzz(8)
    inline = thostpool.solve_inline(problems)
    dls = [None] * len(problems)
    dls[3] = tfaults.Deadline(0.0)
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        res = pool.solve(problems, deadlines=dls)
    finally:
        pool.shutdown()
    assert res[3].degraded and res[3].outcome == "incomplete"
    assert res[3].steps == 0
    assert [r.key() for i, r in enumerate(res) if i != 3] == \
        [r.key() for i, r in enumerate(inline) if i != 3]


def test_workers_recycle_after_n_solves():
    problems = _fuzz(12, length=24)
    inline = thostpool.solve_inline(problems)
    pool = thostpool.HostPool(workers=1, recycle_after=4)
    try:
        pool.solve(problems[:2])
        before = set(pool.worker_pids())
        assert _keys(pool.solve(problems)) == _keys(inline)
        after = set(pool.worker_pids())
    finally:
        pool.shutdown()
    assert before != after
    assert _snap()["deppy_hostpool_worker_recycles_total"] >= 1


def test_shutdown_is_final():
    pool = thostpool.HostPool(workers=WORKERS)
    pool.solve(_fuzz(2))
    assert len(pool.worker_pids()) == WORKERS
    pool.shutdown()
    pool.shutdown()
    assert not pool.running and not pool.available
    with pytest.raises(thostpool.HostPoolError):
        pool.solve(_fuzz(2))


def test_spans_and_histogram():
    sink_reg = ttelemetry.default_registry()
    pool = thostpool.HostPool(workers=WORKERS)
    try:
        pool.solve(_fuzz(6))
    finally:
        pool.shutdown()
    snap = sink_reg.snapshot()
    assert snap["deppy_hostpool_worker_solve_seconds"]["count"] == 6
    assert snap["deppy_hostpool_dispatches_total"] == 1
    assert any(s["name"] == "hostpool.dispatch"
               for s in sink_reg.recent_spans())
    lines = thostpool.render_metric_lines()
    for name in thostpool.FAMILY_ORDER:
        assert any(name in line for line in lines), name


# ------------------------------------------------------------ consumers


def _rendered(results):
    return [json.dumps(tio.result_to_dict(r), sort_keys=True)
            for r in results]


def test_scheduler_host_drain_uses_the_pool(monkeypatch):
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sched import Scheduler

    states = [pinned_tenant_catalog(seed=s) for s in range(6)]
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "0")
    plain = _rendered(BatchResolver(backend="host").solve(states))
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", str(WORKERS))
    sched = Scheduler(backend="host", max_wait_ms=50.0, cache_size=0)
    sched.start()
    try:
        out = sched.submit(states)
    finally:
        sched.stop()
    assert _rendered(out) == plain
    assert _snap()["deppy_hostpool_lanes_total"] >= len(states)


def test_batch_resolver_host_batch_uses_the_pool():
    from deppy_tpu_torch.resolution import BatchResolver
    from deppy_tpu_torch.sat import mandatory, variable

    problems = [[variable(f"v{i}", mandatory()), variable("w")]
                for i in range(8)]
    resolver = BatchResolver(backend="host")
    out = resolver.solve(problems)
    assert all(r[f"v{i}"] for i, r in enumerate(out))
    assert _snap()["deppy_hostpool_lanes_total"] == 8
    assert resolver.last_report.outcomes["sat"] == 8


def test_solver_host_lane_matches_the_reference():
    """The ``Solver``'s untraced host lane (one lane: inline through the
    shared entry) returns the reference's answer, core and counters."""
    from deppy_tpu import sat as jsat
    from deppy_tpu_torch import sat as tsat

    for build in (lambda m: [m.variable("A", m.mandatory(),
                                        m.dependency("B", "C")),
                             m.variable("B", m.conflict("D")),
                             m.variable("C", m.dependency("D")),
                             m.variable("D")],
                  lambda m: [m.variable("u", m.mandatory(),
                                        m.dependency("v")),
                             m.variable("v", m.prohibited())]):
        js = jsat.Solver(build(jsat), backend="host")
        ts = tsat.Solver(build(tsat), backend="host")
        got = []
        for s in (js, ts):
            try:
                got.append(sorted(v.identifier for v in s.solve()))
            except Exception as e:  # noqa: BLE001 — compared below
                got.append(str(e))
        assert got[0] == got[1]
        assert ts.steps == js.steps
        assert ts.report.outcomes == js.report.outcomes
        assert (ts.report.steps, ts.report.decisions,
                ts.report.propagation_rounds, ts.report.backtracks) == \
            (js.report.steps, js.report.decisions,
             js.report.propagation_rounds, js.report.backtracks)


# ---------------------------------------------------------- isolation


def test_worker_module_loads_neither_torch_nor_jax():
    """A fresh ``import deppy_tpu_torch.hostpool.worker`` (the
    forkserver's preload) leaves torch, jax and deppy_tpu out of
    ``sys.modules``, and so does a pool dispatch from such a process."""
    code = textwrap.dedent("""
        import sys
        import deppy_tpu_torch.hostpool.worker
        from deppy_tpu_torch import hostpool
        from deppy_tpu_torch.models import random_instance
        from deppy_tpu_torch.sat.encode import encode
        pool = hostpool.HostPool(workers=2)
        try:
            out = pool.solve([encode(random_instance(length=16, seed=s))
                              for s in range(4)])
        finally:
            pool.shutdown()
        assert len(out) == 4
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                            "deppy_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
