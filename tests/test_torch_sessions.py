"""The port's session tier against the JAX package's.

The reference's ``tests/test_sessions.py`` shapes, on the CPU: the
port's :class:`deppy_tpu_torch.sessions.SessionStore` runs on
``Scheduler(device="cpu")`` (the kernels' plain versions), the
reference's on its JAX scheduler (``backend="tpu"`` on the CPU, its
escalation off).  Every comparison is exact:

  * scoped solves stay out of the shared cache and index, and an open
    scope's ``Solver.solve`` answers for the assumed problem;
  * seeded walks answer byte-identically to the reference's store (the
    ``warm`` flags included) and to the port's one-shot oracle;
  * ``ClauseSetIndex.plan_for_scope`` plans what the reference's plans,
    and nothing under each gate; lazy rows materialize to
    ``problem_rows``;
  * leases, caps, sheds and the ``sessions.op`` fault point;
  * the handoff: export/import, the checksummed snapshot stream, and
    snapshots equal to the reference's and importable from it;
  * the scheduler's session lanes (``immediate`` flushes, the session
    class, planned lanes in the incremental class);
  * no hidden fallback: a dispatch or a card screen that raises reaches
    the op's caller, and the session stays usable.
"""

from __future__ import annotations

import json
import random
import threading
import time

import numpy as np
import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import incremental as jinc
from deppy_tpu import io as jio
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.benchmarks import session as jbench
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.fleet import snapshot as jsnapshot
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu.sessions import SessionStore as JSessionStore
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import incremental as tinc
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import models as tmodels
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine._build import KernelBuildError
from deppy_tpu_torch.fleet import ring as tring
from deppy_tpu_torch.fleet import snapshot as tsnapshot
from deppy_tpu_torch.incremental import ClauseSetIndex, problem_rows
from deppy_tpu_torch.sat.encode import encode as tencode
from deppy_tpu_torch.sat.solver import Solver, assumed_variables
from deppy_tpu_torch.sched import Scheduler
from deppy_tpu_torch.sched import scheduler as tscheduler_mod
from deppy_tpu_torch.sched.cache import MISS, fingerprint
from deppy_tpu_torch.sessions import (SessionError, SessionLost,
                                      SessionShed, SessionStore)
from deppy_tpu_torch.sessions import store as tstore_mod

CATALOG = (12, 4)   # session_catalog: 48 variables, 12 bundle chains
WALK = 12           # steps of the seeded walks


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each package's fault plan and default registry, and the
    reference's breaker, per test; the reference's escalation off."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    monkeypatch.delenv("DEPPY_GPU_INCREMENTAL", raising=False)
    prev_breaker = jfaults.set_default_breaker(jfaults.CircuitBreaker())
    prev_plans = (jfaults.configure_plan(None), tfaults.configure_plan(None))
    prev = (jtelemetry.set_default_registry(jtelemetry.Registry()),
            ttelemetry.set_default_registry(ttelemetry.Registry()))
    yield
    jtelemetry.set_default_registry(prev[0])
    ttelemetry.set_default_registry(prev[1])
    jfaults.configure_plan(prev_plans[0])
    tfaults.configure_plan(prev_plans[1])
    jfaults.set_default_breaker(prev_breaker)


# --------------------------------------------------------------- helpers


def _catalog_doc(name: str = "s", bundles: int = 3, size: int = 4) -> dict:
    """The reference suite's small multi-bundle catalog
    (``tests/test_sessions.py:67-83``): bundle 0 mandatory, the others
    optional chains whose dependencies cross bundles."""
    variables = []
    for b in range(bundles):
        for j in range(size):
            cons = []
            if j == 0 and b == 0:
                cons.append({"type": "mandatory"})
            if j < size - 1:
                cons.append({"type": "dependency",
                             "ids": [f"{name}b{b}v{j + 1}",
                                     f"{name}b{(b + 1) % bundles}v{j + 1}"]})
            variables.append({"id": f"{name}b{b}v{j}",
                              "constraints": cons})
    return {"variables": variables}


def _oracle(sched, variables, assumptions) -> dict:
    """The one-shot cold answer for the ASSUMED problem, rendered."""
    [r] = sched.submit([assumed_variables(variables, assumptions)])
    return tio.result_to_dict(r)


def _cold_oracle():
    return Scheduler(device="cpu", incremental="off", portfolio="off",
                     registry=ttelemetry.Registry())


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.fixture
def sched():
    s = Scheduler(device="cpu", registry=ttelemetry.Registry())
    yield s
    s.stop()


@pytest.fixture
def store(sched):
    st = SessionStore(sched, metrics=ttelemetry.Registry(),
                      sweep_interval_s=3600.0)
    yield st
    st.stop()


def _pair(incremental: str = "on"):
    """(reference scheduler, its store, port scheduler, its store)."""
    js = JScheduler(backend="tpu", incremental=incremental,
                    portfolio="off", speculate="off",
                    registry=jtelemetry.Registry())
    ts = Scheduler(device="cpu", incremental=incremental,
                   registry=ttelemetry.Registry())
    jst = JSessionStore(js, metrics=jtelemetry.Registry(),
                        sweep_interval_s=3600.0)
    tst = SessionStore(ts, metrics=ttelemetry.Registry(),
                       sweep_interval_s=3600.0)
    return js, jst, ts, tst


def _stop(*stores):
    for st in stores:
        st.stop()


# ----------------------------------------------------- the workload copy


def test_session_generators_equal_reference():
    assert tmodels.session_catalog(*CATALOG) == \
        jbench.session_catalog(*CATALOG)
    assert tmodels.session_catalog(96, 8) == jbench.session_catalog(96, 8)
    assert tmodels.walk_steps(96, 8, 48) == jbench.walk_steps(96, 8, 48)
    walk = tmodels.walk_steps(*CATALOG, 20)
    doc = tmodels.session_catalog(*CATALOG)
    assert tmodels.derived_doc(doc, walk) == jbench.derived_doc(doc, walk)


def test_affinity_key_equals_reference():
    from deppy_tpu.fleet.ring import affinity_key as jkey

    for ids in ([], ["a"], ["a", "bc"], ["ab", "c"], ["xé", "y"]):
        assert tring.affinity_key(ids) == jkey(ids)


# ------------------------------------------------- scoped-solve isolation


class TestScopedSolveIsolation:
    def test_scoped_solve_never_admitted_to_shared_caches(self, sched):
        variables = tio.problem_from_dict(_catalog_doc("iso"))
        solver = Solver(variables, device="cpu", scheduler=sched)
        solver.assume("isob1v0")
        assert solver.test() in (1, 0)
        r = solver.solve_scoped()
        assert isinstance(r, dict) and r["isob1v0"]
        derived = tencode(assumed_variables(variables, [("isob1v0", True)]))
        key = fingerprint(derived)
        hit, _ = sched.cache.lookup_or_plan(
            derived, key, int(tdriver._budget(sched.max_steps)))
        assert hit is MISS
        assert len(sched.cache) == 0
        assert all(e.key != key and not e.key.startswith("scope:")
                   for e in sched.incremental.export_entries())
        solver.untest()

    def test_unscoped_solve_still_admitted(self, sched):
        variables = tio.problem_from_dict(_catalog_doc("adm"))
        [_] = sched.submit([variables])
        p = tencode(variables)
        hit, _ = sched.cache.lookup_or_plan(
            p, fingerprint(p), int(tdriver._budget(sched.max_steps)))
        assert hit is not MISS

    def test_facade_solve_respects_open_assumptions(self, sched):
        """``solve()`` under an open scope answers for the ASSUMED
        problem, through the scheduler and without one."""
        variables = tio.problem_from_dict(_catalog_doc("fac"))
        for s in (Solver(variables, device="cpu", scheduler=sched),
                  Solver(variables, device="cpu")):
            s.assume("facb2v0")
            s.test()
            assert "facb2v0" in {v.identifier for v in s.solve()}
            s.untest()
            assert "facb2v0" not in {v.identifier for v in s.solve()}

    def test_unsat_strings_match_oneshot_and_reference(self, sched):
        variables = tio.problem_from_dict(_catalog_doc("uns"))
        stack = [("unsb1v1", True), ("unsb1v1", False)]
        solver = Solver(variables, device="cpu", scheduler=sched)
        for ident, installed in stack:
            solver.assume(ident, installed=installed)
        got = tio.result_to_dict(solver.solve_scoped())
        assert got == _oracle(_cold_oracle(), variables, stack)
        assert got["status"] == "unsat"
        from deppy_tpu.sat.solver import Solver as JSolver

        js = JScheduler(backend="host", portfolio="off", speculate="off",
                        registry=jtelemetry.Registry())
        jsolver = JSolver(jio.problem_from_dict(_catalog_doc("uns")),
                          scheduler=js)
        for ident, installed in stack:
            jsolver.assume(ident, installed=installed)
        assert _dumps(jio.result_to_dict(jsolver.solve_scoped())) == \
            _dumps(got)

    def test_scope_keys_and_seeds_equal_reference(self, sched):
        from deppy_tpu.sat.solver import Solver as JSolver

        doc = _catalog_doc("key")
        t = Solver(tio.problem_from_dict(doc), device="cpu",
                   scheduler=sched)
        j = JSolver(jio.problem_from_dict(doc))
        for ops in ([("keyb1v0", True)], [("keyb2v1", False)],
                    [("keyb1v0", False)]):
            for ident, installed in ops:
                t.assume(ident, installed=installed)
                j.assume(ident, installed=installed)
            assert t._scope_plan_args(t.assumptions()) == \
                j._scope_plan_args(j.assumptions())
            t.solve_scoped()
            j._scope_last = (j._scope_key(j.assumptions()),
                             list(j.assumptions()))
            assert t._scope_last == j._scope_last

    def test_solver_without_scheduler_keeps_its_backend(self, monkeypatch):
        """Without a scheduler a scoped solve runs on the configured
        backend: the device path on ``device``."""
        variables = tio.problem_from_dict(_catalog_doc("bk"))
        seen = []
        orig = tdriver.solve_one

        def spy(problem, *a, **k):
            seen.append(k.get("device"))
            return orig(problem, *a, **k)

        monkeypatch.setattr(tdriver, "solve_one", spy)
        s = Solver(variables, device="cpu")
        s.assume("bkb1v0")
        st: dict = {}
        r = s.solve_scoped(deadline_s=5.0, stats=st)
        assert seen == ["cpu"] and r["bkb1v0"] and st["steps"] == s.steps


# ------------------------------------------------- seeded walks vs the reference


def _script(seed: int, idents, n_ops: int):
    """A random assume/test/untest/resolve/explain script (the
    reference's fuzz shape)."""
    rng = random.Random(0xD9 + seed)
    ops = []
    for _ in range(n_ops):
        op = rng.choice(["assume", "assume", "test", "untest", "resolve",
                         "explain"])
        if op == "assume":
            ops.append({"op": "assume", "identifiers": [rng.choice(idents)],
                        "installed": rng.random() < 0.7})
        else:
            ops.append({"op": op})
    return ops


def _drive(store, sid, ops):
    """Each op's output (or the error type it raised)."""
    out = []
    for op in ops:
        try:
            out.append(store.op(sid, op))
        except (SessionError, ValueError) as e:
            out.append({"error": type(e).__name__})
    return out


def _walk_ops(bundles: int, size: int, steps: int):
    """The benchmark's walk as ops: assume then resolve a step, and every
    fourth step test, a contradicting pin, explain, untest."""
    ops = []
    for i, (ident, installed) in enumerate(
            tmodels.walk_steps(bundles, size, steps)):
        ops += [{"op": "assume", "identifiers": [ident],
                 "installed": installed}, {"op": "resolve"}]
        if i % 4 == 3:
            ops += [{"op": "test"},
                    {"op": "assume", "identifiers": [ident],
                     "installed": not installed},
                    {"op": "explain"}, {"op": "untest"}]
    return ops


def _check_walk(ops, want, got, doc):
    """Every output equals the reference's byte for byte (``warm``
    included), and every solve the port's one-shot oracle."""
    assert [_dumps(o) for o in got] == [_dumps(o) for o in want]
    variables = tio.problem_from_dict(doc)
    oracle = _cold_oracle()
    stack, scopes, base = [], [], 0
    solves = warm = 0
    for op, out in zip(ops, got):
        if "error" in out:
            continue
        if op["op"] == "assume":
            stack.append((op["identifiers"][0], op["installed"]))
        elif op["op"] == "test":
            scopes.append(base)
            base = len(stack)
        elif op["op"] == "untest":
            base = scopes.pop()
            del stack[base:]
        else:
            assert out["result"] == _oracle(oracle, variables, stack)
            solves += 1
            warm += bool(out.get("warm"))
    return solves, warm


def test_walk_equals_reference_and_oracle():
    """The benchmark's walk through both stores: outputs byte-equal,
    ``warm`` flags equal, answers equal to the one-shot oracle; most
    steps are served warm and the explains are UNSAT."""
    doc = tmodels.session_catalog(*CATALOG)
    ops = _walk_ops(*CATALOG, WALK)
    js, jst, ts, tst = _pair()
    try:
        want = _drive(jst, jst.create(doc)["id"], ops)
        got = _drive(tst, tst.create(doc)["id"], ops)
    finally:
        _stop(jst, tst)
    solves, warm = _check_walk(ops, want, got, doc)
    assert solves == WALK + WALK // 4
    assert warm >= WALK - 1
    assert [o["result"]["status"] for o in got if o["op"] == "explain"] \
        == ["unsat"] * (WALK // 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_scripts_equal_reference_and_oracle(seed):
    doc = _catalog_doc("fz", 3, 4)
    idents = [v["id"] for v in doc["variables"]]
    ops = _script(seed, idents, 14)
    js, jst, ts, tst = _pair()
    try:
        want = _drive(jst, jst.create(doc)["id"], ops)
        got = _drive(tst, tst.create(doc)["id"], ops)
    finally:
        _stop(jst, tst)
    _check_walk(ops, want, got, doc)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(2, 14))
def test_fuzz_scripts_equal_reference_and_oracle_deep(seed):
    doc = _catalog_doc("fz", 3, 4)
    idents = [v["id"] for v in doc["variables"]]
    ops = _script(seed, idents, 24)
    js, jst, ts, tst = _pair()
    try:
        want = _drive(jst, jst.create(doc)["id"], ops)
        got = _drive(tst, tst.create(doc)["id"], ops)
    finally:
        _stop(jst, tst)
    _check_walk(ops, want, got, doc)


def test_repeat_resolve_warm_identical(sched, store):
    sid = store.create(_catalog_doc("wm"))["id"]
    store.op(sid, {"op": "assume", "identifiers": ["wmb1v0"]})
    first = store.op(sid, {"op": "resolve"})
    again = store.op(sid, {"op": "resolve"})
    assert "warm" not in first and again["warm"] is True
    assert first["result"] == again["result"] == _oracle(
        _cold_oracle(), tio.problem_from_dict(_catalog_doc("wm")),
        [("wmb1v0", True)])


def test_sessions_on_the_host_backend_equal_reference():
    """``Scheduler(backend="host")`` against the reference's host
    scheduler: the same outputs."""
    doc = tmodels.session_catalog(*CATALOG)
    ops = _walk_ops(*CATALOG, 8)
    js = JScheduler(backend="host", portfolio="off", speculate="off",
                    registry=jtelemetry.Registry())
    ts = Scheduler(backend="host", registry=ttelemetry.Registry())
    jst = JSessionStore(js, metrics=jtelemetry.Registry(),
                        sweep_interval_s=3600.0)
    tst = SessionStore(ts, metrics=ttelemetry.Registry(),
                       sweep_interval_s=3600.0)
    try:
        want = _drive(jst, jst.create(doc)["id"], ops)
        got = _drive(tst, tst.create(doc)["id"], ops)
    finally:
        _stop(jst, tst)
    _check_walk(ops, want, got, doc)


# ------------------------------------------------------ plan_for_scope


def _seeded_indexes(stack, **kw):
    """Both packages' indexes holding the cold model of ``stack``'s
    problem on ``session_catalog``, keyed as a session would key it:
    (reference index, port index, reference entry key)."""
    from deppy_tpu.sat.host import HostEngine as JHostEngine

    doc = tmodels.session_catalog(*CATALOG)
    jp = jencode(jio.problem_from_dict(jbench.derived_doc(doc, stack)))
    tp = tencode(tio.problem_from_dict(tmodels.derived_doc(doc, stack)))
    eng = JHostEngine(jp)
    installed, _ = eng.solve()
    model = np.zeros(jp.n_vars, bool)
    model[[jp.id_to_index[v.identifier] for v in installed]] = True
    key = "scope:" + "0" * 64
    jidx = jinc.ClauseSetIndex(registry=jtelemetry.Registry(), **kw)
    tidx = ClauseSetIndex(registry=ttelemetry.Registry(), **kw)
    jidx.store(key, jp, model, eng.steps, eng.backtracks, lazy_rows=True)
    tidx.store(key, tp, model, eng.steps, eng.backtracks, lazy_rows=True)
    return jidx, tidx, key


def _next(stack):
    doc = tmodels.session_catalog(*CATALOG)
    jp = jencode(jio.problem_from_dict(jbench.derived_doc(doc, stack)))
    tp = tencode(tio.problem_from_dict(tmodels.derived_doc(doc, stack)))
    seed = sorted({tp.id_to_index[stack[-1][0]]})
    return jp, tp, seed


def _same_plan(jplan, tplan):
    assert (jplan is None) == (tplan is None)
    if jplan is None:
        return
    assert tplan.klass == jplan.klass == tinc.DELTA_SCOPED
    assert np.array_equal(tplan.cone, jplan.cone)
    assert tplan.cone_fraction == jplan.cone_fraction
    assert np.array_equal(tplan.warm_assign, jplan.warm_assign)
    assert (tplan.entry_key, tplan.entry_steps) == \
        (jplan.entry_key, jplan.entry_steps)


BUDGET = 1 << 20


@pytest.mark.parametrize("last", [("b3v0", True), ("b3v2", False),
                                  ("b1v0", False)])
def test_plan_for_scope_equals_reference(last):
    stack = [("b1v0", True), ("b2v1", False)]
    jidx, tidx, key = _seeded_indexes(stack)
    jp, tp, seed = _next(stack + [last])
    jplan = jidx.plan_for_scope(jp, "k2", BUDGET, key, seed)
    tplan = tidx.plan_for_scope(tp, "k2", BUDGET, key, seed)
    _same_plan(jplan, tplan)
    assert tplan is not None and 0 < tplan.cone.sum() <= 4


@pytest.mark.parametrize("gate", ["no-entry", "vocab", "cone", "budget",
                                  "capacity"])
def test_plan_for_scope_gates_equal_reference(gate):
    kw = {"max_delta_ratio": 0.01} if gate == "cone" else \
        {"capacity": 0} if gate == "capacity" else {}
    stack = [("b1v0", True)]
    jidx, tidx, key = _seeded_indexes(stack, **kw)
    jp, tp, seed = _next(stack + [("b4v1", True)])
    entry, budget = key, BUDGET
    if gate == "no-entry":
        entry = "scope:missing"
    elif gate == "budget":
        budget = 64
    elif gate == "vocab":
        other = _catalog_doc("voc")
        jp = jencode(jio.problem_from_dict(other))
        tp = tencode(tio.problem_from_dict(other))
        seed = [0]
    jplan = jidx.plan_for_scope(jp, "k2", budget, entry, seed)
    tplan = tidx.plan_for_scope(tp, "k2", budget, entry, seed)
    assert jplan is None and tplan is None


def test_plan_for_scope_accounting():
    stack = [("b1v0", True)]
    _, tidx, key = _seeded_indexes(stack)
    spans = []
    tidx._registry.add_forwarder(
        lambda e: spans.append(e) if e.get("name") == "incremental.delta"
        else None)
    jp, tp, seed = _next(stack + [("b2v0", True)])
    assert tidx.plan_for_scope(tp, "k2", BUDGET, key, seed) is not None
    assert tidx.plan_for_scope(tp, "k3", BUDGET, "nope", seed) is None
    snap = tidx._registry.snapshot()
    assert snap["deppy_incremental_delta_total"] == {"scoped": 1, "none": 1}
    assert [(e["attrs"]["klass"], e["attrs"]["cone"]) for e in spans] == \
        [("scoped", 4), ("none", 0)]


def test_lazy_rows_materialize_to_problem_rows():
    stack = [("b1v0", True)]
    _, tidx, key = _seeded_indexes(stack)
    (entry,) = tidx.export_entries()
    assert entry._rows is None and entry._problem is not None
    doc = tmodels.session_catalog(*CATALOG)
    want = problem_rows(tencode(tio.problem_from_dict(
        tmodels.derived_doc(doc, stack))))
    assert entry.rows == want
    assert entry._rows is not None and entry._problem is None
    # The generic classifier reads the materialized rows.
    jp, tp, _ = _next(stack + [("b2v0", True)])
    assert tidx.plan(tp, "k2", BUDGET) is not None


def test_import_entry_gates_equal_reference():
    _, tidx, key = _seeded_indexes([("b1v0", True)])
    (entry,) = tidx.export_entries()
    fresh = ClauseSetIndex(capacity=1, registry=ttelemetry.Registry())
    args = (entry.rows, entry.vocab, entry.model, entry.steps)
    assert fresh.import_entry(key, *args, 0) is True
    assert fresh.import_entry(key, *args, 0) is False     # live wins
    assert fresh.import_entry("k2", *args, 3) is False    # not a seed
    with pytest.raises(ValueError):
        fresh.import_entry("k3", entry.rows, entry.vocab,
                           entry.model[:-1], entry.steps, 0)
    assert fresh.import_entry("k4", *args, 0) is True     # evicts key
    assert [e.key for e in fresh.export_entries()] == ["k4"]


# -------------------------------------------------------------- lifecycle


class TestLifecycle:
    def test_defaults_are_the_reference_limits(self, sched):
        st = SessionStore(sched, metrics=ttelemetry.Registry())
        try:
            assert (st.lease_s, st.max_sessions, st.max_per_tenant) == \
                (300.0, 256, 64)
        finally:
            st.stop()

    def test_solver_follows_the_scheduler(self, store):
        sid = store.create(_catalog_doc("dv"))["id"]
        solver = store._sessions[sid].solver
        assert (solver.device, solver.backend, solver.scheduler) == \
            ("cpu", "device", store.scheduler)
        assert store._sessions[sid].index.capacity == \
            tstore_mod.SESSION_INDEX_CAPACITY == 4

    def test_lease_expiry_lazy_and_sweeper(self, sched):
        reg = ttelemetry.Registry()
        st = SessionStore(sched, metrics=reg, lease_s=0.05,
                          sweep_interval_s=3600.0)
        try:
            sid = st.create(_catalog_doc("lz"))["id"]
            assert st.active() == 1
            time.sleep(0.08)
            with pytest.raises(SessionLost):
                st.op(sid, {"op": "test"})
            assert st.active() == 0
            st.create(_catalog_doc("lz2"))
            time.sleep(0.08)
            assert st.sweep() == 1
            assert st.active() == 0
            assert reg.snapshot()["deppy_session_expired_total"] == 2
        finally:
            st.stop()

    def test_background_sweeper_expires(self, sched):
        st = SessionStore(sched, metrics=ttelemetry.Registry(),
                          lease_s=0.05, sweep_interval_s=0.02)
        try:
            st.create(_catalog_doc("bg"))
            deadline = time.monotonic() + 5.0
            while st.active() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert st.active() == 0
        finally:
            st.stop()
        assert not st._sweeper.is_alive()

    def test_ops_renew_the_lease(self, sched):
        st = SessionStore(sched, metrics=ttelemetry.Registry(),
                          lease_s=0.25, sweep_interval_s=3600.0)
        try:
            sid = st.create(_catalog_doc("rn"))["id"]
            for _ in range(4):
                time.sleep(0.1)
                st.op(sid, {"op": "test"})
                st.op(sid, {"op": "untest"})
            assert st.active() == 1
        finally:
            st.stop()

    def test_per_tenant_cap_sheds_counted(self, sched):
        reg = ttelemetry.Registry()
        st = SessionStore(sched, metrics=reg, max_per_tenant=2,
                          sweep_interval_s=3600.0)
        try:
            st.create(_catalog_doc("t1"), tenant="acme")
            st.create(_catalog_doc("t2"), tenant="acme")
            with pytest.raises(SessionShed) as e:
                st.create(_catalog_doc("t3"), tenant="acme")
            assert e.value.scope == "tenant"
            st.create(_catalog_doc("t4"), tenant="other")
            page = reg.render()
            assert 'deppy_session_evictions_total{reason="shed"} 1' in page
            assert "deppy_session_active 3" in page
            assert st.stats()["tenants"] == {"acme": 2, "other": 1}
        finally:
            st.stop()

    def test_cap_evicts_expired_before_shedding(self, sched):
        reg = ttelemetry.Registry()
        st = SessionStore(sched, metrics=reg, lease_s=0.05,
                          max_sessions=1, sweep_interval_s=3600.0)
        try:
            st.create(_catalog_doc("ev"))
            time.sleep(0.08)
            st.create(_catalog_doc("ev2"))
            assert st.active() == 1
            assert ('deppy_session_evictions_total'
                    '{reason="cap_expired"} 1') in reg.render()
        finally:
            st.stop()

    def test_live_sessions_never_evicted(self, sched):
        reg = ttelemetry.Registry()
        st = SessionStore(sched, metrics=reg, max_sessions=1,
                          sweep_interval_s=3600.0)
        try:
            sid = st.create(_catalog_doc("lv"))["id"]
            with pytest.raises(SessionShed) as e:
                st.create(_catalog_doc("lv2"))
            assert e.value.scope == "global"
            st.op(sid, {"op": "test"})
            st.op(sid, {"op": "untest"})
            assert 'deppy_session_evictions_total{reason="shed"} 1' in \
                reg.render()
        finally:
            st.stop()

    def test_malformed_ops_and_catalogs(self, store):
        sid = store.create(_catalog_doc("mf"))["id"]
        for doc in ("resolve", {"op": "zz"},
                    {"op": "assume", "identifiers": []},
                    {"op": "assume", "identifiers": ["mfb0v0"],
                     "installed": "yes"},
                    {"op": "assume", "identifiers": ["nope"]},
                    {"op": "untest"}):
            with pytest.raises(SessionError):
                store.op(sid, doc)
        with pytest.raises(SessionLost):
            store.op("deadbeef", {"op": "test"})
        from deppy_tpu_torch.sat.errors import InternalSolverError

        with pytest.raises(InternalSolverError):
            store.create({"variables": [
                {"id": "a", "constraints": [
                    {"type": "dependency", "ids": ["missing"]}]}]})

    def test_metric_families_and_span(self, sched):
        reg = ttelemetry.Registry()
        st = SessionStore(sched, metrics=reg, sweep_interval_s=3600.0)
        spans = []
        ttelemetry.default_registry().add_forwarder(
            lambda e: spans.append(e) if e.get("name") == "session.op"
            else None)
        try:
            sid = st.create(_catalog_doc("mt"), tenant="acme")["id"]
            st.op(sid, {"op": "assume", "identifiers": ["mtb1v0"]})
            st.op(sid, {"op": "resolve"})
        finally:
            st.stop()
        snap = reg.snapshot()
        assert snap["deppy_session_ops_total"] == {
            "assume": 1, "test": 0, "untest": 0, "resolve": 1,
            "explain": 0}
        assert snap["deppy_session_active"] == 1
        assert [e["attrs"] for e in spans] == [
            {"op": "assume", "session": sid, "tenant": "acme"},
            {"op": "resolve", "session": sid, "tenant": "acme"}]

    def test_chaos_fault_point(self, store):
        import importlib

        tinject = importlib.import_module("deppy_tpu_torch.faults.inject")
        assert "sessions.op" in tinject.KNOWN_POINTS
        assert "sessions.op" not in tinject.NOT_YET_CALLED
        sid = store.create(_catalog_doc("ch"))["id"]
        tfaults.configure_plan(tfaults.FaultPlan.from_doc(
            [{"point": "sessions.op", "times": 1}]))
        with pytest.raises(tfaults.InjectedFault):
            store.op(sid, {"op": "test"})
        assert store.op(sid, {"op": "test"})["op"] == "test"


# ---------------------------------------------------------------- handoff


def _scripted(store, name="ho"):
    sid = store.create(_catalog_doc(name), tenant="acme")["id"]
    store.op(sid, {"op": "assume", "identifiers": [f"{name}b1v0"]})
    store.op(sid, {"op": "test"})
    store.op(sid, {"op": "assume", "identifiers": [f"{name}b2v1"],
                   "installed": False})
    return sid, store.op(sid, {"op": "resolve"})


class TestHandoff:
    def test_export_import_round_trip(self, sched, store):
        sid, answer = _scripted(store)
        entries = store.export_entries()
        assert len(entries) == 1 and entries[0]["id"] == sid
        assert entries[0]["affinity"] == store._sessions[sid].key
        inheritor = SessionStore(sched, metrics=ttelemetry.Registry(),
                                 sweep_interval_s=3600.0)
        try:
            assert inheritor.import_entry(entries[0]) is True
            assert inheritor._sessions[sid].solver.scope_state() == \
                store._sessions[sid].solver.scope_state()
            out = inheritor.op(sid, {"op": "resolve"})
            assert out["result"] == answer["result"]
            assert out["warm"] is True  # from the imported private index
            assert inheritor.op(sid, {"op": "untest"})["depth"] == 0
        finally:
            inheritor.stop()

    def test_import_live_wins_and_rejects_garbage(self, store):
        sid, _ = _scripted(store)
        [entry] = store.export_entries()
        assert store.import_entry(entry) is False
        assert store.import_entry({"id": "x"}) is False
        assert store.import_entry(dict(entry, id="dead",
                                       lease_remaining_s=0.0)) is False
        assert store.import_entry(dict(entry, id="bs",
                                       scope_base=999)) is False
        poisoned = dict(entry, id="pz", index=[{"key": "k"}])
        assert store.import_entry(poisoned) is True  # warmth lost only
        assert store.active() == 2

    def test_sessions_ride_snapshot_stream_checksummed(self, sched, store):
        _scripted(store)
        doc = tsnapshot.export_warm_state(sched, sessions=store)
        assert len(doc["sessions"]) == 1
        tsnapshot.verify_snapshot(json.loads(json.dumps(doc)))
        for field, value in (("tenant", "mallory"), ("ops", 99)):
            tampered = json.loads(json.dumps(doc))
            tampered["sessions"][0][field] = value
            with pytest.raises(tsnapshot.SnapshotFormatError):
                tsnapshot.verify_snapshot(tampered)
        for bad in ([], {"version": 2}, dict(doc, sessions={})):
            with pytest.raises(tsnapshot.SnapshotFormatError):
                tsnapshot.verify_snapshot(bad)
        inheritor = SessionStore(sched, metrics=ttelemetry.Registry(),
                                 sweep_interval_s=3600.0)
        try:
            out = tsnapshot.import_warm_state(
                Scheduler(device="cpu", registry=ttelemetry.Registry()),
                doc, sessions=inheritor)
            assert (out["sessions_imported"], out["sessions_skipped"]) == \
                (1, 0)
            assert inheritor.active() == 1
            out = tsnapshot.import_warm_state(sched, doc)
            assert (out["sessions_imported"], out["sessions_skipped"]) == \
                (0, 1)
        finally:
            inheritor.stop()

    def test_sessionless_snapshot_byte_identical_to_reference(self):
        js, jst, ts, tst = _pair()
        try:
            for s, io in ((js, jio), (ts, tio)):
                s.submit([io.problem_from_dict(_catalog_doc("sl"))])
                s.submit([io.problem_from_dict(_catalog_doc("sm", 4, 3))])
            jdoc = jsnapshot.export_warm_state(js)
            tdoc = tsnapshot.export_warm_state(ts)
        finally:
            _stop(jst, tst)
        assert "sessions" not in tdoc
        assert len(tdoc["index"]) == 2 and len(tdoc["cache"]) == 2
        assert json.dumps(tdoc) == json.dumps(jdoc)
        out = tsnapshot.import_warm_state(
            Scheduler(device="cpu", registry=ttelemetry.Registry()), jdoc)
        assert out == {"index_imported": 2, "index_skipped": 0,
                       "cache_seeds": 2}

    def test_export_document_equals_reference(self, monkeypatch):
        """The same stateless solves and session ops on both sides: the
        documents are equal byte for byte, checksum included (the
        session ids fixed and the leases' remaining seconds set equal,
        since both are a run's own)."""
        import secrets

        monkeypatch.setattr(secrets, "token_hex", lambda n=12: "ab" * n)
        doc = tmodels.session_catalog(*CATALOG)
        ops = _walk_ops(*CATALOG, 4)
        js, jst, ts, tst = _pair()
        try:
            for s, io in ((js, jio), (ts, tio)):
                s.submit([io.problem_from_dict(doc)])
                s.submit([io.problem_from_dict(tmodels.derived_doc(
                    doc, [("b5v0", True)]))])
            _drive(jst, jst.create(doc, tenant="acme")["id"], ops)
            _drive(tst, tst.create(doc, tenant="acme")["id"], ops)
            jdoc = jsnapshot.export_warm_state(js, sessions=jst)
            tdoc = tsnapshot.export_warm_state(ts, sessions=tst)
        finally:
            _stop(jst, tst)
        for d in (jdoc, tdoc):
            d["sessions"][0]["lease_remaining_s"] = 1.0
        jdoc = jsnapshot._seal(jdoc["index"], jdoc["cache"],
                               sessions=jdoc["sessions"])
        tdoc = tsnapshot._seal(tdoc["index"], tdoc["cache"],
                               sessions=tdoc["sessions"])
        assert len(tdoc["sessions"][0]["index"]) >= 1
        assert json.dumps(tdoc) == json.dumps(jdoc)
        assert tdoc["checksum"] == jdoc["checksum"]

    def test_reference_snapshot_imports_and_serves_warm(self):
        js = JScheduler(backend="host", portfolio="off", speculate="off",
                        registry=jtelemetry.Registry())
        jst = JSessionStore(js, metrics=jtelemetry.Registry(),
                            sweep_interval_s=3600.0)
        doc = tmodels.session_catalog(*CATALOG)
        try:
            sid = jst.create(doc)["id"]
            for op in _walk_ops(*CATALOG, 3):
                jst.op(sid, op)
            snap = json.loads(json.dumps(
                jsnapshot.export_warm_state(js, sessions=jst)))
        finally:
            jst.stop()
        ts = Scheduler(device="cpu", registry=ttelemetry.Registry())
        tst = SessionStore(ts, metrics=ttelemetry.Registry(),
                           sweep_interval_s=3600.0)
        try:
            out = tsnapshot.import_warm_state(ts, snap, sessions=tst)
            assert out["sessions_imported"] == 1
            ident, installed = tmodels.walk_steps(*CATALOG, 4)[3]
            tst.op(sid, {"op": "assume", "identifiers": [ident],
                         "installed": installed})
            got = tst.op(sid, {"op": "resolve"})
        finally:
            tst.stop()
        assert got["warm"] is True
        stack = tmodels.walk_steps(*CATALOG, 4)
        assert got["result"] == _oracle(
            _cold_oracle(), tio.problem_from_dict(doc), stack)

    def test_export_seeds_equal_reference(self):
        js, jst, ts, tst = _pair()
        _stop(jst, tst)
        for s, io in ((js, jio), (ts, tio)):
            s.submit([io.problem_from_dict(_catalog_doc("sd"))])
            s.submit([io.problem_from_dict(_catalog_doc("se"))])
            s.submit([io.problem_from_dict({"variables": [
                {"id": "x", "constraints": [{"type": "mandatory"},
                                            {"type": "prohibited"}]}]})])
        assert ts.cache.export_seeds() == js.cache.export_seeds()
        assert len(ts.cache.export_seeds()) == 2


# -------------------------------------------------------------- scheduler


def _flushes(sched):
    return sched._registry.snapshot().get("deppy_sched_flushes_total", {})


class TestSessionLanes:
    def test_immediate_flush_counted(self, store):
        sched = store.scheduler
        sched.max_wait_s = 5.0
        sched.start()
        sid = store.create(_catalog_doc("im"))["id"]
        store.op(sid, {"op": "assume", "identifiers": ["imb1v0"]})
        t0 = time.perf_counter()
        store.op(sid, {"op": "resolve"})
        store.op(sid, {"op": "resolve"})
        assert time.perf_counter() - t0 < 5.0
        assert _flushes(sched) == {"immediate": 2}

    def test_session_lane_never_coalesces_with_stateless(self, store):
        sched = store.scheduler
        sched.max_wait_s = 0.3
        seen = []
        orig = sched._dispatch

        def spy(groups, reason):
            seen.append(([g.size_class for g in groups], reason))
            return orig(groups, reason)

        sched._dispatch = spy
        sched.start()
        sid = store.create(_catalog_doc("co"))["id"]
        store.op(sid, {"op": "assume", "identifiers": ["cob1v0"]})
        variables = tio.problem_from_dict(_catalog_doc("co"))
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "r", sched.submit([variables])))
        t.start()
        time.sleep(0.05)
        got = store.op(sid, {"op": "resolve"})
        t.join(30)
        assert "r" in out and "warm" not in got
        assert len(seen) == 2
        for classes, reason in seen:
            assert (tscheduler_mod.SESSION_CLASS in classes) == \
                (classes == [tscheduler_mod.SESSION_CLASS])
        assert sorted(r for _, r in seen) == ["immediate", "wait"]

    def test_planned_session_lane_rides_incremental_class(self, store):
        sched = store.scheduler
        groups = []
        orig = sched._enqueue

        def spy(group):
            groups.append((group.size_class, group.immediate,
                           [lane.scoped for lane in group.lanes]))
            return orig(group)

        sched._enqueue = spy
        sid = store.create(tmodels.session_catalog(*CATALOG))["id"]
        store.op(sid, {"op": "assume", "identifiers": ["b1v0"]})
        store.op(sid, {"op": "resolve"})
        store.op(sid, {"op": "assume", "identifiers": ["b2v0"],
                       "installed": False})
        store.op(sid, {"op": "resolve"})
        assert groups == [(tscheduler_mod.SESSION_CLASS, True, [True]),
                          (tscheduler_mod.INCREMENTAL_CLASS, True, [True])]
        assert (tscheduler_mod.SESSION_CLASS,
                tscheduler_mod.INCREMENTAL_CLASS) == (-2, -1)

    def test_submit_session_stats(self, sched):
        variables = tio.problem_from_dict(_catalog_doc("st"))
        st: dict = {}
        r = sched.submit_session(variables, stats=st)
        assert isinstance(r, dict)
        assert st["warm"] is False and st["steps"] > 0
        assert st["deadline_misses"] == 0 and "queue_wait_s" in \
            st["timings"]
        assert len(sched.cache) == 0

    def test_tier_off_still_plans_against_the_private_index(self):
        ts = Scheduler(device="cpu", incremental="off",
                       registry=ttelemetry.Registry())
        st = SessionStore(ts, metrics=ttelemetry.Registry(),
                          sweep_interval_s=3600.0)
        try:
            sid = st.create(_catalog_doc("of"))["id"]
            st.op(sid, {"op": "assume", "identifiers": ["ofb1v0"]})
            st.op(sid, {"op": "resolve"})
            assert st.op(sid, {"op": "resolve"})["warm"] is True
        finally:
            st.stop()


# ----------------------------------------------------- no hidden fallback


def test_raised_dispatch_reaches_the_op_and_the_session_survives(
        monkeypatch, store):
    sid = store.create(_catalog_doc("fb"))["id"]
    store.op(sid, {"op": "assume", "identifiers": ["fbb1v0"]})
    before = store._sessions[sid].solver.scope_state()

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    orig = tdriver.solve_problems
    monkeypatch.setattr(tdriver, "solve_problems", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        store.op(sid, {"op": "resolve"})
    assert store._sessions[sid].solver.scope_state() == before
    assert len(store.scheduler.cache) == 0
    monkeypatch.setattr(tdriver, "solve_problems", orig)
    out = store.op(sid, {"op": "resolve"})
    assert out["result"] == _oracle(
        _cold_oracle(), tio.problem_from_dict(_catalog_doc("fb")),
        [("fbb1v0", True)])


def _coalesced_screen_ops(monkeypatch, entries, sids, error):
    """Import ``entries`` into a store on ``device="cuda"`` whose screen
    raises ``error``, stall the first flush so the other two sessions'
    warm lanes coalesce, and resolve all three: (outcome or exception
    by session, host warm attempts, the scheduler's registry, the fault
    events, the store)."""
    def boom(*a, **k):
        raise error

    monkeypatch.setattr(tdriver, "warm_screen", boom)
    attempted = []
    attempt = tinc.attempt

    def counted(*a, **k):
        attempted.append(1)
        return attempt(*a, **k)

    monkeypatch.setattr(tinc, "attempt", counted)
    reg = ttelemetry.Registry()
    sched = Scheduler(device="cuda", registry=reg)
    st = SessionStore(sched, metrics=ttelemetry.Registry(),
                      sweep_interval_s=3600.0)
    events = []
    forward = events.append
    ttelemetry.default_registry().add_forwarder(forward)
    try:
        for e in entries:
            assert st.import_entry(e)
        states = {sid: st._sessions[sid].solver.scope_state()
                  for sid in sids}
        tfaults.configure_plan(tfaults.FaultPlan.from_doc(
            [{"point": "sched.dispatch", "kind": "latency",
              "latency_s": 0.5, "times": 1}]))
        sched.start()
        outs = {}

        def client(sid):
            try:
                outs[sid] = st.op(sid, {"op": "resolve"})
            except RuntimeError as e:
                outs[sid] = e

        first = threading.Thread(target=client, args=(sids[0],))
        first.start()
        time.sleep(0.15)
        rest = [threading.Thread(target=client, args=(sid,))
                for sid in sids[1:]]
        for t in rest:
            t.start()
        for t in [first] + rest:
            t.join(60)
        for sid in sids:
            assert st._sessions[sid].solver.scope_state() == states[sid]
            assert st.op(sid, {"op": "test"})["op"] == "test"
    finally:
        ttelemetry.default_registry().remove_forwarder(forward)
        sched.stop()
        st.stop()
    screen_failed = [e for e in events
                     if e.get("fault") == "incremental_screen_failed"]
    return outs, attempted, reg, screen_failed


def test_card_screen_error_reaches_every_coalesced_op(monkeypatch):
    """Three sessions on ``device="cuda"`` (no card is asked: their
    private indexes come from a CPU store's export, and the screen is
    faked to fail): a stalled first flush lets two warm session lanes
    coalesce.  A screen that fails as a launch would degrades, as the
    reference's does: the event, then both lanes' host warm attempts
    answer, equal to the CPU store's answers.  One that fails as a
    kernel build would reaches both ops, nothing is served around it,
    and each session stays usable."""
    cpu = Scheduler(device="cpu", registry=ttelemetry.Registry())
    src = SessionStore(cpu, metrics=ttelemetry.Registry(),
                       sweep_interval_s=3600.0)
    try:
        scripted = [_scripted(src, name) for name in ("ca", "cb", "cc")]
        sids = [sid for sid, _ in scripted]
        want = {sid: answer["result"] for sid, answer in scripted}
        entries = src.export_entries()
    finally:
        src.stop()

    outs, attempted, reg, failed = _coalesced_screen_ops(
        monkeypatch, entries, sids, RuntimeError("screen launch failed"))
    assert {sid: outs[sid]["result"] for sid in sids} == want
    assert attempted == [1, 1, 1]
    assert reg.snapshot().get("deppy_incremental_hits_total", 0) == 3
    (e,) = failed
    assert e["error"] == "RuntimeError" and e["lanes"] == 2

    outs, attempted, reg, failed = _coalesced_screen_ops(
        monkeypatch, entries, sids, KernelBuildError("screen launch failed"))
    assert [str(outs[sid]) for sid in sids[1:]] == \
        ["screen launch failed"] * 2
    assert attempted == [1]  # the lone first lane: no screen
    assert reg.snapshot().get("deppy_incremental_hits_total", 0) == 1
    assert failed == []
