"""The port's optimization tier and idle-priority queue against the JAX package's.

The reference's ``tests/test_optimize.py`` shapes, on the CPU: the
port's :class:`deppy_tpu_torch.optimize.Planner` runs over
``Scheduler(backend="host")`` and over ``Scheduler(device="cpu")`` (the
device backend on the kernels' plain versions), the reference's over
``Scheduler(backend="host", speculate="off")``.  Every comparison is
exact:

  * the enumeration oracle (objective and the lex-least tie-break) and
    byte-equal responses to the reference's ``Planner``;
  * the upgrade, explain and degradation cases and the tier's counters;
  * the idle queue: live lanes first, coalescing by class and budget up
    to ``max_fill``, the stop's failure of queued probes, the dispatch
    error's event, and ``speculate`` still left out;
  * the result cache and the clause-set index after a ``Planner`` run,
    equal to the reference's (probe answers are stored, as the
    reference's ``_dispatch`` stores every lane).
"""

from __future__ import annotations

import itertools
import json
import random
import threading
import time

import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import io as jio
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.optimize import Planner as JPlanner
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu.utils import check_solution
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import sat
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine._build import KernelBuildError
from deppy_tpu_torch.optimize import (BOUND_VARIABLE_ID, OptimizeFormatError,
                                      OptimizeRequest, Planner,
                                      build_objective, cone_mask,
                                      explain_variables,
                                      native_bound_variables)
from deppy_tpu_torch.optimize import loop as tloop
from deppy_tpu_torch.sat.encode import encode as tencode
from deppy_tpu_torch.sched import Scheduler

ORACLE_SEEDS = 24       # tier-1 seeds of the enumeration oracle, per backend
ORACLE_SEEDS_SLOW = 80  # deeper, under -m slow


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each package's fault plan, default registry and breaker per test;
    the reference's escalation off."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    monkeypatch.delenv("DEPPY_GPU_OPT_MAX_ITERATIONS", raising=False)
    monkeypatch.delenv("DEPPY_GPU_OPT_ITER_BUDGET", raising=False)
    monkeypatch.delenv("DEPPY_GPU_OPT_MAX_WEIGHT", raising=False)
    prev_breakers = (jfaults.set_default_breaker(jfaults.CircuitBreaker()),
                     tfaults.set_default_breaker(tfaults.CircuitBreaker()))
    prev_plans = (jfaults.configure_plan(None), tfaults.configure_plan(None))
    prev = (jtelemetry.set_default_registry(jtelemetry.Registry()),
            ttelemetry.set_default_registry(ttelemetry.Registry()))
    yield
    jtelemetry.set_default_registry(prev[0])
    ttelemetry.set_default_registry(prev[1])
    jfaults.configure_plan(prev_plans[0])
    tfaults.configure_plan(prev_plans[1])
    jfaults.set_default_breaker(prev_breakers[0])
    tfaults.set_default_breaker(prev_breakers[1])


def _sched(kind: str, **kw) -> Scheduler:
    if kind == "host":
        return Scheduler(backend="host", **kw)
    return Scheduler(device="cpu", **kw)


@pytest.fixture(params=["host", "cpu"])
def sched(request):
    s = _sched(request.param)
    s.start()
    yield s
    s.stop()


@pytest.fixture
def jsched():
    s = JScheduler(backend="host", speculate="off")
    s.start()
    yield s
    s.stop()


def _doc_of(variables, **fields) -> dict:
    return {"variables": [tio.variable_to_dict(v) for v in variables],
            **fields}


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


# ------------------------------------------------- enumeration oracle


def _cost(doc: dict, chosen: set) -> int:
    """The request's objective, computed straight from the query
    semantics (``tests/test_optimize.py:63-81``)."""
    if doc["query"] == "upgrade":
        big = len(doc["variables"]) + 1
        installed = set(doc.get("installed", ()))
        ids = {v["id"] for v in doc["variables"]}
        cost = big * sum(1 for p in doc.get("prefer", ())
                         if p not in chosen)
        cost += len((installed & ids) - chosen)
        cost += len(chosen - installed)
        return cost
    cost = 0
    for entry in doc.get("soft", ()):
        want = entry.get("installed", True)
        if want != (entry["id"] in chosen):
            cost += entry.get("weight", 1)
    return cost


def _oracle(doc: dict):
    """Brute force over every assignment in lex order (False < True,
    variable 0 most significant), each checked by the reference's
    independent verifier; the first minimum is the lex-least optimum.
    ``(objective, selected ids)``, or None when infeasible."""
    variables = [jio.variable_from_dict(v) for v in doc["variables"]]
    ids = [str(v.identifier) for v in variables]
    best = None
    for mask in itertools.product((False, True), repeat=len(ids)):
        chosen = {i for i, on in zip(ids, mask) if on}
        if check_solution(variables, chosen):
            continue
        cost = _cost(doc, chosen)
        if best is None or cost < best[0]:
            best = (cost, [i for i in ids if i in chosen])
    return best


def _random_doc(seed: int) -> dict:
    """``tests/test_optimize.py:113-137``: 3-8 variables with random
    mandatory, dependency, conflict and AtMost constraints; even seeds
    an upgrade query, odd ones soft preferences."""
    rng = random.Random(seed)
    n = rng.randint(3, 8)
    ids = [f"x{i}" for i in range(n)]
    variables = []
    for i, vid in enumerate(ids):
        cons = []
        others = [o for o in ids if o != vid]
        if rng.random() < 0.2:
            cons.append(sat.mandatory())
        if rng.random() < 0.55:
            cons.append(sat.dependency(
                *rng.sample(others, rng.randint(1, min(3, len(others))))))
        if rng.random() < 0.3:
            cons.append(sat.conflict(rng.choice(others)))
        if rng.random() < 0.2 and len(others) >= 2:
            cons.append(sat.at_most(1, *rng.sample(others, 2)))
        variables.append(sat.variable(vid, *cons))
    doc = _doc_of(variables)
    if seed % 2 == 0:
        doc["query"] = "upgrade"
        doc["installed"] = rng.sample(ids, rng.randint(0, n))
        doc["prefer"] = rng.sample(ids, rng.randint(0, 2))
    else:
        doc["query"] = "soft"
        doc["soft"] = [{"id": rng.choice(ids),
                        "installed": rng.random() < 0.5,
                        "weight": rng.randint(1, 3)}
                       for _ in range(rng.randint(1, 4))]
    return doc


def _unit_doc(seed: int) -> dict:
    """A random family under unit-positive soft preferences (every entry
    ``installed: false, weight 1``): its probes lower natively and ride
    the idle queue to the scheduler's backend."""
    doc = _random_doc(2 * seed + 1)
    rng = random.Random(seed)
    ids = [v["id"] for v in doc["variables"]]
    doc["soft"] = [{"id": i, "installed": False, "weight": 1}
                   for i in sorted(rng.sample(ids, rng.randint(1, len(ids))))]
    doc["warm"] = False
    return doc


def _check_oracle(doc: dict, out: dict) -> None:
    expect = _oracle(doc)
    if expect is None:
        assert out["status"] == "unsat"
        assert out["blocking"]
        return
    assert out["status"] == "optimal", out
    assert out["optimal"] is True
    assert out["proof"] in ("unsat_probe", "floor")
    assert out["objective"] == expect[0]
    assert out["selected"] == expect[1]


class TestOracle:
    @pytest.mark.parametrize("seed", range(ORACLE_SEEDS))
    def test_answer_matches_enumeration_oracle(self, sched, seed):
        doc = _random_doc(seed)
        _check_oracle(doc, Planner(sched).handle(doc))

    @pytest.mark.slow
    @pytest.mark.parametrize("seed", range(ORACLE_SEEDS, ORACLE_SEEDS_SLOW))
    def test_answer_matches_enumeration_oracle_deep(self, sched, seed):
        doc = _random_doc(seed)
        _check_oracle(doc, Planner(sched).handle(doc))

    @pytest.mark.parametrize("seed", range(12))
    def test_native_probes_match_the_oracle(self, sched, seed):
        """Unit-positive objectives: the feasibility solve and every
        probe go through ``submit_optimize`` to the scheduler's backend
        (one idle flush each), and the answer is still the lex-least
        optimum."""
        doc = _unit_doc(seed)
        out = Planner(sched).handle(doc)
        _check_oracle(doc, out)
        flushes = ttelemetry.default_registry().snapshot()[
            "deppy_sched_flushes_total"]
        assert flushes == {"spec": 1 + out["iterations"]}

    @pytest.mark.parametrize("seed", range(4))
    def test_warm_and_cold_prove_the_same_optimum(self, sched, seed):
        doc = _random_doc(seed)
        if _oracle(doc) is None:
            doc = _random_doc(seed + 100)
        warm = Planner(sched).handle({**doc, "warm": True})
        cold = Planner(sched).handle({**doc, "warm": False})
        assert warm["objective"] == cold["objective"]
        assert warm["selected"] == cold["selected"]

    @pytest.mark.parametrize("kind", ["host", "cpu"])
    def test_inline_dispatch_without_running_loop(self, kind):
        s = _sched(kind)
        doc = _random_doc(0)
        out = Planner(s).handle(doc)
        assert out["status"] in ("optimal", "unsat")
        _check_oracle(doc, out)


# ----------------------------------------------- against the reference


def _reference_docs():
    return ([_random_doc(s) for s in range(8)]
            + [_unit_doc(s) for s in range(4)]
            + [{**_random_doc(s), "warm": True} for s in (1, 2)])


class TestAgainstReference:
    def test_responses_equal_the_reference(self, sched, jsched):
        """Every response byte-equal to the reference's ``Planner`` on
        ``Scheduler(backend="host", speculate="off")``: status,
        objective, selected, proof, iterations, improvements and, for
        upgrades, missing_prefer and touched."""
        for doc in _reference_docs():
            assert _dumps(Planner(sched).handle(doc)) == \
                _dumps(JPlanner(jsched).handle(doc)), doc

    def test_explain_responses_equal_the_reference(self, sched, jsched):
        for doc in (_doc_of(_blocked_family(), query="explain",
                            goal=["app-v2"]),
                    _doc_of(_upgrade_family(), query="explain",
                            goal=["app-v2"])):
            assert _dumps(Planner(sched).handle(doc)) == \
                _dumps(JPlanner(jsched).handle(doc))

    def test_cache_and_index_equal_the_reference(self, jsched):
        """Probe answers are stored: after the same ``Planner`` runs, the
        result cache holds the same fingerprints and answers, and the
        clause-set index the same entries, as the reference's."""
        s = Scheduler(backend="host")
        s.start()
        try:
            docs = [_unit_doc(s_) for s_ in range(3)] + [_random_doc(0)]
            for doc in docs:
                Planner(s).handle(doc)
                JPlanner(jsched).handle(doc)
        finally:
            s.stop()

        def cache_view(cache):
            with cache._lock:
                return sorted((k, e.budget, e.definitive,
                               _dumps(_render(e.result)))
                              for k, e in cache._entries.items())

        assert len(s.cache) == len(jsched.cache) > 0
        assert cache_view(s.cache) == cache_view(jsched.cache)
        assert len(s.incremental) == len(jsched.incremental) > 0
        assert sorted(s.incremental._entries) == \
            sorted(jsched.incremental._entries)


def _render(r):
    if isinstance(r, dict):
        return sorted(str(k) for k, v in r.items() if v)
    if hasattr(r, "constraints"):
        return ["unsat"] + [str(c) for c in r.constraints]
    return [type(r).__name__]


# ------------------------------------------------------- upgrade shape


def _upgrade_family():
    """``tests/test_optimize.py:175-191``: the catalog prefers v2 but
    only the app must move — the optimum keeps lib-v1 installed."""
    return [
        sat.variable("root", sat.mandatory(),
                     sat.dependency("app-v2", "app-v1"),
                     sat.at_most(1, "app-v2", "app-v1")),
        sat.variable("app-v1", sat.dependency("lib-v1")),
        sat.variable("app-v2", sat.dependency("lib-v1", "lib-v2")),
        sat.variable("lib-v1"),
        sat.variable("lib-v2"),
    ]


def _blocked_family():
    return _upgrade_family() + [
        sat.variable("blocker", sat.mandatory(),
                     sat.conflict("lib-v1"), sat.conflict("lib-v2")),
    ]


class TestUpgrade:
    def test_minimal_change_plan(self, sched):
        doc = _doc_of(_upgrade_family(), query="upgrade",
                      installed=["root", "app-v1", "lib-v1"],
                      prefer=["app-v2"])
        out = Planner(sched).handle(doc)
        assert out["status"] == "optimal"
        assert out["missing_prefer"] == []
        assert out["touched"] == 2
        assert out["selected"] == ["root", "app-v2", "lib-v1"]

    def test_withdrawn_installed_bundle_is_ignored(self, sched):
        doc = _doc_of(_upgrade_family(), query="upgrade",
                      installed=["root", "app-v0", "app-v1", "lib-v1"],
                      prefer=[])
        out = Planner(sched).handle(doc)
        assert out["status"] == "optimal"
        assert out["touched"] == 0

    def test_unknown_prefer_id_is_a_format_error(self, sched):
        doc = _doc_of(_upgrade_family(), query="upgrade",
                      installed=[], prefer=["nope"])
        with pytest.raises(OptimizeFormatError):
            Planner(sched).handle(doc)

    def test_soft_weight_cap_enforced(self, sched):
        doc = _doc_of(_upgrade_family(), query="soft",
                      soft=[{"id": "lib-v1", "weight": 9}])
        with pytest.raises(OptimizeFormatError):
            Planner(sched, max_weight=8).handle(doc)
        out = Planner(sched, max_weight=9).handle(doc)
        assert out["status"] == "optimal"

    def test_counters_land_on_the_given_registry(self, sched):
        reg = ttelemetry.Registry()
        planner = Planner(sched, metrics=reg)
        doc = _doc_of(_upgrade_family(), query="upgrade",
                      installed=["root", "app-v1", "lib-v1"],
                      prefer=["app-v2"])
        out = planner.handle(doc)
        assert sum(planner._c_iterations.value.values()) \
            == out["iterations"]
        assert planner._c_improvements.value == out["improvements"]
        assert planner._c_proofs.value.get(out["proof"]) == 1
        assert "deppy_optimize_iterations_total" in reg.snapshot()
        assert "deppy_optimize_iterations_total" not in \
            ttelemetry.default_registry().snapshot()

    @pytest.mark.parametrize("bad", [
        [], {"variables": []}, {"variables": [{"id": "a"}], "query": "x"},
        {"variables": [{"id": "a"}], "query": "soft"},
        {"variables": [{"id": "a"}], "query": "soft", "warm": 1,
         "soft": [{"id": "a"}]},
        {"variables": [{"id": "a"}], "query": "soft",
         "soft": [{"id": "a", "weight": 0}]},
        {"variables": [{"id": "a"}], "query": "soft",
         "soft": [{"id": "a", "installed": "yes"}]},
        {"variables": [{"id": "a"}], "query": "upgrade", "installed": "a"},
    ])
    def test_format_errors_match_the_reference(self, bad):
        from deppy_tpu.optimize import OptimizeFormatError as JFormat
        from deppy_tpu.optimize import OptimizeRequest as JRequest

        with pytest.raises(JFormat) as want:
            JRequest.from_doc(bad, 64)
        with pytest.raises(OptimizeFormatError) as got:
            OptimizeRequest.from_doc(bad, 64)
        assert str(got.value) == str(want.value)


class TestObjective:
    @pytest.mark.parametrize("seed", range(6))
    def test_objective_and_lowerings_equal_the_reference(self, seed):
        """``build_objective``, ``explain_variables``,
        ``native_bound_variables`` and ``cone_mask`` on the same
        document give the reference's values."""
        import numpy as np

        from deppy_tpu.optimize import objective as jobj
        from deppy_tpu.sat.encode import encode as jencode

        doc = _random_doc(seed) if seed < 4 else _unit_doc(seed)
        doc = {**doc, "goal": [doc["variables"][0]["id"]]}
        req = OptimizeRequest.from_doc(doc, 64)
        jreq = jobj.OptimizeRequest.from_doc(doc, 64)
        index = {str(v.identifier): i for i, v in enumerate(req.variables)}
        n = len(req.variables)
        obj = build_objective(req, index, n)
        jo = jobj.build_objective(jreq, index, n)
        assert obj.signed.tolist() == jo.signed.tolist()
        assert (obj.offset, obj.floor, obj.unit_positive) == \
            (jo.offset, jo.floor, jo.unit_positive)
        assert [tio.variable_to_dict(v) for v in explain_variables(req)] \
            == [jio.variable_to_dict(v) for v in jobj.explain_variables(jreq)]
        native = native_bound_variables(req.variables, obj, 1)
        jnative = jobj.native_bound_variables(jreq.variables, jo, 1)
        assert (native is None) == (jnative is None)
        if native is not None:
            assert native[-1].identifier == BOUND_VARIABLE_ID
            assert [tio.variable_to_dict(v) for v in native] == \
                [jio.variable_to_dict(v) for v in jnative]
        rng = np.random.default_rng(seed)
        model = rng.random(n) < 0.5
        p = tencode(list(req.variables))
        jp = jencode(list(jreq.variables))
        assert cone_mask(p, model, obj).tolist() == \
            jobj.cone_mask(jp, model, jo).tolist()


# ------------------------------------------------------- explain-why-not


class TestExplain:
    def test_blocked_goal_names_the_blocking_set(self, sched):
        doc = _doc_of(_blocked_family(), query="explain", goal=["app-v2"])
        out = Planner(sched).handle(doc)
        assert out["status"] == "blocked"
        text = " ".join(out["blocking"])
        assert "conflicts with" in text
        assert "blocker" in text

    def test_feasible_goal_returns_a_plan(self, sched):
        doc = _doc_of(_upgrade_family(), query="explain", goal=["app-v2"])
        out = Planner(sched).handle(doc)
        assert out["status"] == "feasible"
        assert "app-v2" in out["plan"]
        jvars = [jio.variable_from_dict(v) for v in doc["variables"]]
        assert check_solution(jvars, out["plan"]) == []

    def test_explain_requires_goals(self, sched):
        with pytest.raises(OptimizeFormatError):
            Planner(sched).handle(
                _doc_of(_upgrade_family(), query="explain", goal=[]))


# ------------------------------------------------- mid-loop degradation


def _slow_doc(n: int = 12) -> dict:
    """``tests/test_optimize.py:275-286``: free variables under
    want-installed soft preferences — the loop tightens one unit per
    probe, every probe on the host objective engine."""
    variables = [sat.variable(f"x{i}") for i in range(n)]
    return _doc_of(variables, query="soft",
                   soft=[{"id": f"x{i}", "installed": True, "weight": 1}
                         for i in range(n)])


class TestDegradation:
    def test_iteration_cap_returns_best_so_far(self, sched):
        doc = _slow_doc()
        full = Planner(sched).handle(doc)
        assert full["status"] == "optimal" and full["objective"] == 0
        assert full["improvements"] > 2
        capped = Planner(sched, max_iterations=1).handle(doc)
        assert capped["status"] == "degraded"
        assert capped["optimal"] is False
        assert capped["reason"] == "iteration-cap"
        assert capped["iterations"] == 1
        jvars = [jio.variable_from_dict(v) for v in doc["variables"]]
        assert check_solution(jvars, capped["selected"]) == []
        assert capped["objective"] > full["objective"]

    def test_deadline_mid_loop_degrades(self, sched, monkeypatch):
        """The request's deadline lapses after the feasibility solve.
        The loop's clock is pinned (0 s while the deadline is set and the
        feasibility solve is submitted, 1 s after), so the feasibility
        lane keeps a real 0.5 s budget however loaded the machine is
        (with ``deadline_s=0.0``, as the reference's test has it, the
        lane gets 1 ms and can expire at triage under load)."""
        import types

        ticks = iter([0.0, 0.0])
        monkeypatch.setattr(tloop, "time", types.SimpleNamespace(
            monotonic=lambda: next(ticks, 1.0),
            perf_counter=time.perf_counter))
        out = Planner(sched).handle(_slow_doc(), deadline_s=0.5)
        assert out["status"] == "degraded"
        assert out["reason"] == "deadline"
        assert out["optimal"] is False
        assert out["iterations"] == 0 and out["objective"] > 0

    def test_probe_budget_flags_non_canonical(self, sched):
        out = Planner(sched, iter_budget=1).handle(_slow_doc())
        assert out["status"] == "degraded"
        assert out["reason"] == "probe-budget"
        assert out.get("canonical") is False

    def test_knobs_come_from_the_environment(self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_OPT_MAX_ITERATIONS", "1")
        monkeypatch.setenv("DEPPY_GPU_OPT_ITER_BUDGET", "7")
        monkeypatch.setenv("DEPPY_GPU_OPT_MAX_WEIGHT", "not-a-number")
        p = Planner(None)
        assert (p.max_iterations, p.iter_budget, p.max_weight) == \
            (1, 7, tloop.DEFAULT_MAX_WEIGHT)


# ---------------------------------------------------- the idle queue


class _Gate:
    """Holds the dispatch loop inside its first dispatch until released,
    and records every dispatch: its reason, its groups' idle flags and
    lane counts, and the live lanes still queued when it started."""

    def __init__(self, s: Scheduler):
        self.s = s
        self.release = threading.Event()
        self.entered = threading.Event()
        self.log = []
        orig = s._dispatch

        def dispatch(groups, reason):
            self.log.append((reason, [g.speculative for g in groups],
                             [len(g.lanes) for g in groups]))
            if not self.entered.is_set():
                self.entered.set()
                assert self.release.wait(60)
            return orig(groups, reason)

        s._dispatch = dispatch

    def wait_queued(self, live: int, idle: int) -> None:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30:
            with self.s._cv:
                if (len(self.s._queue) == live
                        and len(self.s._spec_queue) == idle):
                    return
            time.sleep(0.005)
        raise AssertionError("groups never queued")


def _bg(fn, *args, **kw):
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 — checked by the test
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


def _state(seed: int):
    """A tiny family whose shape (and so size class) is the same for
    every seed: a mandatory root that needs one of two leaves, one of
    which conflicts with a third."""
    return [sat.variable(f"r{seed}", sat.mandatory(),
                         sat.dependency(f"a{seed}", f"b{seed}")),
            sat.variable(f"a{seed}", sat.conflict(f"c{seed}")),
            sat.variable(f"b{seed}"),
            sat.variable(f"c{seed}", sat.mandatory())]


class TestIdleQueue:
    @pytest.mark.parametrize("kind", ["host", "cpu"])
    def test_live_lanes_dispatch_before_idle_ones(self, kind):
        s = _sched(kind, max_wait_ms=1.0)
        gate = _Gate(s)
        s.start()
        try:
            first = _bg(s.submit, [_state(0)])
            assert gate.entered.wait(30)
            probe = _bg(s.submit_optimize, [_state(1)])
            gate.wait_queued(live=0, idle=1)
            live = _bg(s.submit, [_state(2)])
            gate.wait_queued(live=1, idle=1)
            gate.release.set()
            for t, box in (first, probe, live):
                t.join(60)
                assert "err" not in box
        finally:
            gate.release.set()
            s.stop()
        assert [(r, spec) for r, spec, _ in gate.log] == [
            ("wait", [False]), ("wait", [False]), ("spec", [True])]
        assert probe[1]["out"][0] == \
            Scheduler(backend="host").submit([_state(1)])[0]

    def test_idle_groups_coalesce_by_class_and_budget(self):
        s = _sched("host", max_fill=2)
        gate = _Gate(s)
        s.start()
        try:
            first = _bg(s.submit, [_state(0)])
            assert gate.entered.wait(30)
            big = [sat.variable(f"v{i}", sat.dependency(f"v{i + 1}"))
                   for i in range(200)] + [sat.variable("v200")]
            jobs = [_bg(s.submit_optimize, [_state(1)]),
                    _bg(s.submit_optimize, [big]),
                    _bg(s.submit_optimize, [_state(2)]),
                    _bg(s.submit_optimize, [_state(3)], max_steps=1000),
                    _bg(s.submit_optimize, [_state(4)])]
            gate.wait_queued(live=0, idle=5)
            gate.release.set()
            for t, box in [first] + jobs:
                t.join(60)
                assert "err" not in box
        finally:
            gate.release.set()
            s.stop()
        # The head and its same-class, same-budget neighbours up to
        # max_fill lanes; the big catalog and the other budget alone.
        assert [(r, n) for r, _, n in gate.log] == [
            ("wait", [1]), ("spec", [1, 1]), ("spec", [1]), ("spec", [1]),
            ("spec", [1])]
        with s._cv:
            assert s._spec_queue == [] and s._spec_depth == 0

    def test_stop_fails_queued_probes(self):
        s = _sched("host")
        gate = _Gate(s)
        s.start()
        try:
            first = _bg(s.submit, [_state(0)])
            assert gate.entered.wait(30)
            probe = _bg(s.submit_optimize, [_state(1)])
            gate.wait_queued(live=0, idle=1)
            stopper = threading.Thread(target=s.stop)
            stopper.start()
            t0 = time.monotonic()
            while not s._stop and time.monotonic() - t0 < 30:
                time.sleep(0.005)
            gate.release.set()
            stopper.join(60)
            for t, _ in (first, probe):
                t.join(60)
        finally:
            gate.release.set()
            s.stop()
        assert "err" not in first[1]
        err = probe[1]["err"]
        assert isinstance(err, RuntimeError)
        assert str(err) == "scheduler stopped before optimize dispatch"
        # After the stop, probes dispatch inline.
        assert s.submit_optimize([_state(1)])[0] is not None

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_loop_crash_fails_queued_probes(self):
        s = _sched("host")
        gate = _Gate(s)
        s.start()
        try:
            first = _bg(s.submit, [_state(0)])
            assert gate.entered.wait(30)
            probe = _bg(s.submit_optimize, [_state(1)])
            gate.wait_queued(live=0, idle=1)

            def crash():
                raise SystemExit("loop crash")

            s._drain_spec_locked = crash
            gate.release.set()
            first[0].join(60)
            probe[0].join(60)
        finally:
            gate.release.set()
            s.stop()
        err = probe[1]["err"]
        assert str(err) == "scheduler dispatch loop exited unexpectedly"

    @pytest.mark.parametrize("kind", ["host", "cpu"])
    def test_dispatch_error_reaches_the_caller_and_the_sink(self, kind):
        events = []
        ttelemetry.default_registry().add_forwarder(events.append)
        s = _sched(kind)
        s.start()
        try:
            tfaults.configure_plan(tfaults.plan_from_spec(
                '[{"point": "sched.dispatch", "times": 1}]'))
            with pytest.raises(tfaults.InjectedFault):
                s.submit_optimize([_state(1), _state(2)])
        finally:
            tfaults.configure_plan(None)
            s.stop()
        failed = [e for e in events if e.get("fault")
                  == "speculate_dispatch_failed"]
        assert failed == [dict(failed[0], error="InjectedFault", lanes=2)]

    def test_tree_defect_passes_through_a_probe(self, monkeypatch):
        """A kernel that does not build reaches the optimize caller, as
        it reaches every other submitter: no host route hides it."""
        def broken(*a, **k):
            raise KernelBuildError("nvcc failed")

        monkeypatch.setattr(tdriver, "_solve_split", broken)
        s = _sched("cpu")
        s.start()
        try:
            with pytest.raises(KernelBuildError):
                Planner(s).handle(_unit_doc(0))
        finally:
            s.stop()
        snap = ttelemetry.default_registry().snapshot()
        assert snap.get("deppy_fault_host_routed_total", 0) == 0

    def test_probe_records_its_queue_wait_and_stats(self):
        s = _sched("cpu")
        s.start()
        try:
            st = {}
            out = s.submit_optimize([_state(3)], stats=st, tenant="t1")
        finally:
            s.stop()
        want = Scheduler(device="cpu").submit([_state(3)])
        assert _render(out[0]) == _render(want[0])
        assert st["steps"] > 0 and st["deadline_misses"] == 0
        assert st["report"] is not None and "queue_wait_s" in st["timings"]
        spans = [sp for sp in ttelemetry.default_registry().recent_spans()
                 if sp["name"] == "sched.queue_wait"]
        assert spans and spans[-1]["attrs"]["lanes"] == 1

    @pytest.mark.parametrize("name,value", [
        ("speculate", "on"), ("speculate_max_backlog", 8)])
    def test_speculation_is_still_left_out(self, name, value):
        with pytest.raises(NotImplementedError, match="A5.6.3"):
            Scheduler(device="cpu", **{name: value})
        Scheduler(device="cpu", speculate="off")
