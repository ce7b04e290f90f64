"""The port's incremental tier against the JAX package's.

The same encoded problems, built from the same variables in both
packages (the reference's, rebuilt in the port's vocabulary with
``variables_from_objects``), go through ``deppy_tpu.incremental`` and
``deppy_tpu_torch.incremental``: the row multisets, vocabulary keys,
touched cones and warm plans must be equal, the warm screen bit for bit
(tolerance zero) and the warm attempts lane for lane.  Then the
reference's ``tests/test_incremental.py`` classes run on the port
(``TestClauseSetIndex``, ``TestWarmIdentity``, ``TestWarmScreen``,
``TestSchedulerIncremental``, ``TestCacheSatellites``; the solver
scopes are ``tests/test_torch_host_engine.py``'s), the scheduler held
tier on against tier off and against the reference's scheduler, and the
screen's error rule: on ``device="cuda"`` an error fails the dispatch,
on ``device="cpu"`` it degrades to all-True as in the reference.
"""

from __future__ import annotations

import random
import threading

import numpy as np
import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import incremental as jinc
from deppy_tpu import io as jio
from deppy_tpu import sat as jsat
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.benchmarks.churn import churn_requests as jchurn_requests
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu.sched.cache import fingerprint as jfingerprint
from deppy_tpu_torch import incremental as tinc
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine import registry as tregistry
from deppy_tpu_torch.engine._build import KernelBuildError, KernelLaunchError
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.incremental import (DELTA_ADDITIVE, DELTA_IDENTICAL,
                                         DELTA_MIXED, DELTA_RETRACTIVE,
                                         ClauseSetIndex, problem_rows)
from deppy_tpu_torch.models import churn_requests
from deppy_tpu_torch.sat.encode import encode as tencode
from deppy_tpu_torch.sat.errors import Incomplete, NotSatisfiable
from deppy_tpu_torch.sat.host import HostEngine, WarmStartConflict
from deppy_tpu_torch.sched import ResultCache, Scheduler
from deppy_tpu_torch.sched import scheduler as tscheduler_mod
from deppy_tpu_torch.sched.cache import MISS, fingerprint

KINDS = ("add-conflict", "add-dep", "add-atmost", "add-mandatory",
         "drop-dep", "flip-dep")


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each package's fault plan and default registry, and the
    reference's breaker, per test; the reference's escalation off."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    monkeypatch.delenv("DEPPY_GPU_INCREMENTAL", raising=False)
    prev_breaker = jfaults.set_default_breaker(jfaults.CircuitBreaker())
    prev = (jtelemetry.set_default_registry(jtelemetry.Registry()),
            ttelemetry.set_default_registry(ttelemetry.Registry()))
    yield
    jtelemetry.set_default_registry(prev[0])
    ttelemetry.set_default_registry(prev[1])
    jfaults.set_default_breaker(prev_breaker)


# ------------------------------------------------------------ workloads


def bundle_catalog(rng=None, n_bundles=6, bsize=6, tweak=None):
    """The reference suite's churn shape (``tests/test_incremental.py``),
    in the reference's vocabulary: independent dependency bundles, and
    ``tweak=(kind, bundle)`` mutates exactly one bundle."""
    vs = []
    for b in range(n_bundles):
        for j in range(bsize):
            cons = []
            if j == 0:
                cons.append(jsat.mandatory())
            if j < bsize - 2:
                if rng is not None:
                    cands = rng.sample(range(j + 1, bsize), 2)
                else:
                    cands = [j + 1, j + 2]
                cons.append(jsat.dependency(*[f"b{b}v{k}" for k in cands]))
            if tweak is not None and tweak[1] == b:
                kind = tweak[0]
                if kind == "add-conflict" and j == 1:
                    cons.append(jsat.conflict(f"b{b}v{bsize - 1}"))
                elif kind == "add-dep" and j == 2:
                    cons.append(jsat.dependency(f"b{b}v{bsize - 1}",
                                                f"b{b}v{bsize - 2}"))
                elif kind == "add-atmost" and j == 0:
                    cons.append(jsat.at_most(1, f"b{b}v{bsize - 2}",
                                             f"b{b}v{bsize - 1}"))
                elif kind == "add-mandatory" and j == 3:
                    cons.append(jsat.mandatory())
                elif kind == "drop-dep" and j == 1:
                    cons = [c for c in cons
                            if not isinstance(c, jsat.Dependency)]
                elif kind == "flip-dep" and j == 1:
                    cons = [c for c in cons
                            if not isinstance(c, jsat.Dependency)]
                    cons.append(jsat.dependency(f"b{b}v{bsize - 1}",
                                                f"b{b}v{bsize - 2}"))
            vs.append(jsat.variable(f"b{b}v{j}", *cons))
    return vs


def both(jvars):
    """The same problem encoded by each package: (reference, port)."""
    return jencode(jvars), tencode(variables_from_objects(jvars))


def port(jvars):
    return tencode(variables_from_objects(jvars))


def solve_cold(problem, max_steps=None):
    """(outcome, payload), engine of one cold port host solve."""
    eng = HostEngine(problem, max_steps=max_steps)
    try:
        _, idx = eng.solve()
        return ("sat", tuple(idx)), eng
    except NotSatisfiable as e:
        ids = {id(c) for c in e.constraints}
        return ("unsat", tuple(j for j, c in enumerate(problem.applied)
                               if id(c) in ids)), eng
    except Incomplete:
        return ("incomplete", ()), eng


def indexed(index_cls, registry, problem, key, eng, idx, **kw):
    """An index of ``index_cls`` seeded with one solved problem."""
    index = index_cls(registry=registry, **kw)
    model = np.zeros(problem.n_vars, dtype=bool)
    model[list(idx)] = True
    index.store(key, problem, model, eng.steps, eng.backtracks)
    return index


def plan_pair(base_jvars, new_jvars, **kw):
    """The reference's and the port's warm plan of ``new`` against an
    index seeded with ``base``'s cold solve (the port's host engine
    solves both seeds: the engines are one spec)."""
    jb, tb = both(base_jvars)
    (outcome, idx), eng = solve_cold(tb)
    jn, tn = both(new_jvars)
    jix = indexed(jinc.ClauseSetIndex, jtelemetry.Registry(), jb,
                  jfingerprint(jb), eng, idx, **kw)
    tix = indexed(ClauseSetIndex, ttelemetry.Registry(), tb,
                  fingerprint(tb), eng, idx, **kw)
    return (jix.plan(jn, jfingerprint(jn), 1 << 24),
            tix.plan(tn, fingerprint(tn), 1 << 24), jn, tn)


def same_plan(jp, tp) -> None:
    assert (jp is None) == (tp is None)
    if jp is None:
        return
    assert tp.klass == jp.klass
    assert tp.key == jp.key
    assert tp.entry_key == jp.entry_key
    assert tp.entry_steps == jp.entry_steps
    assert tp.cone_fraction == jp.cone_fraction
    np.testing.assert_array_equal(tp.cone, jp.cone)
    np.testing.assert_array_equal(tp.warm_assign, jp.warm_assign)
    assert tp.warm_assign.dtype == jp.warm_assign.dtype


def poisoned(plan, problem):
    """A copy of ``plan`` whose off-cone mandatory anchor reads FALSE:
    its warm prefix conflicts."""
    anchor = next(int(a) for a in problem.anchors if not plan.cone[a])
    bad = plan.warm_assign.copy()
    bad[anchor] = -1
    return bad


# ------------------------------------------- parity with the reference


@pytest.mark.parametrize("jvars", [
    bundle_catalog(), bundle_catalog(random.Random(3), n_bundles=4),
    bundle_catalog(tweak=("add-atmost", 2)),
    bundle_catalog(tweak=("flip-dep", 0)),
    jchurn_requests(5, 4, 12)[4],
], ids=["plain", "random", "atmost", "flip", "churn"])
def test_rows_vocab_and_cone_equal_reference(jvars):
    jp, tp = both(jvars)
    assert problem_rows(tp) == jinc.problem_rows(jp)
    assert tinc.vocab_key(tp) == jinc.vocab_key(jp)
    for seed in ([0], [1, 7], list(range(0, tp.n_vars, 5))):
        np.testing.assert_array_equal(
            tinc.touched_cone(tp, seed, ()),
            jinc.touched_cone(jp, seed, ()))
    extra = [("c", 0, 1, 2), ("k", 1, 3, 4)]
    np.testing.assert_array_equal(tinc.touched_cone(tp, [1], extra),
                                  jinc.touched_cone(jp, [1], extra))


def test_churn_requests_equal_reference():
    """The port's copy of the churn replay builds the reference's
    requests: the same encoded problems, request for request."""
    got = churn_requests(40, 8, 12)
    want = jchurn_requests(40, 8, 12)
    assert len(got) == len(want) == 40
    for t, j in zip(got, want):
        assert fingerprint(tencode(t)) == jfingerprint(jencode(j))


@pytest.mark.parametrize("kind", KINDS + (None,))
@pytest.mark.parametrize("bundle", [0, 3])
def test_plan_equals_reference(kind, bundle):
    tweak = None if kind is None else (kind, bundle)
    jp, tp, _, _ = plan_pair(bundle_catalog(),
                             bundle_catalog(tweak=tweak),
                             max_delta_ratio=1.0)
    same_plan(jp, tp)
    assert tp is not None


@pytest.mark.parametrize("kw", [dict(max_delta_ratio=0.01),
                                dict(max_delta_ratio=0.25),
                                dict(capacity=0)],
                         ids=["cutoff", "default-delta", "capacity-0"])
def test_gated_plans_equal_reference(kw):
    jp, tp, _, _ = plan_pair(bundle_catalog(),
                             bundle_catalog(tweak=("add-dep", 1)), **kw)
    same_plan(jp, tp)


def test_plan_over_a_churn_replay_equals_reference():
    """Both indexes fed the same replay (the port's host engine solves
    each request once), plan for plan and hit ratio for hit ratio."""
    jix = jinc.ClauseSetIndex(registry=jtelemetry.Registry())
    tix = ClauseSetIndex(registry=ttelemetry.Registry())
    planned = 0
    for jvars in jchurn_requests(24, 4, 12):
        jp, tp = both(jvars)
        jplan = jix.plan(jp, jfingerprint(jp), 1 << 24)
        tplan = tix.plan(tp, fingerprint(tp), 1 << 24)
        same_plan(jplan, tplan)
        planned += tplan is not None
        (_, idx), eng = solve_cold(tp)
        model = np.zeros(tp.n_vars, bool)
        model[list(idx)] = True
        jix.store(jfingerprint(jp), jp, model, eng.steps, eng.backtracks)
        tix.store(fingerprint(tp), tp, model, eng.steps, eng.backtracks)
        jix.note_served()
        tix.note_served()
    assert planned > 0
    assert tix.hit_ratio() == jix.hit_ratio()
    assert len(tix) == len(jix)


def _attempts(kind, bundle, poison):
    jp, tp, jn, tn = plan_pair(bundle_catalog(),
                               bundle_catalog(tweak=(kind, bundle)),
                               max_delta_ratio=1.0)
    if poison:
        jp.warm_assign = poisoned(jp, jn)
        tp.warm_assign = poisoned(tp, tn)
    return jinc.attempt(jp), tinc.attempt(tp)


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "poisoned"])
@pytest.mark.parametrize("kind", KINDS)
def test_attempt_equals_reference(kind, poison):
    """The same lane result (outcome, model, steps, decisions, rounds,
    backtracks) or the same fallback."""
    want, got = _attempts(kind, 2, poison)
    assert (got is None) == (want is None)
    if poison:
        assert got is None
    if got is None:
        return
    assert (got.outcome, got.installed_idx, got.core_idx, got.steps,
            got.decisions, got.propagation_rounds, got.backtracks) == (
        want.outcome, want.installed_idx, want.core_idx, want.steps,
        want.decisions, want.propagation_rounds, want.backtracks)


def test_solve_via_warm_equals_attempt():
    """The registry's ``warm`` adapter renders each attempt in the lane
    vocabulary, None per fallback."""
    plans, problems = [], []
    for kind in ("add-dep", "flip-dep"):
        _, tp, _, tn = plan_pair(bundle_catalog(),
                                 bundle_catalog(tweak=(kind, 1)),
                                 max_delta_ratio=1.0)
        plans.append(tp)
        problems.append(tn)
    bad = tinc.WarmPlan(problems[0], plans[0].key,
                        poisoned(plans[0], problems[0]), plans[0].cone,
                        plans[0].klass, plans[0].cone_fraction,
                        plans[0].entry_key, plans[0].entry_steps)
    out = tregistry.solve_via("warm", plans + [bad], device="cpu")
    assert out[2] is None
    for plan, r in zip(plans, out):
        want = tinc.attempt(plan)
        assert (r.outcome, r.installed_idx, r.steps, r.backtracks) == (
            want.outcome, want.installed_idx, want.steps, want.backtracks)


# ------------------------------------------------------- classification


class TestClauseSetIndex:
    def _plan(self, base_tweak, new_tweak, **kw):
        base = port(bundle_catalog(tweak=base_tweak))
        (outcome, idx), eng = solve_cold(base)
        assert outcome == "sat"
        index = indexed(ClauseSetIndex, ttelemetry.Registry(), base,
                        fingerprint(base), eng, idx,
                        **{"max_delta_ratio": 1.0, **kw})
        new = port(bundle_catalog(tweak=new_tweak))
        return index.plan(new, fingerprint(new), 1 << 24), new

    def test_additive_delta(self):
        plan, _ = self._plan(None, ("add-conflict", 2))
        assert plan is not None and plan.klass == DELTA_ADDITIVE
        assert 0 < plan.cone.sum() <= 6
        assert plan.cone_fraction <= 6 / 36

    def test_retractive_delta(self):
        plan, _ = self._plan(("add-conflict", 2), None)
        assert plan is not None and plan.klass == DELTA_RETRACTIVE

    def test_mixed_delta(self):
        plan, _ = self._plan(None, ("flip-dep", 2))
        assert plan is not None and plan.klass == DELTA_MIXED

    def test_identical_content(self):
        plan, _ = self._plan(None, None)
        assert plan is not None and plan.klass == DELTA_IDENTICAL
        assert plan.cone.sum() == 0

    def test_cone_is_closed(self):
        plan, new = self._plan(None, ("add-dep", 1))
        assert plan is not None
        n = new.n_vars
        for row in np.where(np.abs(new.clauses) <= n, new.clauses, 0):
            hit = [plan.cone[abs(int(v)) - 1] for v in row if v != 0]
            assert all(hit) or not any(hit), "clause spans the cone"

    def test_max_delta_cutoff_blocks_plan(self):
        plan, _ = self._plan(None, ("add-conflict", 2),
                             max_delta_ratio=0.01)
        assert plan is None

    def test_vocab_mismatch_no_plan(self):
        plan_base = port(bundle_catalog())
        (_, idx), eng = solve_cold(plan_base)
        index = indexed(ClauseSetIndex, ttelemetry.Registry(), plan_base,
                        fingerprint(plan_base), eng, idx)
        new = port(bundle_catalog(n_bundles=7))
        assert index.plan(new, fingerprint(new), 1 << 24) is None

    def test_tight_budget_no_plan(self):
        base = port(bundle_catalog())
        (_, idx), eng = solve_cold(base)
        index = indexed(ClauseSetIndex, ttelemetry.Registry(), base,
                        fingerprint(base), eng, idx)
        new = port(bundle_catalog(tweak=("add-conflict", 2)))
        assert index.plan(new, fingerprint(new), 1 << 24) is not None
        assert index.plan(new, fingerprint(new), 64) is None

    def test_backtracking_solves_never_indexed(self):
        base = port(bundle_catalog())
        index = ClauseSetIndex(registry=ttelemetry.Registry())
        index.store(fingerprint(base), base, np.zeros(base.n_vars, bool),
                    10, backtracks=3)
        assert len(index) == 0

    def test_lru_capacity(self):
        index = ClauseSetIndex(capacity=2, registry=ttelemetry.Registry())
        for b in range(4):
            p = port(bundle_catalog(tweak=("add-conflict", b)))
            index.store(fingerprint(p), p, np.zeros(p.n_vars, bool), 5, 0)
        assert len(index) == 2
        assert sum(len(b) for b in index._by_vocab.values()) == 2

    def test_counters_and_span(self):
        reg = ttelemetry.Registry()
        base = port(bundle_catalog())
        (_, idx), eng = solve_cold(base)
        index = indexed(ClauseSetIndex, reg, base, fingerprint(base), eng,
                        idx)
        new = port(bundle_catalog(tweak=("add-dep", 3)))
        other = port(bundle_catalog(n_bundles=2))
        assert index.plan(new, fingerprint(new), 1 << 24) is not None
        assert index.plan(other, fingerprint(other), 1 << 24) is None
        index.note_served()
        index.note_fallback()
        snap = reg.snapshot()
        assert snap["deppy_incremental_delta_total"] == {"additive": 1,
                                                         "none": 1}
        assert snap["deppy_incremental_hits_total"] == 1
        assert snap["deppy_incremental_warm_fallbacks_total"] == 1
        assert index.hit_ratio() == 0.5
        spans = [s for s in reg.recent_spans()
                 if s["name"] == "incremental.delta"]
        assert [s["attrs"]["klass"] for s in spans] == ["additive", "none"]


# ------------------------------------------------------- warm identity


def _fuzz(seed: int, n_cases: int) -> int:
    """Warm served or fallen back, the answer equals the cold solve's;
    returns how many were served warm."""
    rng = random.Random(seed)
    served = 0
    for _ in range(n_cases):
        s = rng.randint(0, 10 ** 9)
        base = port(bundle_catalog(random.Random(s)))
        (outcome, idx), eng = solve_cold(base)
        if outcome != "sat" or eng.backtracks != 0:
            continue
        index = indexed(ClauseSetIndex, ttelemetry.Registry(), base,
                        fingerprint(base), eng, idx, max_delta_ratio=1.0)
        kind = rng.choice(KINDS)
        new = port(bundle_catalog(random.Random(s),
                                  tweak=(kind, rng.randrange(6))))
        plan = index.plan(new, fingerprint(new), 1 << 24)
        cold, _ = solve_cold(new)
        if plan is None:
            continue
        res = tinc.attempt(plan)
        if res is None:
            continue
        served += 1
        assert ("sat", tuple(res.installed_idx)) == cold, kind
    return served


class TestWarmIdentity:
    @pytest.mark.parametrize("seed", [0xD417A, 1, 2])
    def test_fuzz_differential_warm_vs_cold(self, seed):
        n = 24
        assert _fuzz(seed, n) >= n // 8, "warm tier is inert"

    @pytest.mark.slow
    @pytest.mark.parametrize("seed", range(3, 23))
    def test_fuzz_differential_warm_vs_cold_deep(self, seed):
        n = 120
        assert _fuzz(seed, n) >= n // 8, "warm tier is inert"

    def test_chaos_poisoned_model_falls_back(self):
        base = port(bundle_catalog())
        (_, idx), eng = solve_cold(base)
        index = indexed(ClauseSetIndex, ttelemetry.Registry(), base,
                        fingerprint(base), eng, idx)
        new = port(bundle_catalog(tweak=("add-conflict", 2)))
        plan = index.plan(new, fingerprint(new), 1 << 24)
        assert plan is not None
        plan.warm_assign = poisoned(plan, new)
        with pytest.raises(WarmStartConflict):
            HostEngine(new).solve_warm(plan.warm_assign, plan.cone)
        assert tinc.attempt(plan) is None
        assert solve_cold(new)[0][0] == "sat"

    def test_unsat_delta_falls_back_to_cold_core(self):
        base = port(bundle_catalog(n_bundles=2))
        (_, idx), eng = solve_cold(base)
        index = indexed(ClauseSetIndex, ttelemetry.Registry(), base,
                        fingerprint(base), eng, idx, max_delta_ratio=1.0)
        vs = bundle_catalog(n_bundles=2)
        vs[0] = jsat.variable(vs[0].identifier,
                              *(list(vs[0].constraints)
                                + [jsat.prohibited()]))
        new = port(vs)
        plan = index.plan(new, fingerprint(new), 1 << 24)
        cold, _ = solve_cold(new)
        assert cold[0] == "unsat" and cold[1]
        if plan is not None:
            assert tinc.attempt(plan) is None


# ------------------------------------------------------- device screen


def _screen_case():
    """Warm plans over the reference's churn shape, and the same plans
    with a poisoned prefix: (reference problems, port problems, models,
    cones)."""
    jps, tps, models, cones = [], [], [], []
    for kind in KINDS:
        jp, tp, jn, tn = plan_pair(bundle_catalog(),
                                   bundle_catalog(tweak=(kind, 4)),
                                   max_delta_ratio=1.0)
        for warm in (tp.warm_assign, poisoned(tp, tn)):
            jps.append(jn)
            tps.append(tn)
            models.append(warm > 0)
            cones.append(tp.cone)
    return jps, tps, models, cones


class TestWarmScreen:
    def test_screen_flags_conflicting_prefix(self):
        p = port(bundle_catalog())
        (_, idx), _ = solve_cold(p)
        good = np.zeros(p.n_vars, bool)
        good[list(idx)] = True
        bad = np.zeros(p.n_vars, bool)
        cone = np.zeros(p.n_vars, bool)
        ok = tdriver.warm_screen([p, p], [good, bad], [cone, cone],
                                 device="cpu")
        assert ok.dtype == bool and list(ok) == [True, False]

    def test_screen_open_cone_is_not_a_conflict(self):
        p = port(bundle_catalog())
        ok = tdriver.warm_screen([p], [np.zeros(p.n_vars, bool)],
                                 [np.ones(p.n_vars, bool)], device="cpu")
        assert list(ok) == [True]

    def test_equals_reference_bit_for_bit(self):
        jps, tps, models, cones = _screen_case()
        want = np.asarray(jdriver.warm_screen(jps, models, cones))
        got = tdriver.warm_screen(tps, models, cones, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got[0::2].all() and not got[1::2].any()

    def test_random_prefixes_equal_reference(self):
        """Random models and cones over catalogs with AtMost rows and
        activation literals: every verdict equals the reference's,
        True and False both among them."""
        rng = np.random.default_rng(7)
        jvars = [bundle_catalog(tweak=(k, b)) for k in KINDS
                 for b in (0, 5)]
        jps = [jencode(v) for v in jvars]
        tps = [port(v) for v in jvars]
        models, cones = [], []
        for p in tps:
            (_, idx), _ = solve_cold(p)
            m = np.zeros(p.n_vars, bool)
            m[list(idx)] = True
            flip = rng.random(p.n_vars) < 0.05
            models.append(m ^ flip)
            cones.append(rng.random(p.n_vars) < 0.1)
        want = np.asarray(jdriver.warm_screen(jps, models, cones))
        got = tdriver.warm_screen(tps, models, cones, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()

    def test_chunks_at_max_lanes(self, monkeypatch):
        jps, tps, models, cones = _screen_case()
        whole = tdriver.warm_screen(tps, models, cones, device="cpu")
        monkeypatch.setattr(tdriver, "MAX_LANES", 4)
        calls = []
        orig = tdriver.core.warm_check_phase

        def spy(*args, **kw):
            calls.append(args[0].shape[0])
            return orig(*args, **kw)

        monkeypatch.setattr(tdriver.core, "warm_check_phase", spy)
        got = tdriver.warm_screen(tps, models, cones, device="cpu")
        np.testing.assert_array_equal(got, whole)
        assert calls == [4] * 3

    def test_span_names_the_lanes(self):
        jps, tps, models, cones = _screen_case()
        tdriver.warm_screen(tps[:5], models[:5], cones[:5], device="cpu")
        (span,) = [s for s in ttelemetry.default_registry().recent_spans()
                   if s["name"] == "driver.warm_screen"]
        assert span["attrs"]["lanes"] == 5

    def test_cuda_without_a_card_raises(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        p = port(bundle_catalog())
        z = np.zeros(p.n_vars, bool)
        with pytest.raises(RuntimeError, match="cuda"):
            tdriver.warm_screen([p], [z], [z])


# ---------------------------------------------- the screen's error rule


def _raising_screen(monkeypatch, error=None):
    def boom(*args, **kw):
        raise (error if error is not None
               else RuntimeError("screen launch failed"))

    monkeypatch.setattr(tdriver, "warm_screen", boom)


class _FaultEvents:
    """While on, the default registry's ``fault`` events."""

    def __enter__(self):
        self.events = []
        self._fn = lambda e: (self.events.append(e)
                              if e.get("kind") == "fault" else None)
        ttelemetry.default_registry().add_forwarder(self._fn)
        return self

    def __exit__(self, *exc):
        ttelemetry.default_registry().remove_forwarder(self._fn)

    def of(self, fault: str):
        return [e for e in self.events if e.get("fault") == fault]


def _plans(n: int):
    out = []
    for b in range(n):
        _, tp, _, _ = plan_pair(bundle_catalog(),
                                bundle_catalog(tweak=("add-dep", b)),
                                max_delta_ratio=1.0)
        out.append(tp)
    return out


def test_screen_error_on_cuda_raises(monkeypatch):
    """On the card a screen launch error degrades like the reference's
    (the event, then all-True); only a defect of the tree raises: a
    kernel that does not build, a shape the wrapper refuses."""
    _raising_screen(monkeypatch)
    with _FaultEvents() as ev:
        assert tinc.screen(_plans(2), device="cuda") == [True] * 2
    (e,) = ev.of("incremental_screen_failed")
    assert e["error"] == "RuntimeError" and e["lanes"] == 2
    for error in (KernelBuildError("nvcc failed on search.cu"),
                  KernelLaunchError("screen launch refused"),
                  ValueError("shape refused"), TypeError("dtype refused")):
        _raising_screen(monkeypatch, error)
        with _FaultEvents() as ev:
            with pytest.raises(type(error), match="refused|nvcc"):
                tinc.screen(_plans(2), device="cuda")
        assert ev.of("incremental_screen_failed") == []


def test_screen_on_cuda_without_a_card_raises(monkeypatch):
    """On a machine without a card the screen on ``cuda`` raises the
    driver's ``NoDeviceError``: it does not degrade to all-True and let
    host warm attempts run in its place."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _FaultEvents() as ev:
        with pytest.raises(tdriver.NoDeviceError, match="cuda"):
            tinc.screen(_plans(2), device="cuda")
    assert ev.of("incremental_screen_failed") == []


def test_screen_error_on_cpu_degrades_to_all_true(monkeypatch):
    _raising_screen(monkeypatch)
    with _FaultEvents() as ev:
        assert tinc.screen(_plans(3), device="cpu") == [True] * 3
    (e,) = ev.of("incremental_screen_failed")
    assert e["error"] == "RuntimeError" and e["lanes"] == 3


def _seeded(sched, base_jvars):
    """Index ``base`` in ``sched``'s tier from a host solve."""
    base = port(base_jvars)
    (_, idx), eng = solve_cold(base)
    model = np.zeros(base.n_vars, bool)
    model[list(idx)] = True
    sched.incremental.store(fingerprint(base), base, model, eng.steps,
                            eng.backtracks)


def test_screen_error_on_cuda_reaches_every_coalesced_submitter(monkeypatch):
    """A warm flush of two requests on ``device="cuda"`` whose screen
    fails as a kernel build would (no card is asked): both submitters
    get the error, nothing is served around it, nothing falls back to
    host warm attempts, and no event turns it into all-True.  (A launch
    error degrades instead: ``test_screen_error_on_cuda_raises``.)"""
    _raising_screen(monkeypatch,
                    KernelBuildError("screen launch failed"))
    attempted = []
    monkeypatch.setattr(tinc, "attempt",
                        lambda *a, **k: attempted.append(1))
    reg = ttelemetry.Registry()
    sched = Scheduler(device="cuda", max_wait_ms=300.0, registry=reg)
    _seeded(sched, bundle_catalog())
    errors = [None, None]
    gate = threading.Barrier(2)

    def client(i):
        gate.wait()
        try:
            sched.submit([variables_from_objects(
                bundle_catalog(tweak=("add-dep", i)))])
        except RuntimeError as e:
            errors[i] = e

    sched.start()
    try:
        with _FaultEvents() as ev:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
    finally:
        sched.stop()
    assert [str(e) for e in errors] == ["screen launch failed"] * 2
    assert reg.snapshot()["deppy_sched_dispatches_total"] == 1
    assert attempted == []
    assert ev.of("incremental_screen_failed") == []
    assert reg.snapshot().get("deppy_incremental_hits_total", 0) == 0
    assert len(sched.cache) == 0


def test_screen_error_on_cpu_serves_the_cold_answers(monkeypatch):
    """On ``device="cpu"`` the reference's rule stands: the event, then
    all-True, and every answer equals the cold solve's."""
    _raising_screen(monkeypatch)
    docs = [bundle_catalog(tweak=("add-dep", b)) for b in range(3)]
    sched = Scheduler(device="cpu", registry=ttelemetry.Registry())
    _seeded(sched, bundle_catalog())
    with _FaultEvents() as ev:
        got = sched.submit([variables_from_objects(d) for d in docs])
    off = Scheduler(device="cpu", incremental="off",
                    registry=ttelemetry.Registry())
    want = off.submit([variables_from_objects(d) for d in docs])
    assert got == want
    (e,) = ev.of("incremental_screen_failed")
    assert e["lanes"] == 3


# ------------------------------------------------- scheduler integration


def _render(io, results):
    return [io.result_to_dict(r) for r in results]


def _replay(sched, requests, io, tvars: bool, batch: int = 1):
    """Submit ``requests`` ``batch`` at a time: (rendered answers, steps
    per submit)."""
    out, steps = [], []
    for lo in range(0, len(requests), batch):
        reqs = requests[lo: lo + batch]
        if tvars:
            reqs = [variables_from_objects(r) for r in reqs]
        st: dict = {}
        out += _render(io, sched.submit(reqs, stats=st))
        steps.append(st["steps"])
    return out, steps


REF = dict(portfolio="off", speculate="off")


@pytest.mark.parametrize("batch", [1, 4], ids=["serial", "batched"])
def test_host_backend_equals_reference(batch):
    """The port's ``Scheduler(backend="host")`` against the reference's
    with the tier on: answers, steps per submit, hit ratio and fallbacks
    equal; and the tier off gives the same answers."""
    requests = jchurn_requests(16, 4, 12)
    jreg, treg = jtelemetry.Registry(), ttelemetry.Registry()
    ref = JScheduler(backend="host", registry=jreg, **REF)
    mine = Scheduler(backend="host", registry=treg)
    want = _replay(ref, requests, jio, False, batch)
    got = _replay(mine, requests, tio, True, batch)
    assert got == want
    assert mine.incremental.hit_ratio() == ref.incremental.hit_ratio() > 0
    for name in ("deppy_incremental_hits_total",
                 "deppy_incremental_warm_fallbacks_total",
                 "deppy_incremental_delta_total"):
        assert treg.snapshot().get(name) == jreg.snapshot().get(name)
    off = Scheduler(backend="host", incremental="off",
                    registry=ttelemetry.Registry())
    assert _replay(off, requests, tio, True, batch)[0] == got[0]


def test_device_backend_equals_reference():
    """The port's ``Scheduler(device="cpu")`` against the reference's
    device scheduler, the tier on both: one cold solve, then a batched
    submit of four one-bundle deltas whose warm flush runs the screen on
    both sides, then serial deltas; answers and steps equal, and the
    tier off answers alike."""
    requests = ([bundle_catalog()]
                + [bundle_catalog(tweak=("add-dep", b)) for b in range(4)]
                + [bundle_catalog(tweak=(k, 5))
                   for k in ("flip-dep", "add-atmost", "drop-dep")])
    jreg, treg = jtelemetry.Registry(), ttelemetry.Registry()
    ref = JScheduler(backend="tpu", registry=jreg, **REF)
    mine = Scheduler(device="cpu", registry=treg)
    spans = []
    orig = tdriver.warm_screen

    def spy(problems, *a, **k):
        spans.append(len(problems))
        return orig(problems, *a, **k)

    tdriver.warm_screen = spy
    try:
        got, want = [], []
        for reqs in ([requests[0]], requests[1:5], *[[r] for r in
                                                     requests[5:]]):
            got.append(_replay(mine, reqs, tio, True, len(reqs)))
            want.append(_replay(ref, reqs, jio, False, len(reqs)))
    finally:
        tdriver.warm_screen = orig
    assert got == want
    assert spans == [4]
    assert mine.incremental.hit_ratio() == ref.incremental.hit_ratio() > 0
    off = Scheduler(device="cpu", incremental="off",
                    registry=ttelemetry.Registry())
    assert _replay(off, requests, tio, True)[0] == \
        [a for g in got for a in g[0]]


def _mk_sched(**kw):
    s = Scheduler(backend="host", registry=ttelemetry.Registry(), **kw)
    s.start()
    return s


def _tv(jvars):
    return variables_from_objects(jvars)


class TestSchedulerIncremental:
    def test_warm_hit_and_byte_identity_vs_off(self):
        on = _mk_sched()
        off = _mk_sched(incremental="off")
        try:
            docs = [bundle_catalog(), bundle_catalog(tweak=("add-dep", 3)),
                    bundle_catalog(tweak=("add-conflict", 1))]
            got_on = [on.submit([_tv(d)])[0] for d in docs]
            got_off = [off.submit([_tv(d)])[0] for d in docs]
            assert got_on == got_off
            assert off.incremental is None and off.cache.incremental is None
            assert on.incremental is not None
            assert on.cache.incremental is on.incremental
            assert on.incremental.hit_ratio() > 0.0
        finally:
            on.stop()
            off.stop()

    def test_exact_repeat_still_hits_exact_cache(self):
        s = _mk_sched()
        try:
            doc = bundle_catalog()
            first = s.submit([_tv(doc)])[0]
            hits_before = s.cache._hits.value
            assert s.submit([_tv(doc)])[0] == first
            assert s.cache._hits.value == hits_before + 1
        finally:
            s.stop()

    def test_warm_lanes_coalesce_in_incremental_class(self):
        s = _mk_sched()
        try:
            s.submit([_tv(bundle_catalog())])
            seen, classes = [], []
            orig = s._solve_lanes
            orig_enqueue = s._enqueue

            def spy(lanes, timing=None):
                seen.append([lane.warm is not None for lane in lanes])
                return orig(lanes, timing)

            def enqueue(group):
                classes.append(group.size_class)
                return orig_enqueue(group)

            s._solve_lanes = spy
            s._enqueue = enqueue
            s.submit([_tv(bundle_catalog(tweak=("add-dep", 2))),
                      _tv(bundle_catalog(tweak=("add-dep", 4)))])
            assert seen == [[True, True]]
            assert classes == [tscheduler_mod.INCREMENTAL_CLASS] == [-1]
        finally:
            s.stop()

    def test_mixed_submit_splits_cold_and_warm_groups(self):
        """One submit holding a warm-plannable problem and a problem of
        another vocabulary queues two groups; the answers come back in
        input order and equal the tier-off answers."""
        s = _mk_sched()
        off = _mk_sched(incremental="off")
        try:
            s.submit([_tv(bundle_catalog())])
            docs = [bundle_catalog(n_bundles=3),
                    bundle_catalog(tweak=("add-dep", 1))]
            seen = []
            orig = s._solve_lanes

            def spy(lanes, timing=None):
                seen.append(sorted(lane.warm is not None for lane in lanes))
                return orig(lanes, timing)

            s._solve_lanes = spy
            st: dict = {}
            got = s.submit([_tv(d) for d in docs], stats=st)
            assert sorted(seen) == [[False], [True]]
            assert got == off.submit([_tv(d) for d in docs])
            assert st["report"].n_problems == 2
        finally:
            s.stop()
            off.stop()

    def test_poisoned_entry_falls_back_through_scheduler(self):
        s = _mk_sched()
        try:
            s.submit([_tv(bundle_catalog())])
            with s.incremental._lock:
                for e in s.incremental._entries.values():
                    e.model[:] = False
            fb_before = s.incremental._c_fallbacks.value
            got = s.submit([_tv(bundle_catalog(tweak=("add-dep", 3)))])[0]
            cold = _mk_sched(incremental="off")
            try:
                want = cold.submit(
                    [_tv(bundle_catalog(tweak=("add-dep", 3)))])[0]
            finally:
                cold.stop()
            assert got == want
            assert s.incremental._c_fallbacks.value == fb_before + 1
        finally:
            s.stop()

    def test_warm_served_lanes_index_cold_equivalent_steps(self):
        s = _mk_sched()
        try:
            s.submit([_tv(bundle_catalog())])
            s.submit([_tv(bundle_catalog(tweak=("add-dep", 3)))])
            with s.incremental._lock:
                entries = list(s.incremental._entries.values())
            base_rows = problem_rows(port(bundle_catalog()))
            (base_entry,) = [e for e in entries if e.rows == base_rows]
            assert len(entries) == 2
            for e in entries:
                assert e.steps >= base_entry.steps
        finally:
            s.stop()

    def test_exact_hits_refresh_index_recency(self):
        s = _mk_sched()
        try:
            a, b = bundle_catalog(), bundle_catalog(tweak=("add-dep", 1))
            s.submit([_tv(a)])
            s.submit([_tv(b)])
            s.submit([_tv(a)])
            key_a = fingerprint(port(a))
            with s.incremental._lock:
                (bucket,) = s.incremental._by_vocab.values()
                assert next(reversed(bucket)) == key_a
        finally:
            s.stop()

    def test_unmeasured_and_degraded_lanes_are_not_indexed(self):
        s = Scheduler(backend="host", registry=ttelemetry.Registry())
        lane = tscheduler_mod._Lane(port(bundle_catalog()), "k", None,
                                    1 << 24, None)
        lane.result = {v.identifier: False for v in lane.problem.variables}
        s._maybe_cache(lane)
        assert len(s.incremental) == 0
        lane.backtracks = 0
        lane.degraded = True
        s._maybe_cache(lane)
        assert len(s.incremental) == 0
        lane.degraded = False
        s._maybe_cache(lane)
        assert len(s.incremental) == 1

    @pytest.mark.parametrize("off", ["off", "0", "false", "no", "OFF"])
    def test_env_off_switch(self, monkeypatch, off):
        monkeypatch.setenv("DEPPY_GPU_INCREMENTAL", off)
        s = Scheduler(backend="host", registry=ttelemetry.Registry())
        assert s.incremental is None
        assert s.cache.incremental is None

    def test_default_is_on_with_the_reference_defaults(self):
        s = Scheduler(registry=ttelemetry.Registry())
        assert s.device == "cuda"
        assert s.incremental.capacity == \
            tscheduler_mod.DEFAULT_INCREMENTAL_INDEX == 512
        assert s.incremental.max_delta_ratio == \
            tscheduler_mod.DEFAULT_INCREMENTAL_MAX_DELTA == 0.25

    def test_knobs_and_arguments(self, monkeypatch):
        # One knob, the on/off switch; the index's size and cutoff are
        # arguments whose defaults are the reference's.
        from deppy_tpu.sched import scheduler as jscheduler_mod

        monkeypatch.setenv("DEPPY_GPU_INCREMENTAL", "on")
        s = Scheduler(device="cpu", registry=ttelemetry.Registry())
        assert (s.incremental.capacity, s.incremental.max_delta_ratio) == \
            (jscheduler_mod.DEFAULT_INCREMENTAL_INDEX,
             jscheduler_mod.DEFAULT_INCREMENTAL_MAX_DELTA)
        s = Scheduler(device="cpu", incremental="on",
                      incremental_max_delta=0.1, incremental_index_size=3,
                      registry=ttelemetry.Registry())
        assert (s.incremental.capacity, s.incremental.max_delta_ratio) == \
            (3, 0.1)
        monkeypatch.setenv("DEPPY_GPU_INCREMENTAL", "off")
        assert Scheduler(device="cpu", incremental_index_size=3,
                         registry=ttelemetry.Registry()).incremental is None


# -------------------------------------------------- cache satellites


class TestCacheSatellites:
    def test_fingerprint_memoized_on_problem(self, monkeypatch):
        p = port(bundle_catalog())
        first = fingerprint(p)
        monkeypatch.setattr(np, "lexsort", lambda *a, **k: (_ for _ in ()
                            ).throw(AssertionError("re-sorted")))
        assert fingerprint(p) == first

    def test_entries_and_bytes_gauges(self):
        cache = ResultCache(capacity=2, registry=ttelemetry.Registry())
        solution = {"a": True, "b": False}
        cache.store("k1", 100, solution)
        cache.store("k2", 100, solution)
        assert cache._g_entries.value == 2
        assert cache._g_bytes.value > 0
        b2 = cache._g_bytes.value
        cache.store("k3", 100, solution)
        assert cache._g_entries.value == 2
        assert cache._g_bytes.value == b2
        cache.store("k4", 50, Incomplete())
        assert cache._g_entries.value == 2
        assert cache.lookup("k4", 200) is MISS
        assert cache._g_entries.value == 1

    def test_lookup_or_plan(self):
        index = ClauseSetIndex(registry=ttelemetry.Registry())
        cache = ResultCache(8, registry=ttelemetry.Registry(),
                            incremental=index)
        a, b = port(bundle_catalog()), port(bundle_catalog(
            tweak=("add-dep", 1)))
        assert cache.lookup_or_plan(a, fingerprint(a), 1 << 24) == \
            (MISS, None)
        (_, idx), eng = solve_cold(a)
        model = np.zeros(a.n_vars, bool)
        model[list(idx)] = True
        index.store(fingerprint(a), a, model, eng.steps, eng.backtracks)
        index.store(fingerprint(b), b, model, eng.steps, eng.backtracks)
        cache.store(fingerprint(a), 1 << 24, {"x": True})
        hit, plan = cache.lookup_or_plan(a, fingerprint(a), 1 << 24)
        assert hit == {"x": True} and plan is None
        # The exact hit touched a: it leads the scan window again.
        assert next(reversed(index._entries)) == fingerprint(a)
        c = port(bundle_catalog(tweak=("add-dep", 2)))
        hit, plan = cache.lookup_or_plan(c, fingerprint(c), 1 << 24)
        assert hit is MISS and plan is not None and plan.problem is c
        plain = ResultCache(8, registry=ttelemetry.Registry())
        assert plain.lookup_or_plan(c, fingerprint(c), 1 << 24) == \
            (MISS, None)
