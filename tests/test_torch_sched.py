"""The port's request scheduler against the JAX package's.

The cases of ``tests/test_sched.py`` (the contract), each run on both
schedulers with the same submits: the reference
``Scheduler(backend="tpu", incremental="off", portfolio="off",
speculate="off")`` (budget escalation off, ``STAGE1_STEPS = 0``, its
default) or ``backend="host"``, and the port's ``Scheduler(device="cpu")``
or ``backend="host"``.  Answers are compared rendered (``io.result_to_dict``),
with per-request steps and the dispatch report's counters, tolerance 0;
each request also against the port's unscheduled ``BatchResolver``.
Then the cache, the fingerprint and the tenant policy as units, and the
port's guards (no card, unported tiers).
"""

from __future__ import annotations

import functools
import json
import threading

import numpy as np
import pytest
import torch

from deppy_tpu import faults as jfaults
from deppy_tpu import io as jio
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import (gvk_conflict_catalog, operatorhub_catalog,
                              pinned_tenant_catalog, version_pinned_chains)
from deppy_tpu.resolution.facade import BatchResolver as JBatchResolver
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sat.errors import Incomplete as JIncomplete
from deppy_tpu.sat.errors import NotSatisfiable as JNotSatisfiable
from deppy_tpu.sched import ResultCache as JResultCache
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu.sched import fingerprint as jfingerprint
from deppy_tpu.sched import scheduler as jscheduler_mod
from deppy_tpu.sched.cache import MISS as JMISS
from deppy_tpu.sched.fair import TenantPolicy as JTenantPolicy
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.resolution import BatchResolver as TBatchResolver
from deppy_tpu_torch.sat.encode import encode as tencode
from deppy_tpu_torch.sat.errors import Incomplete as TIncomplete
from deppy_tpu_torch.sat.errors import InternalSolverError
from deppy_tpu_torch.sat.errors import NotSatisfiable as TNotSatisfiable
from deppy_tpu_torch.sched import ResultCache as TResultCache
from deppy_tpu_torch.sched import Scheduler as TScheduler
from deppy_tpu_torch.sched import fingerprint as tfingerprint
from deppy_tpu_torch.sched import scheduler as tscheduler_mod
from deppy_tpu_torch.sched.cache import MISS as TMISS
from deppy_tpu_torch.sched.fair import TenantPolicy as TTenantPolicy

PACKAGES = ("reference", "port")
BACKENDS = ("device", "host")
TELEMETRY = {"reference": jtelemetry, "port": ttelemetry}
IO = {"reference": jio, "port": tio}
# The reference's tiers the port has not ported, off on its side.
REF_OFF = dict(incremental="off", portfolio="off", speculate="off")
# The dispatch report's counters both drivers fill; walls and the
# backend label differ by nature.
REPORT_FIELDS = ("n_problems", "outcomes", "steps", "backtracks",
                 "decisions", "propagation_rounds", "batch_lanes",
                 "live_lanes", "pad_cells", "live_cells", "n_chunks",
                 "n_buckets", "host_fallback_rows")


def within(seconds: float):
    """Fail the test when its body runs past ``seconds``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["err"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} ran past its {seconds} s limit")
            if "err" in box:
                raise box["err"]
        return run
    return deco


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each package's fault plan and default registry, and the
    reference's breaker, per test; the reference's escalation off."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    prev_breaker = jfaults.set_default_breaker(jfaults.CircuitBreaker())
    prev = [(jfaults.configure_plan(None), tfaults.configure_plan(None)),
            (jtelemetry.set_default_registry(jtelemetry.Registry()),
             ttelemetry.set_default_registry(ttelemetry.Registry()))]
    yield
    jfaults.configure_plan(prev[0][0])
    tfaults.configure_plan(prev[0][1])
    jtelemetry.set_default_registry(prev[1][0])
    ttelemetry.set_default_registry(prev[1][1])
    jfaults.set_default_breaker(prev_breaker)


def make(package: str, backend: str, **kw):
    """A scheduler of ``package`` on ``backend`` ("device" or "host")."""
    if package == "reference":
        return JScheduler(backend="tpu" if backend == "device" else "host",
                          **REF_OFF, **kw)
    return TScheduler(backend=backend, device="cpu", **kw)


def unscheduled(backend: str, **kw):
    if backend == "host":
        return TBatchResolver(backend="host", **kw)
    return TBatchResolver(device="cpu", **kw)


def own(package: str, jvars):
    """``jvars`` (reference variables) in ``package``'s vocabulary."""
    return jvars if package == "reference" else variables_from_objects(jvars)


def render(package: str, result) -> str:
    return json.dumps(IO[package].result_to_dict(result), sort_keys=True)


def report_fields(rep):
    """The report's shared counters (None for a request served wholly
    from the cache, which dispatches nothing)."""
    if rep is None:
        return None
    d = rep.to_dict()
    return {k: d[k] for k in REPORT_FIELDS}


def drive(sched, requests, deadlines=None, **kw):
    """Submit every request from its own thread, all at once; each slot
    of the result is ``(answers, stats)`` or the exception raised."""
    out = [None] * len(requests)

    def go(i):
        st: dict = {}
        try:
            res = sched.submit(
                requests[i], stats=st,
                deadline_s=deadlines[i] if deadlines else None, **kw)
            out[i] = (res, st)
        except BaseException as e:  # noqa: BLE001 — compared by the test
            out[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return out


def _doc(i, dep=("b", "c")):
    return {"variables": [
        {"id": f"a{i}", "constraints": [
            {"type": "mandatory"},
            {"type": "dependency", "ids": list(dep)}]},
        {"id": dep[0]}, {"id": dep[1]},
    ]}


def _problem(package: str, ident: str = "a"):
    return IO[package].problems_from_document(
        {"variables": [{"id": ident,
                        "constraints": [{"type": "mandatory"}]}]})[0]


UNSAT = {"variables": [{"id": "u", "constraints": [
    {"type": "mandatory"}, {"type": "prohibited"}]}]}
HARD = {"variables": [
    {"id": "x", "constraints": [
        {"type": "mandatory"}, {"type": "dependency", "ids": ["y", "z"]}]},
    {"id": "y", "constraints": [{"type": "dependency", "ids": ["w"]}]},
    {"id": "z"},
    {"id": "w", "constraints": [{"type": "conflict", "id": "z"}]},
]}

# Six requests of two cluster states each, all of one size class.
FLEET = [[gvk_conflict_catalog(8, 3, 4, seed=2 * i + j) for j in range(2)]
         for i in range(6)]


def _size_class(jvars) -> int:
    p = tencode(variables_from_objects(jvars))
    return tdriver._bucket(tdriver._cost_proxy(p))


# ----------------------------------------------------- coalescing


@pytest.mark.parametrize("backend", BACKENDS)
@within(300)
def test_concurrent_submits_coalesce_and_match_reference(backend):
    """Six concurrent requests flush as one dispatch (max-fill) on both
    schedulers: every answer, per-request step count and the dispatch
    report's counters equal the reference's, and every request equals
    the port's unscheduled solve of it."""
    assert len({_size_class(v) for r in FLEET for v in r}) == 1
    lanes = sum(len(r) for r in FLEET)
    seen = {}
    for package in PACKAGES:
        reg = TELEMETRY[package].Registry()
        sched = make(package, backend, max_wait_ms=60_000, max_fill=lanes,
                     cache_size=64, registry=reg)
        sched.start()
        try:
            out = drive(sched, [[own(package, v) for v in r]
                                for r in FLEET])
        finally:
            sched.stop()
        assert all(isinstance(o, tuple) for o in out), out
        snap = reg.snapshot()
        assert snap["deppy_sched_dispatches_total"] == 1 < len(FLEET)
        assert snap["deppy_sched_flushes_total"] == {"fill": 1}
        assert snap["deppy_sched_coalesced_requests_total"] == len(FLEET)
        assert snap["deppy_cache_misses_total"] == lanes
        seen[package] = (
            [[render(package, r) for r in res] for res, _ in out],
            [st["steps"] for _, st in out],
            [report_fields(st["report"]) for _, st in out])
    assert seen["port"] == seen["reference"]
    answers, steps, _ = seen["port"]
    for i, r in enumerate(FLEET):
        ref = unscheduled(backend)
        want = ref.solve([own("port", v) for v in r])
        assert answers[i] == [render("port", w) for w in want]
        assert steps[i] == ref.last_steps


@pytest.mark.parametrize("backend", BACKENDS)
@within(240)
def test_repeat_is_a_cache_hit_with_zero_steps(backend):
    seen = {}
    for package in PACKAGES:
        reg = TELEMETRY[package].Registry()
        sched = make(package, backend, max_wait_ms=0.0, registry=reg)
        sched.start()
        try:
            first, again = {}, {}
            a = sched.submit([own(package, v) for v in FLEET[0]],
                             stats=first)
            b = sched.submit([own(package, v) for v in FLEET[0]],
                             stats=again)
        finally:
            sched.stop()
        snap = reg.snapshot()
        assert snap["deppy_sched_dispatches_total"] == 1
        assert again["steps"] == 0 and again["report"] is None
        assert [render(package, r) for r in a] == \
            [render(package, r) for r in b]
        seen[package] = ([render(package, r) for r in b], first["steps"],
                         snap["deppy_cache_hits_total"],
                         snap["deppy_cache_misses_total"],
                         snap["deppy_cache_hit_ratio"],
                         snap["deppy_cache_entries"])
    assert seen["port"] == seen["reference"]
    assert seen["port"][2:] == (2, 2, 0.5, 2)


@pytest.mark.parametrize("backend", BACKENDS)
@within(300)
def test_unsat_and_incomplete_match_reference(backend):
    """UNSAT cores and budget-bound Incompletes (``max_steps=3``) survive
    the scheduled path, request by request (no cache: every request
    dispatches)."""
    docs = [UNSAT, HARD, {"problems": [UNSAT, HARD]}]
    tenants = [pinned_tenant_catalog(seed=s) for s in range(1, 4)]
    seen = {}
    for package in PACKAGES:
        sched = make(package, backend, max_wait_ms=0.0, max_steps=3,
                     cache_size=0)
        requests = [IO[package].problems_from_document(d) for d in docs]
        requests.append([own(package, v) for v in tenants])
        sched.start()
        try:
            rows = []
            for req in requests:
                st: dict = {}
                res = sched.submit(req, stats=st)
                rows.append(([render(package, r) for r in res],
                             st["steps"], report_fields(st["report"])))
        finally:
            sched.stop()
        seen[package] = rows
    assert seen["port"] == seen["reference"]
    statuses = [json.loads(r)["status"] for r in seen["port"][0][0]]
    assert statuses == ["unsat"]
    assert json.loads(seen["port"][1][0][0])["status"] == "incomplete"
    for req, (answers, steps, _) in zip(
            [tio.problems_from_document(d) for d in docs]
            + [[own("port", v) for v in tenants]], seen["port"]):
        ref = unscheduled(backend, max_steps=3)
        assert [render("port", r) for r in ref.solve(req)] == answers
        assert ref.last_steps == steps


@pytest.mark.parametrize("doc,error", [
    ({"variables": [{"id": "a", "constraints": [
        {"type": "mandatory"}, {"type": "dependency", "ids": ["ghost"]}]}]},
     "InternalSolverError"),
    ({"variables": [{"id": "a"}, {"id": "a"}]}, "DuplicateIdentifier"),
], ids=["unknown-reference", "duplicate"])
@within(60)
def test_malformed_request_raises_before_it_queues(doc, error):
    seen = {}
    for package in PACKAGES:
        reg = TELEMETRY[package].Registry()
        sched = make(package, "host", max_wait_ms=0.0, registry=reg)
        good = _problem(package, "ok")
        bad = IO[package].problems_from_document(doc)[0]
        with pytest.raises(Exception) as e:
            sched.submit([good, bad])
        assert type(e.value).__name__ == error
        snap = reg.snapshot()
        assert snap.get("deppy_sched_dispatches_total", 0) == 0
        assert snap.get("deppy_cache_misses_total", 0) == 0
        assert sched.queue_depth() == 0
        assert sched.submit([good]) == [{"ok": True}]
        seen[package] = str(e.value)
    assert seen["port"] == seen["reference"]


# ------------------------------------------------ deadlines and faults


@pytest.mark.parametrize("backend", BACKENDS)
@within(240)
def test_expired_lane_degrades_without_poisoning_batchmate(backend):
    """A lane whose deadline expires while queued comes back Incomplete
    and counts a deadline miss; its coalesced batchmate resolves as
    unscheduled."""
    seen = {}
    for package in PACKAGES:
        reg = TELEMETRY[package].Registry()
        sched = make(package, backend, max_wait_ms=250.0, cache_size=0,
                     registry=reg)
        sched.start()
        try:
            dead, live = drive(
                sched, [[own(package, FLEET[0][1])],
                        [own(package, FLEET[0][0])]],
                deadlines=[0.02, None])
        finally:
            sched.stop()
        assert reg.snapshot()["deppy_sched_dispatches_total"] == 1
        incomplete = JIncomplete if package == "reference" else TIncomplete
        assert isinstance(dead[0][0], incomplete)
        assert dead[1]["deadline_misses"] == 1 and dead[1]["steps"] == 0
        assert live[1]["deadline_misses"] == 0
        snap = TELEMETRY[package].default_registry().snapshot()
        assert snap["deppy_deadline_exceeded"] >= 1
        seen[package] = (render(package, live[0][0]), live[1]["steps"],
                         report_fields(live[1]["report"]))
    assert seen["port"] == seen["reference"]
    ref = unscheduled(backend)
    (want,) = ref.solve([own("port", FLEET[0][0])])
    assert seen["port"][:2] == (render("port", want), ref.last_steps)


@pytest.mark.parametrize("backend", BACKENDS)
@within(240)
def test_tight_stranger_deadline_does_not_cut_batchmate(backend):
    for package in PACKAGES:
        sched = make(package, backend, max_wait_ms=150.0, cache_size=0)
        sched.start()
        try:
            tight, loose = drive(
                sched, [[_problem(package, "tight")],
                        [_problem(package, "loose")]],
                deadlines=[30.0, 300.0])
        finally:
            sched.stop()
        assert tight[0] == [{"tight": True}]
        assert loose[0] == [{"loose": True}]
        assert tight[1]["deadline_misses"] == loose[1]["deadline_misses"] \
            == 0


@pytest.mark.parametrize("backend", BACKENDS)
@within(240)
def test_injected_dispatch_fault_fails_every_coalesced_request(backend):
    spec = '[{"point": "sched.dispatch", "kind": "error", "times": 1}]'
    for package, f in (("reference", jfaults), ("port", tfaults)):
        f.configure_plan(f.plan_from_spec(spec))
        reg = TELEMETRY[package].Registry()
        sched = make(package, backend, max_wait_ms=60_000, max_fill=2,
                     cache_size=0, registry=reg)
        sched.start()
        try:
            out = drive(sched, [[_problem(package, "x")],
                                [_problem(package, "y")]])
            assert [type(o).__name__ for o in out] == ["InjectedFault"] * 2
            assert isinstance(out[0], f.InjectedFault)
            assert reg.snapshot()["deppy_sched_dispatches_total"] == 1
        finally:
            sched.stop()
        # The plan fired once: the next (inline) submit resolves.
        assert sched.submit([_problem(package, "x")]) == [{"x": True}]
        snap = TELEMETRY[package].default_registry().snapshot()
        assert snap["deppy_faults_injected_total"] == {"sched.dispatch": 1}


# ----------------------------------------------------------- admission


@pytest.mark.parametrize("fair", ["on", "off"])
@within(60)
def test_queue_over_depth_gives_retry_after(fair):
    seen = {}
    for package in PACKAGES:
        sched = make(package, "host", fair=fair)
        assert sched.admission_retry_after() is None
        sched.max_depth = 1
        sched._depth = 5
        sched._tenant_depth["default"] = 5
        retry = sched.admission_retry_after()
        assert retry is not None and retry >= 1.0
        sched._depth = 0
        sched._tenant_depth.clear()
        assert sched.admission_retry_after() is None
        seen[package] = retry
    assert seen["port"] == seen["reference"]


WEIGHTS = ('{"noisy": 1, "quiet": 3, "urgent": {"weight": 1, '
           '"priority": 0}, "default": 2}')
DEPTHS = [{}, {"noisy": 6}, {"noisy": 6, "quiet": 2},
          {"noisy": 2, "quiet": 6}, {"noisy": 10, "quiet": 6},
          {"urgent": 3, "noisy": 1}]


@within(60)
def test_per_tenant_shedding_matches_reference():
    """The weighted-fair gate over a matrix of queue states: the same
    Retry-After (or admit) per tenant, and the same shed counts."""
    seen = {}
    for package in PACKAGES:
        reg = TELEMETRY[package].Registry()
        sched = make(package, "host", max_depth=8, max_fill=4,
                     tenant_weights=WEIGHTS, registry=reg)
        rows = []
        for depths in DEPTHS:
            sched._tenant_depth = dict(depths)
            sched._depth = sum(depths.values())
            rows.append([sched.admission_retry_after(t)
                         for t in ("noisy", "quiet", "urgent", "other")])
        seen[package] = (rows,
                         reg.snapshot()["deppy_sched_tenant_sheds_total"])
    assert seen["port"] == seen["reference"]
    rows, sheds = seen["port"]
    assert rows[0] == [None] * 4 and sum(sheds.values()) > 0


@within(60)
def test_priority_head_matches_reference():
    """The flush head is the oldest group of the most urgent priority
    class, unless the oldest group has aged past the window."""
    seen = {}
    for package, mod in (("reference", jscheduler_mod),
                         ("port", tscheduler_mod)):
        sched = make(package, "host", tenant_weights=WEIGHTS)
        p = (jencode if package == "reference" else tencode)(
            _problem(package, "h"))
        groups = []
        now = mod.time.monotonic()
        for i, tenant in enumerate(["noisy", "quiet", "urgent", "urgent"]):
            lane = mod._Lane(p, f"k{i}", None, 100, None, tenant=tenant)
            groups.append(mod._Group(
                [lane], 1, 100, priority=sched.tenant_policy.priority(tenant)))
            groups[-1].enq_t = now - 0.1 + 0.01 * i
        sched._queue = list(groups)
        heads = [groups.index(sched._head_locked())]
        groups[0].enq_t = now - 1000.0  # the oldest group has aged
        heads.append(groups.index(sched._head_locked()))
        seen[package] = heads
    assert seen["port"] == seen["reference"] == [2, 0]


@pytest.mark.parametrize("backend", BACKENDS)
@within(240)
def test_inline_dispatch_when_loop_not_running(backend):
    seen = {}
    for package in PACKAGES:
        reg = TELEMETRY[package].Registry()
        sched = make(package, backend, max_wait_ms=0.0, registry=reg)
        assert not sched.running
        st: dict = {}
        res = sched.submit([own(package, FLEET[1][0])], stats=st)
        assert reg.snapshot()["deppy_sched_flushes_total"] == {"inline": 1}
        seen[package] = (render(package, res[0]), st["steps"])
        sched.start()
        sched.stop()
        # After stop, submits dispatch inline again.
        assert sched.submit([_problem(package, "late")]) == [{"late": True}]
    assert seen["port"] == seen["reference"]


@within(300)
def test_size_classes_do_not_mix():
    """A giant problem and a tiny one flush as separate dispatches."""
    giant_doc = {"variables": [
        {"id": f"g{i}", "constraints": [
            {"type": "dependency",
             "ids": [f"g{j}" for j in range(64) if j != i][:8]}]}
        for i in range(64)]}
    seen = {}
    for package in PACKAGES:
        tiny = _problem(package, "t")
        giant = IO[package].problems_from_document(giant_doc)[0]
        if package == "port":
            c = [tdriver._bucket(tdriver._cost_proxy(tencode(v)))
                 for v in (tiny, giant)]
            assert c[0] != c[1]  # the premise of the test
        reg = TELEMETRY[package].Registry()
        sched = make(package, "device", max_wait_ms=200.0, cache_size=0,
                     registry=reg)
        sched.start()
        try:
            a, b = drive(sched, [[tiny], [giant]])
        finally:
            sched.stop()
        assert a[0] == [{"t": True}]
        assert reg.snapshot()["deppy_sched_dispatches_total"] == 2
        assert reg.snapshot()["deppy_sched_coalesced_batch_size"][
            "count"] == 2
        seen[package] = (render(package, b[0][0]), b[1]["steps"])
    assert seen["port"] == seen["reference"]


# ------------------------------------------------------------- facade


@within(240)
def test_batch_resolver_routes_through_scheduler():
    seen = {}
    for package, cls in (("reference", JBatchResolver),
                         ("port", TBatchResolver)):
        sched = make(package, "device", max_wait_ms=0.0)
        resolver = cls(scheduler=sched)
        probs = [_problem(package, "r1"), _problem(package, "r2")]
        out = resolver.solve(probs)
        assert out == [{"r1": True}, {"r2": True}]
        assert resolver.last_steps > 0
        assert resolver.last_report.outcomes["sat"] == 2
        first = (resolver.last_steps, report_fields(resolver.last_report))
        out2 = resolver.solve([_problem(package, "r1"),
                               _problem(package, "r2")])
        assert out2 == out and resolver.last_steps == 0
        assert resolver.last_report is None
        seen[package] = first
    assert seen["port"] == seen["reference"]


@within(60)
def test_batch_resolver_deadline_on_the_scheduled_path():
    sched = TScheduler(backend="host", max_wait_ms=0.0)
    out = TBatchResolver(scheduler=sched, deadline_s=0.0).solve(
        [_problem("port", "d")])
    assert isinstance(out[0], TIncomplete)
    assert len(sched.cache) == 0  # deadline-degraded: never cached
    assert TBatchResolver(scheduler=sched).solve(
        [_problem("port", "d")]) == [{"d": True}]


@within(60)
def test_scheduler_metrics_in_render():
    seen = {}
    for package in PACKAGES:
        reg = TELEMETRY[package].Registry()
        sched = make(package, "host", max_wait_ms=0.0, registry=reg)
        sched.submit([_problem(package, "m")])
        text = reg.render()
        for family in ("deppy_sched_queue_depth",
                       "deppy_sched_coalesced_batch_size_bucket",
                       "deppy_sched_dispatches_total",
                       "deppy_sched_flushes_total",
                       "deppy_cache_hit_ratio", "deppy_cache_hits_total",
                       "deppy_cache_misses_total",
                       "deppy_cache_evictions_total"):
            assert family in text, family
        seen[package] = sorted(
            line for line in text.splitlines()
            if line.startswith(("deppy_sched", "deppy_cache"))
            and "_bytes" not in line)
    assert seen["port"] == seen["reference"]


# -------------------------------------------------------------- guards


@pytest.mark.parametrize("started", [False, True],
                         ids=["inline", "loop"])
@within(60)
def test_cuda_without_a_card_raises_at_first_dispatch(monkeypatch, started):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = TScheduler(max_wait_ms=0.0)  # device="cuda", the default
    assert sched.device == "cuda"
    if started:
        sched.start()
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="cuda"):
                sched.submit([_problem("port", "a")])
        assert sched.running == started
    finally:
        sched.stop()
    assert len(sched.cache) == 0


@pytest.mark.parametrize("backend", ["auto", "tpu", "hsot"])
@within(30)
def test_unported_backends_raise(backend):
    """``"tpu"`` and unknown names raise; ``"auto"`` is served and
    resolves per flush (on the CPU to the device path, whose verdict
    there is instant)."""
    if backend != "auto":
        with pytest.raises(InternalSolverError):
            TScheduler(backend=backend)
        return
    sched = TScheduler(backend=backend, device="cpu")
    st: dict = {}
    got = sched.submit([_problem("port", "a")], stats=st)
    assert st["report"].backend == "device"
    want = TScheduler(device="cpu").submit([_problem("port", "a")])
    assert [render("port", r) for r in got] == \
        [render("port", r) for r in want]


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=2), "A6"),
    (dict(mesh_devices=2), "A6"), (dict(lanes_per_device=64), "A6"),
], ids=lambda v: "-".join(v) if isinstance(v, dict) else v)
@within(30)
def test_unported_tiers_raise(kw, item):
    """The mesh parameters ``item`` brought (scheduler.py:627-642,
    :816-823) no longer raise: a pinned mesh sizes a flush to slots ×
    ``lanes_per_device`` at construction, ``mesh_devices`` resolves
    lazily (one distinct CPU device: no mesh) and ``lanes_per_device``
    alone changes nothing."""
    from deppy_tpu_torch.parallel import default_mesh

    if "mesh" in kw:
        kw = dict(mesh=default_mesh([torch.device("cpu")] * kw["mesh"]),
                  lanes_per_device=4)
    sched = TScheduler(device="cpu", **kw)
    want = {"mesh": 8, "mesh_devices": 256, "lanes_per_device": 256}
    assert sched.max_fill == want[next(iter(kw))]
    assert sched.lanes_per_device == kw.get("lanes_per_device", 256)
    if "mesh_devices" in kw:
        assert sched._resolve_mesh() is None
        assert sched.max_fill == 256


@pytest.mark.parametrize("kw,backlog", [
    (dict(), 2048),
    (dict(speculate=None), 2048),
    (dict(speculate="on"), 2048),
    (dict(speculate="ON"), 2048),
    (dict(speculate_max_backlog=8), 8),
    (dict(speculate="on", speculate_max_backlog=0), 0),
], ids=["default", "None", "on", "ON", "backlog-8", "backlog-0"])
@within(30)
def test_speculate_arguments_build_the_tier(kw, backlog, monkeypatch):
    """The ``speculate*`` arguments (ported with the reference's
    default, ``"on"``, and its backlog cap of 2048) build the manager,
    the ``deppy_speculate_backlog`` gauge at 0 and the cap, as the
    reference's do."""
    for name in ("DEPPY_GPU_SPECULATE", "DEPPY_GPU_SPECULATE_MAX_BACKLOG"):
        monkeypatch.delenv(name, raising=False)
    treg, jreg = ttelemetry.Registry(), jtelemetry.Registry()
    mine = TScheduler(device="cpu", registry=treg, **kw)
    ref = JScheduler(backend="tpu", incremental="off", portfolio="off",
                     registry=jreg, **kw)
    for sched, reg in ((mine, treg), (ref, jreg)):
        assert sched.speculate is not None
        assert sched._g_spec_depth is not None
        assert reg.snapshot()["deppy_speculate_backlog"] == 0
        assert sched.spec_max_backlog == backlog
        assert sched.speculative_depth() == 0
    assert type(mine.speculate).__module__ == \
        "deppy_tpu_torch.speculate.manager"


@pytest.mark.parametrize("kw,want", [
    (dict(), ("auto", 2, 16)),
    (dict(portfolio="on"), ("on", 2, 16)),
    (dict(portfolio="auto", portfolio_k=3), ("auto", 3, 16)),
    (dict(portfolio="ON", portfolio_sample_check=0.5), ("on", 2, 2)),
], ids=["defaults", "on", "auto-k3", "on-check-half"])
@within(30)
def test_portfolio_arguments_build_the_racer(kw, want, monkeypatch):
    """The ``portfolio*`` arguments (ported from the reference with its
    defaults: ``"auto"``, K 2, a 1-in-16 cross-check) configure the
    racer: mode, K and the cross-check interval, as the reference's."""
    for name in ("DEPPY_GPU_PORTFOLIO", "DEPPY_GPU_PORTFOLIO_K",
                 "DEPPY_GPU_PORTFOLIO_SAMPLE_CHECK"):
        monkeypatch.delenv(name, raising=False)
    racer = TScheduler(device="cpu", **kw)._racer
    ref = JScheduler(backend="tpu", incremental="off", speculate="off",
                     **kw)._racer
    assert (racer.mode, racer.k, racer._check_interval) == want
    assert (ref.mode, ref.k, ref._check_interval) == want


@within(30)
def test_off_spellings_of_unported_tiers_are_accepted():
    for off in ("off", "0", "false", "no", "OFF"):
        TScheduler(device="cpu", incremental=off, portfolio=off,
                   speculate=off)
    from deppy_tpu_torch.incremental import ClauseSetIndex

    index = ClauseSetIndex(registry=ttelemetry.Registry())
    assert TResultCache(8, incremental=index).incremental is index
    with pytest.raises(TypeError, match="ClauseSetIndex"):
        TResultCache(8, incremental=object())
    # deadline_s without a scheduler bounds the solve, as the
    # reference's does: an expired one degrades every problem.
    states = [pinned_tenant_catalog(seed=s) for s in range(2)]
    for backend in ("device", "host"):
        got = unscheduled(backend, deadline_s=0.0).solve(
            [own("port", vs) for vs in states])
        want = JBatchResolver(
            backend="tpu" if backend == "device" else "host",
            deadline_s=0.0).solve(states)
        assert [render("port", r) for r in got] == \
            [render("reference", r) for r in want]
        assert all(isinstance(r, TIncomplete) for r in got)


# ---------------------------------------------------------------- units


def _reversed(jvars):
    return list(reversed(jvars))


@pytest.mark.parametrize("make_vars", [
    lambda: operatorhub_catalog(40, 5),
    lambda: _reversed(operatorhub_catalog(40, 5)),
    lambda: gvk_conflict_catalog(20, 4, 10, seed=3),
    lambda: pinned_tenant_catalog(seed=2),
    lambda: version_pinned_chains(20, 3, seed=1),
], ids=["operatorhub", "operatorhub-reversed", "gvk", "tenant", "chains"])
@within(60)
def test_fingerprint_equals_reference(make_vars):
    jvars = make_vars()
    jp = jencode(jvars)
    tp = tencode(variables_from_objects(jvars))
    assert tfingerprint(tp) == jfingerprint(jp)
    # Clause emission order does not matter: rows permuted (with their
    # constraint map) hash the same; the memo is per object.
    perm = np.random.default_rng(0).permutation(tp.clauses.shape[0])
    tq = tencode(variables_from_objects(jvars))
    tq.clauses, tq.clause_con = tq.clauses[perm], tq.clause_con[perm]
    assert tfingerprint(tq) == tfingerprint(tp)


@within(60)
def test_fingerprint_separates_vocabularies():
    pa = tencode(_problem("port", "a"))
    assert tfingerprint(pa) == tfingerprint(tencode(_problem("port", "a")))
    assert tfingerprint(pa) != tfingerprint(tencode(_problem("port", "b")))
    shuffled = tencode(_reversed(variables_from_objects(
        operatorhub_catalog(40, 5))))
    assert tfingerprint(shuffled) != tfingerprint(tencode(
        variables_from_objects(operatorhub_catalog(40, 5))))


CACHES = {"reference": (JResultCache, JMISS, JIncomplete, JNotSatisfiable),
          "port": (TResultCache, TMISS, TIncomplete, TNotSatisfiable)}


def _definitive_hit_serves_larger_budgets_only(package):
    Cache, MISS, _, _ = CACHES[package]
    cache = Cache(8, registry=TELEMETRY[package].Registry())
    cache.store("k", 100, {"a": True})
    return [cache.lookup("k", 100), cache.lookup("k", 500),
            cache.lookup("k", 50) is MISS]


def _hit_returns_a_fresh_copy(package):
    Cache = CACHES[package][0]
    cache = Cache(8, registry=TELEMETRY[package].Registry())
    cache.store("k", 10, {"a": True})
    got = cache.lookup("k", 10)
    got["a"] = False
    return cache.lookup("k", 10)


def _store_copies_the_callers_dict(package):
    Cache = CACHES[package][0]
    cache = Cache(8, registry=TELEMETRY[package].Registry())
    mine = {"a": True}
    cache.store("k", 10, mine)
    mine["a"] = False
    return cache.lookup("k", 10)


def _incomplete_entries_invalidate_on_budget_escalation(package):
    Cache, MISS, Incomplete, _ = CACHES[package]
    reg = TELEMETRY[package].Registry()
    cache = Cache(8, registry=reg)
    cache.store("k", 10, Incomplete())
    out = [isinstance(cache.lookup("k", 5), Incomplete),
           isinstance(cache.lookup("k", 10), Incomplete),
           cache.lookup("k", 20) is MISS,
           reg.snapshot()["deppy_cache_invalidations_total"], len(cache)]
    cache.store("k", 20, {"a": False})
    return out + [cache.lookup("k", 20)]


def _lru_eviction_counts(package):
    Cache, MISS, _, _ = CACHES[package]
    reg = TELEMETRY[package].Registry()
    cache = Cache(2, registry=reg)
    cache.store("k1", 1, {"a": True})
    cache.store("k2", 1, {"b": True})
    cache.lookup("k1", 1)
    cache.store("k3", 1, {"c": True})
    return [reg.snapshot()["deppy_cache_evictions_total"],
            cache.lookup("k2", 1) is MISS, cache.lookup("k1", 1),
            reg.snapshot()["deppy_cache_entries"]]


def _definitive_supersedes_and_zero_capacity(package):
    Cache, MISS, Incomplete, _ = CACHES[package]
    reg = TELEMETRY[package].Registry()
    cache = Cache(4, registry=reg)
    cache.store("k", 50, Incomplete())
    cache.store("k", 40, {"a": True})
    cache.store("k", 30, {"a": True})
    cache.store("k", 60, {"a": True})  # a larger budget never replaces
    none = Cache(0, registry=TELEMETRY[package].Registry())
    none.store("k", 1, {"a": True})
    return [cache.lookup("k", 30), cache.lookup("k", 29) is MISS,
            cache.store("x", 1, object()), len(cache),
            none.lookup("k", 1) is MISS, len(none),
            reg.snapshot()["deppy_cache_hit_ratio"]]


def _unsat_results_cached(package):
    sched = make(package, "host", max_wait_ms=0.0)
    notsat = CACHES[package][3]
    r1 = sched.submit(IO[package].problems_from_document(UNSAT))[0]
    r2 = sched.submit(IO[package].problems_from_document(UNSAT))[0]
    return [isinstance(r1, notsat), isinstance(r2, notsat),
            render(package, r1) == render(package, r2),
            sched._registry.snapshot()["deppy_cache_hits_total"]]


def _deadline_degraded_results_never_cached(package):
    sched = make(package, "host", max_wait_ms=0.0)
    r = sched.submit([_problem(package, "d")], deadline_s=0.0)[0]
    return [isinstance(r, CACHES[package][2]), len(sched.cache),
            sched.submit([_problem(package, "d")])[0]]


CACHE_CASES = [_definitive_hit_serves_larger_budgets_only,
               _hit_returns_a_fresh_copy, _store_copies_the_callers_dict,
               _incomplete_entries_invalidate_on_budget_escalation,
               _lru_eviction_counts,
               _definitive_supersedes_and_zero_capacity,
               _unsat_results_cached,
               _deadline_degraded_results_never_cached]


@pytest.mark.parametrize("case", CACHE_CASES,
                         ids=[c.__name__.strip("_") for c in CACHE_CASES])
@within(60)
def test_result_cache_matches_reference(case):
    assert case("port") == case("reference")


@pytest.mark.parametrize("spec", [
    None, "", '{"a": 2}', WEIGHTS,
    '{"a": {"weight": 0.5, "priority": 3}, "b": {"priority": 0}}'])
@within(30)
def test_tenant_policy_matches_reference(spec):
    jp, tp = JTenantPolicy.from_spec(spec), TTenantPolicy.from_spec(spec)
    assert tp.tenants == jp.tenants
    names = ["a", "b", "noisy", "quiet", "urgent", "other", "default"]
    for t in names:
        assert (tp.weight(t), tp.priority(t)) == (jp.weight(t),
                                                  jp.priority(t))
        for active in ([], ["a"], ["a", "b", "quiet"], names):
            assert tp.cap(t, 64, active) == jp.cap(t, 64, active)


@pytest.mark.parametrize("spec", ['["a"]', '{"a": "heavy"}', '{"a": 0}',
                                  '{"a": -1}', "no/such/weights.json"])
@within(30)
def test_malformed_tenant_specs_raise_like_the_reference(spec):
    for cls in (JTenantPolicy, TTenantPolicy):
        with pytest.raises((ValueError, OSError)) as e:
            cls.from_spec(spec)
        assert type(e.value).__name__ in ("ValueError",
                                          "FileNotFoundError")


@within(60)
def test_launch_counts_are_exact_across_threads():
    """Wrappers on the dispatch loop and on inline callers count into
    one table at once while a reader reads it: no launch is lost, and no
    read sees the table change under it."""
    import os
    import sys

    from deppy_tpu_torch import engine
    from deppy_tpu_torch.engine import counts

    engine.reset_launch_counts()
    n, threads = 3000, 2 * (os.cpu_count() or 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def launch(i):
        for j in range(n):
            counts.count("search", "bits", "block", None)
            counts.count("core", "watched", "block", object())
            # A new key now and then, as a first launch of a team does.
            counts.count("minimize", f"impl-{i}-{j % 50}", "warp", None)

    errors = []
    done = threading.Event()

    def read():
        while not done.is_set():
            try:
                engine.launch_counts()
                engine.impl_launch_counts()
            except RuntimeError as e:  # a table changed while read
                errors.append(e)
                return

    workers = [threading.Thread(target=launch, args=(i,),
                                name=f"caller-{i}")
               for i in range(threads)]
    reader = threading.Thread(target=read, name="reader")
    try:
        reader.start()
        for t in workers:
            t.start()
        for t in workers:
            t.join(30)
            assert not t.is_alive()
        done.set()
        reader.join(30)
        assert not reader.is_alive()
    finally:
        done.set()
        sys.setswitchinterval(interval)
    assert errors == []
    try:
        assert engine.launch_counts()["search"] == n * threads
        assert engine.bank_launch_counts()["core"] == {
            "real": n * threads, "dummy": 0}
        assert engine.launch_counts()["minimize"] == n * threads
        assert engine.impl_launch_counts()["minimize"] == {
            f"impl-{i}-{j}": n // 50 for i in range(threads)
            for j in range(50)}
    finally:
        engine.reset_launch_counts()
    assert engine.launch_counts() == {k: 0 for k in engine.KERNELS}
