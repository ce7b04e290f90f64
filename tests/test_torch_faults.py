"""The port's fault layer and host lanes against the JAX package's.

``deppy_tpu_torch.faults`` (deadlines, their thread-local scopes,
``env_float``, the retry policy, the injection harness and its plan
parser) and ``deppy_tpu_torch.hostpool`` (``solve_lane`` and the inline
host path) are copies of the reference's; each case runs on both
packages and compares what they return, with tolerance 0.
"""

from __future__ import annotations

import functools
import importlib
import threading

import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import hostpool as jhostpool
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.models import (gvk_conflict_catalog, pinned_tenant_catalog,
                              version_pinned_chains)
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import hostpool as thostpool
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.sat.encode import encode as tencode

# The packages export a function named ``inject`` too: the modules.
jinject = importlib.import_module("deppy_tpu.faults.inject")
tinject = importlib.import_module("deppy_tpu_torch.faults.inject")

FAULTS = {"reference": jfaults, "port": tfaults}
PACKAGES = list(FAULTS)


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
def fresh_state():
    """Each package's fault plan and default registry, per test."""
    prev = [(jfaults.configure_plan(None), tfaults.configure_plan(None)),
            (jtelemetry.set_default_registry(jtelemetry.Registry()),
             ttelemetry.set_default_registry(ttelemetry.Registry()))]
    yield
    jfaults.configure_plan(prev[0][0])
    tfaults.configure_plan(prev[0][1])
    jtelemetry.set_default_registry(prev[1][0])
    ttelemetry.set_default_registry(prev[1][1])


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------ deadlines


@within(30)
def test_deadline_remaining_and_expiry_match_reference():
    seen = {}
    for name, f in FAULTS.items():
        clock = FakeClock()
        dl = f.Deadline(2.5, clock=clock)
        row = [dl.seconds, dl.remaining(), dl.expired()]
        clock.t += 2.0
        row += [dl.remaining(), dl.expired()]
        clock.t += 0.5
        row += [dl.remaining(), dl.expired()]
        clock.t += 1.0
        row += [dl.remaining(), dl.expired()]
        seen[name] = row
    assert seen["port"] == seen["reference"]
    assert seen["port"] == [2.5, 2.5, False, 0.5, False, 0.0, True, -1.0,
                            True]


def _scope_trace(f):
    """Which deadline each nesting of ``deadline_scope`` leaves active."""
    out = []
    assert f.current_deadline() is None
    with f.deadline_scope(None) as d0:
        out.append(d0)
    with f.deadline_scope(100.0) as outer:
        out.append(round(outer.seconds, 3))
        with f.deadline_scope(500.0) as looser:
            # An inner, looser deadline never extends the outer one.
            out.append(looser is outer)
        with f.deadline_scope(1.0) as tighter:
            out.append(round(tighter.seconds, 3))
            out.append(f.current_deadline() is tighter)
            with f.deadline_scope(None) as keep:
                out.append(keep is tighter)
        out.append(f.current_deadline() is outer)
        # A Deadline object is re-installed as is: the same clock.
        with f.deadline_scope(outer) as same:
            out.append(same is outer)
    out.append(f.current_deadline())
    return out


@pytest.mark.parametrize("package", PACKAGES)
@within(30)
def test_deadline_scope_nesting(package):
    want = [None, 100.0, True, 1.0, True, True, True, True, None]
    assert _scope_trace(FAULTS[package]) == want


@within(30)
def test_deadline_scope_is_per_thread():
    """A scope on one thread is invisible on another (the scheduler's
    loop thread re-installs a request's Deadline object itself)."""
    seen = {}
    with tfaults.deadline_scope(5.0) as dl:
        t = threading.Thread(
            target=lambda: seen.setdefault("other",
                                           tfaults.current_deadline()))
        t.start()
        t.join(10)
        assert not t.is_alive()
        assert tfaults.current_deadline() is dl
    assert seen == {"other": None}


@pytest.mark.parametrize("raw,want", [(None, None), ("", None),
                                      ("2.5", 2.5), ("0", None),
                                      ("-1", None), ("soon", None)])
@within(30)
def test_ambient_deadline_reads_the_env(monkeypatch, capsys, raw, want):
    """``DEPPY_GPU_BATCH_DEADLINE_S`` (the reference's
    ``DEPPY_TPU_BATCH_DEADLINE_S``): unset, empty, <= 0 or malformed is
    no deadline; an enclosing scope wins over the env."""
    got = {}
    for name, var in (("reference", "DEPPY_TPU_BATCH_DEADLINE_S"),
                      ("port", "DEPPY_GPU_BATCH_DEADLINE_S")):
        f = FAULTS[name]
        if raw is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, raw)
        with f.ambient_deadline() as dl:
            got[name] = None if dl is None else dl.seconds
        with f.deadline_scope(9.0) as outer:
            with f.ambient_deadline() as dl:
                assert dl is outer
        monkeypatch.delenv(var, raising=False)
    assert got == {"reference": want, "port": want}
    err = capsys.readouterr().err
    assert (err.count("ignoring non-numeric") == 2) == (raw == "soon")


@pytest.mark.parametrize("raw,default,want", [
    (None, 1.5, 1.5), ("", None, None), ("3", 1.0, 3.0),
    ("-0.25", 1.0, -0.25), ("x1", 7.0, 7.0), ("1e-3", None, 0.001)])
@within(30)
def test_env_float(monkeypatch, capsys, raw, default, want):
    name = "DEPPY_GPU_SCHED_MAX_WAIT_MS"
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert tfaults.env_float(name, default) == want
    assert capsys.readouterr().err == ""
    assert tfaults.env_float(name, default, warn=True) == want
    err = capsys.readouterr().err
    assert ("ignoring non-numeric" in err) == (raw == "x1")


@pytest.mark.parametrize("package", PACKAGES)
@within(30)
def test_note_deadline_exceeded_counts_and_emits(package, tmp_path):
    f = FAULTS[package]
    t = {"reference": jtelemetry, "port": ttelemetry}[package]
    reg = t.Registry(sink_path=str(tmp_path / "sink.jsonl"))
    t.set_default_registry(reg)
    f.note_deadline_exceeded("sched.dispatch", tenant="acme")
    f.note_deadline_exceeded("facade.host_solve", 3)
    reg.configure_sink(None)
    assert reg.snapshot()["deppy_deadline_exceeded"] == 2
    events = [(e["fault"], e["where"], e["problems"], e.get("tenant"))
              for e in t.iter_sink_events(str(tmp_path / "sink.jsonl"))]
    assert events == [("deadline_exceeded", "sched.dispatch", 0, "acme"),
                      ("deadline_exceeded", "facade.host_solve", 3, None)]


@within(30)
def test_metric_families_match_reference():
    assert tfaults.FAMILIES == jfaults.FAMILIES
    tfaults.fault_counter("deppy_faults_injected_total").inc(label="x")
    assert 'deppy_faults_injected_total{point="x"} 1' in \
        ttelemetry.default_registry().render()


# ------------------------------------------------------------- injection

PLANS = [
    '[{"point": "sched.dispatch", "kind": "error", "times": 1}]',
    '[{"point": "sched.dispatch", "kind": "error", "times": 2, "after": 1}]',
    '{"faults": [{"point": "sched.*", "kind": "error", "period": 3, '
    '"times": 1}]}',
    '[{"point": "sched.dispatch", "kind": "error", "times": -1, '
    '"period": 2}]',
    '[{"point": "sched.dispatch", "kind": "latency", "latency_s": 0.001, '
    '"times": 2}, {"point": "sched.dispatch", "kind": "error", '
    '"times": 1, "after": 1}]',
    '[{"point": "sched.dispatch", "kind": "error", "times": 1}, '
    '{"point": "sched.dispatch", "kind": "error", "times": 2}]',
    '[{"point": "driver.dispatch", "kind": "error", "times": -1}]',
]


def _schedule(f, spec: str, hits: int = 8):
    """Which hits of ``sched.dispatch`` raise under the plan ``spec``,
    and each rule's hit and fire counts afterwards."""
    plan = f.plan_from_spec(spec)
    out = []
    for _ in range(hits):
        try:
            plan.check("sched.dispatch")
            out.append(0)
        except f.InjectedFault as e:
            out.append(str(e))
    return out, [(r.hits, r.fired) for r in plan.rules]


@pytest.mark.parametrize("spec", PLANS, ids=range(len(PLANS)))
@within(30)
def test_plan_schedule_matches_reference(spec):
    assert _schedule(tfaults, spec) == _schedule(jfaults, spec)


@pytest.mark.parametrize("spec", [
    '[{"kind": "error"}]', '[{"point": "x", "kind": "boom"}]',
    '[{"point": "x", "colour": "red"}]', '{"faults": "x"}', '{"faults": 3}',
    '[1]'])
@within(30)
def test_malformed_plans_raise_like_the_reference(spec):
    for f in (jfaults, tfaults):
        with pytest.raises(ValueError):
            f.plan_from_spec(spec)
        with pytest.raises(OSError):
            f.plan_from_spec("no/such/plan.json")


@within(30)
def test_plan_from_a_file_and_the_known_points(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(PLANS[2], encoding="utf-8")
    for spec in (str(path), "@" + str(path)):
        assert _schedule(tfaults, spec) == _schedule(jfaults, PLANS[2])
    assert tinject.KNOWN_POINTS == jinject.KNOWN_POINTS
    for spec in PLANS:
        assert tinject.unmatched_points(tfaults.plan_from_spec(spec)) == \
            jinject.unmatched_points(jfaults.plan_from_spec(spec))
    assert tinject.unmatched_points(tfaults.plan_from_spec(
        '[{"point": "nowhere.at.all"}]')) == ["nowhere.at.all"]


@within(30)
def test_points_the_port_does_not_call_yet():
    """Every registered point but the scheduler's, the racer's, the
    host pool's and the session store's waits for a ROADMAP item; a rule
    that can match only those is named, one that can also match a called
    point (or nothing known) is not."""
    assert set(tinject.NOT_YET_CALLED) == set(tinject.KNOWN_POINTS) - {
        "sched.dispatch", "sched.race.*", "hostpool.dispatch",
        "hostpool.worker_crash", "sessions.op"}
    plan = tfaults.plan_from_spec(
        '[{"point": "driver.dispatch"}, {"point": "sched.*"}, '
        '{"point": "sched.race.3"}, {"point": "hostpool.*"}, '
        '{"point": "fleet.*"}, {"point": "nowhere"}, {"point": "*"}]')
    assert tinject.uncalled_points(plan) == [
        ("driver.dispatch", ["A7"]), ("fleet.*", ["A5.6"])]


@within(30)
def test_plan_from_env_and_inject(monkeypatch, capsys):
    """``DEPPY_GPU_FAULT_PLAN`` arms ``inject`` on first use; an explicit
    ``configure_plan`` overrides it; no plan is a no-op."""
    tfaults.inject("sched.dispatch")  # no plan: nothing fires
    monkeypatch.setattr(tinject, "_ENV_LOADED", False)
    monkeypatch.setattr(tinject, "_PLAN", None)
    monkeypatch.setenv("DEPPY_GPU_FAULT_PLAN",
                       '[{"point": "sched.dispatch", "times": 1}, '
                       '{"point": "nowhere"}]')
    with pytest.raises(tfaults.InjectedFault):
        tfaults.inject("sched.dispatch")
    err = capsys.readouterr().err
    assert "'nowhere' matches no registered fault point" in err
    assert "does not call" not in err
    tfaults.inject("sched.dispatch")  # times 1: spent
    snap = ttelemetry.default_registry().snapshot()
    assert snap["deppy_faults_injected_total"] == {"sched.dispatch": 1}
    prev = tfaults.configure_plan(None)
    assert prev is not None and tfaults.current_plan() is None
    monkeypatch.setenv("DEPPY_GPU_FAULT_PLAN",
                       '[{"point": "driver.device_put"}]')
    assert tfaults.plan_from_env() is not None
    assert "'driver.device_put' matches only points this package does " \
        "not call yet (ROADMAP A7)" in capsys.readouterr().err
    monkeypatch.setenv("DEPPY_GPU_FAULT_PLAN", "")
    assert tfaults.plan_from_env() is None


# ------------------------------------------------------------ host lanes


def _instances():
    """(name, reference variables, max_steps): SAT, UNSAT, backtracking
    and budget-bound lanes."""
    return [
        ("gvk", gvk_conflict_catalog(8, 3, 4, seed=1), None),
        ("tenant-sat", pinned_tenant_catalog(seed=0), None),
        ("tenant-unsat", pinned_tenant_catalog(seed=3), None),
        ("chains", version_pinned_chains(6, 3, seed=2), None),
        ("tenant-budget", pinned_tenant_catalog(seed=1), 2),
    ]


@pytest.mark.parametrize("case", range(5),
                         ids=[n for n, _, _ in _instances()])
@within(60)
def test_solve_lane_matches_reference(case):
    _, jvars, steps = _instances()[case]
    jp = jencode(jvars)
    tp = tencode(variables_from_objects(jvars))
    want = jhostpool.solve_lane(jp, max_steps=steps)
    got = thostpool.solve_lane(tp, max_steps=steps)
    assert got.key() == want.key()
    assert got.wall_s >= 0.0


@within(60)
def test_expired_lanes_degrade_like_the_reference():
    jvars = [v for _, v, _ in _instances()]
    jps = [jencode(v) for v in jvars]
    tps = [tencode(variables_from_objects(v)) for v in jvars]
    clock = FakeClock()
    jdl = [None, jfaults.Deadline(0.0, clock=clock), None,
           jfaults.Deadline(10.0, clock=clock), None]
    tdl = [None, tfaults.Deadline(0.0, clock=clock), None,
           tfaults.Deadline(10.0, clock=clock), None]
    steps = [s for _, _, s in _instances()]
    want = jhostpool.solve_inline(jps, max_steps=steps, deadlines=jdl)
    got = thostpool.solve_inline(tps, max_steps=steps, deadlines=tdl)
    assert [r.key() for r in got] == [r.key() for r in want]
    assert [r.degraded for r in got] == [False, True, False, False, False]
    assert got[1].key() == ("incomplete", (), (), 0, 0, 0, 0, True)
    # One budget for every lane, and no deadlines.
    want = jhostpool.solve_inline(jps[:3], max_steps=5)
    got = thostpool.solve_inline(tps[:3], max_steps=5)
    assert [r.key() for r in got] == [r.key() for r in want]


@within(60)
def test_solve_lane_core_indices_rebuild_the_core():
    """The core index list names the very constraints of
    ``problem.applied`` the engine's NotSatisfiable carries."""
    from deppy_tpu_torch.sat import NotSatisfiable
    from deppy_tpu_torch.sat.host import HostEngine

    tp = tencode(variables_from_objects(pinned_tenant_catalog(seed=3)))
    r = thostpool.solve_lane(tp)
    assert r.outcome == "unsat" and r.core_idx
    with pytest.raises(NotSatisfiable) as e:
        HostEngine(tp).solve()
    assert [tp.applied[j] for j in r.core_idx] == list(e.value.constraints)
