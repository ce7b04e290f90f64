"""The port's portfolio racing against the JAX package's.

The cases of ``tests/test_portfolio.py`` on both packages with the same
inputs, on the CPU: the engine registry's ranking and candidates for
every class (with and without a measured ``portfolio`` row in a
``tmp_path`` file), the device adapter's decode, racing on against
racing off and against the reference's racing scheduler (rendered
answers and cores byte for byte, steps where the canonical engine won),
the race's chaos cases, the grad_relax entrant (its descent against the
reference's, its certified lanes against the canonical answer), the
straggler triage, and two threads inside the driver at once.

The reference side is ``deppy_tpu.sched.Scheduler(backend="tpu",
incremental="off", speculate="off")``; the port's is
``Scheduler(device="cpu")``.  The reference keys measured rows by
``jax.default_backend()`` (``"cpu"`` here) and the port by the device's
platform (``"cpu"`` for ``device="cpu"``), so one file serves both.

Tolerances: the descents' logits within :data:`LOGIT_ATOL`, and the
rounded candidates equal wherever ``|sigmoid(x) - 0.5|`` passes
:data:`MARGIN`; everything served is compared exactly.
"""

from __future__ import annotations

import functools
import json
import sys
import threading

import numpy as np
import pytest
import torch

from deppy_tpu import faults as jfaults
from deppy_tpu import io as jio
from deppy_tpu import sat as jsat
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.engine import grad_relax as jgrad
from deppy_tpu.engine import registry as jregistry
from deppy_tpu.models import pinned_tenant_catalog as jpinned
from deppy_tpu.models import random_instance as jrandom
from deppy_tpu.models import version_pinned_chains as jchains
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu.sched import scheduler as jsched_mod
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import hostpool as thostpool
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch import size_classes as tsize
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import defaults as tdefaults
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine._build import KernelBuildError, KernelLaunchError
from deppy_tpu_torch.engine import grad_relax as tgrad
from deppy_tpu_torch.engine import registry as tregistry
from deppy_tpu_torch.hostpool.worker import HostLaneResult as THostLaneResult
from deppy_tpu_torch.models import pinned_tenant_catalog as tpinned
from deppy_tpu_torch.models import random_instance as trandom
from deppy_tpu_torch.models import version_pinned_chains as tchains
from deppy_tpu_torch.sat.encode import encode as tencode
from deppy_tpu_torch.sat.host import GuidanceUnverified, HostEngine
from deppy_tpu_torch.sat.host import SolveCancelled
from deppy_tpu_torch.sched import Scheduler as TScheduler
from deppy_tpu_torch.sched import scheduler as tsched_mod

PACKAGES = {"reference": (jsat, jio), "port": (tsat, tio)}
# The reference's tiers the port has not ported, off on its side.
REF_OFF = dict(incremental="off", speculate="off")
CLASSES = tuple(name for name, _ in tsize.ordered_classes())
# The descents' logits agree within this; past MARGIN the rounding is
# the same on both sides.
LOGIT_ATOL = 1e-4
MARGIN = 1e-3
WORKERS = 2


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
    """Each package's fault plan and default registry, the reference's
    breaker, no measured rows on either side, a 2-worker default pool;
    abandoned race losers joined after each test."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", str(WORKERS))
    monkeypatch.delenv("DEPPY_GPU_PORTFOLIO", raising=False)
    prev_breaker = jfaults.set_default_breaker(jfaults.CircuitBreaker())
    prev = [(jfaults.configure_plan(None), tfaults.configure_plan(None)),
            (jtelemetry.set_default_registry(jtelemetry.Registry()),
             ttelemetry.set_default_registry(ttelemetry.Registry()))]
    yield
    jsched_mod._join_race_threads()
    tsched_mod._join_race_threads()
    thostpool.shutdown_default_pool()
    tdefaults.reload_measured_defaults()
    jfaults.configure_plan(prev[0][0])
    tfaults.configure_plan(prev[0][1])
    jtelemetry.set_default_registry(prev[1][0])
    ttelemetry.set_default_registry(prev[1][1])
    jfaults.set_default_breaker(prev_breaker)


@pytest.fixture
def measured(tmp_path, monkeypatch):
    """Install a measured-defaults document for both packages: the
    reference reads it through its module path (its cached document
    restored after), the port through ``DEPPY_GPU_MEASURED_DEFAULTS``."""
    path = tmp_path / "measured.json"

    def install(doc: dict) -> None:
        path.write_text(json.dumps(doc))
        monkeypatch.setattr(jcore, "_MEASURED_DEFAULTS_PATH", str(path))
        monkeypatch.setattr(jcore, "_MEASURED_DEFAULTS", None)
        monkeypatch.setenv("DEPPY_GPU_MEASURED_DEFAULTS", str(path))
        tdefaults.reload_measured_defaults()

    return install


def _chain(m, depth: int):
    vs = [m.variable("a0", m.mandatory(), m.dependency("a1"))]
    vs += [m.variable(f"a{i}", m.dependency(f"a{i + 1}"))
           for i in range(1, depth - 1)]
    vs += [m.variable(f"a{depth - 1}")]
    return vs


def _unsat(m):
    return [m.variable("u0", m.mandatory(), m.dependency("u1")),
            m.variable("u1", m.prohibited())]


def _mixed_requests(package: str, n_random: int):
    m = PACKAGES[package][0]
    random_instance = jrandom if package == "reference" else trandom
    reqs = [_chain(m, 32)] * 2 + [_chain(m, 64)] * 2
    reqs += [random_instance(length=16, seed=s) for s in range(n_random)]
    reqs.append(_unsat(m))
    return reqs


def _render(package: str, results):
    io = PACKAGES[package][1]
    return [json.dumps(io.result_to_dict(r), sort_keys=True)
            for r in results]


def _sched(package: str, **kw):
    if package == "reference":
        return JScheduler(backend="tpu", **REF_OFF, **kw)
    return TScheduler(device="cpu", **kw)


def _wins(reg) -> dict:
    return reg.snapshot().get("deppy_race_wins_total") or {}


# ----------------------------------------------------- engine registry


@pytest.mark.parametrize("row", [None, "class", "global", "short"])
@pytest.mark.parametrize("class_name", CLASSES)
@within(60)
def test_ranked_and_candidates_match_reference(class_name, row, measured):
    """``ranked``, ``candidates`` (each availability) and
    ``optimize_candidates`` equal the reference's for every class, with
    no row, a per-class row, a global row and a one-name row (ignored)."""
    docs = {None: {},
            "class": {"cpu": {f"portfolio.{class_name}":
                              "grad_relax,host,hostpool"}},
            "global": {"cpu": {"portfolio": "host,device,warm"}},
            "short": {"cpu": {"portfolio": "host,nonesuch"}}}
    measured(docs[row])
    assert tregistry.ranked(class_name, "cpu") == \
        jregistry.ranked(class_name)
    for k in (2, 3, 5):
        for device_ok in (True, False):
            for pool_ok in (True, False):
                for card in (False, True):
                    assert tregistry.candidates(
                        class_name, k, device_ok=device_ok,
                        pool_ok=pool_ok, cardinality=card,
                        device="cpu") == jregistry.candidates(
                        class_name, k, device_ok=device_ok,
                        pool_ok=pool_ok, cardinality=card)
    for signed in (False, True):
        assert tregistry.optimize_candidates(
            class_name, 3, signed=signed, pool_ok=True, device="cpu") == \
            jregistry.optimize_candidates(class_name, 3, signed=signed,
                                          pool_ok=True)


@within(30)
def test_rows_are_keyed_by_the_devices_platform(measured):
    """A ``gpu`` row ranks ``device="cuda"`` and not ``"cpu"``; a ``cpu``
    row the reverse.  The static order is canonical-first."""
    names, was_measured = tregistry.ranked("m", "cuda")
    assert not was_measured and names[0] == "device"
    assert tuple(names) == tregistry._STATIC_ORDER == \
        jregistry._STATIC_ORDER
    measured({"gpu": {"portfolio.s": "device,host"},
              "cpu": {"portfolio": "host,grad_relax"}})
    assert tregistry.ranked("s", "cuda") == (["device", "host"], True)
    assert tregistry.ranked("s", "cuda:0") == (["device", "host"], True)
    assert tregistry.ranked("m", "cuda") == (list(tregistry._STATIC_ORDER),
                                             False)
    assert tregistry.ranked("s", "cpu") == (["host", "grad_relax"], True)
    assert tdefaults.platform_of(torch.device("cpu")) == "cpu"


@within(30)
def test_class_row_takes_precedence_over_the_global_row(measured):
    """A ``portfolio.<class>`` row beats the global one for its class
    alone; unknown names drop out of a row, and a row left with fewer
    than two backends falls through to the next key."""
    measured({"cpu": {"portfolio": "host,device",
                      "portfolio.m": "grad_relax,host",
                      "portfolio.xs": "nonesuch,host"}})
    for cls, want in (("m", ["grad_relax", "host"]),
                      ("s", ["host", "device"]),
                      ("xs", ["host", "device"])):
        assert tregistry.ranked(cls, "cpu") == jregistry.ranked(cls) == \
            (want, True)
    assert tregistry.ranked("m", "cuda") == (list(tregistry._STATIC_ORDER),
                                             False)


@within(30)
def test_specs_and_estimates():
    """Every spec serves every class with the reference's capabilities;
    estimates fall back to the spec's largest cost."""
    tspecs, jspecs = tregistry.specs(), jregistry.specs()
    assert set(tspecs) == set(jspecs)
    for name, spec in tspecs.items():
        ref = jspecs[name]
        assert (spec.classes, spec.cardinality, spec.warm_start,
                spec.definitive, spec.bound_weights) == \
            (ref.classes, ref.cardinality, ref.warm_start,
             ref.definitive, ref.bound_weights)
        assert set(spec.cost_us) == set(CLASSES)
        assert tregistry.estimate_us(name, "nonesuch") == \
            max(spec.cost_us.values())
    # The warm adapter is ported: no plans, no lanes.
    assert tregistry.solve_via("warm", [], device="cpu") == []
    with pytest.raises(NotImplementedError, match="A6"):
        tregistry.solve_via("device", [], mesh=object(), device="cpu")


@within(30)
def test_measured_defaults_reader(tmp_path, monkeypatch):
    """A missing, corrupt or non-object file is no rows; only string
    values of the device's platform are read; the document is memoized
    until ``reload_measured_defaults``."""
    path = tmp_path / "rows.json"
    monkeypatch.setenv("DEPPY_GPU_MEASURED_DEFAULTS", str(path))
    tdefaults.reload_measured_defaults()
    assert tdefaults.read_rows() == {}
    assert tdefaults.measured_default("portfolio", "cpu") is None
    for bad in ("{not json", "[1, 2]"):
        path.write_text(bad)
        assert tdefaults.read_rows() == {}
    path.write_text(json.dumps({"gpu": {"portfolio": "device,host",
                                        "portfolio.s": 3}}))
    assert tdefaults.measured_default("portfolio", "cpu") is None
    tdefaults.reload_measured_defaults()
    assert tdefaults.measured_default("portfolio", "cuda") == "device,host"
    assert tdefaults.measured_default("portfolio", "cuda:0") == \
        "device,host"
    assert tdefaults.measured_default("portfolio.s", "cuda") is None
    assert tdefaults.measured_default("portfolio", "cpu") is None
    assert tdefaults.registry_path(str(tmp_path / "x.json")) == \
        str(tmp_path / "x.json")


@within(120)
def test_device_adapter_is_decode_identical():
    """``solve_via("device")`` on the CPU decodes to
    ``driver.decode_results``'s answers and equals the reference's
    adapter lane for lane (indices, steps, backtracks)."""
    seeds = range(4)
    tps = [tencode(trandom(length=14, seed=s)) for s in seeds]
    tps += [tencode(_unsat(tsat)), tencode(tpinned(seed=1))]
    jps = [jencode(jrandom(length=14, seed=s)) for s in seeds]
    jps += [jencode(_unsat(jsat)), jencode(jpinned(seed=1))]
    want = tdriver.decode_results(
        tps, tdriver.solve_problems(tps, device="cpu"))
    lanes = tregistry.solve_via("device", tps, device="cpu")
    for p, w, lane in zip(tps, want, lanes):
        got = thostpool.lane_answer(p, lane)
        if isinstance(w, dict):
            assert got == w
        else:
            assert type(got) is type(w)
            assert list(getattr(got, "constraints", [])) == \
                list(getattr(w, "constraints", []))
    ref = jregistry.solve_via("device", jps)
    assert [r.key() for r in lanes] == [r.key() for r in ref]


# ------------------------------------------------------------- racing


@within(240)
def test_race_on_matches_race_off_and_the_reference():
    """Racing on (top-3, every non-canonical win cross-checked) equals
    racing off byte for byte, and equals the reference's racing
    scheduler; steps equal racing off wherever the device won."""
    out = {}
    for package in ("reference", "port"):
        reqs = _mixed_requests(package, 6)
        off_stats: dict = {}
        off = _render(package, _sched(package, portfolio="off").submit(
            reqs, stats=off_stats))
        mod = jtelemetry if package == "reference" else ttelemetry
        reg = mod.Registry()
        on_stats: dict = {}
        on = _render(package, _sched(
            package, portfolio="on", portfolio_k=3,
            portfolio_sample_check=1.0, registry=reg).submit(
            reqs, stats=on_stats))
        assert on == off, package
        wins = _wins(reg)
        assert sum(wins.values()) == 1
        assert not reg.snapshot().get("deppy_race_check_mismatch_total")
        if set(wins) == {"device"}:
            assert on_stats["steps"] == off_stats["steps"]
        out[package] = (off, off_stats["steps"])
    assert out["port"] == out["reference"]


@within(120)
def test_race_reports_and_events():
    """One race: a ``race`` span, starts for every entrant, one win, and
    a ``race`` event naming the winner and the losers."""
    reg = ttelemetry.Registry()
    reqs = [_chain(tsat, 48)] * 3
    stats: dict = {}
    TScheduler(device="cpu", portfolio="on", portfolio_k=3,
               portfolio_sample_check=0.0, registry=reg).submit(
        reqs, stats=stats)
    snap = reg.snapshot()
    assert snap["deppy_race_starts_total"] == {"device": 1, "host": 1,
                                               "grad_relax": 1}
    assert sum(snap["deppy_race_wins_total"].values()) == 1
    races = [s for s in reg.recent_spans() if s["name"] == "race"]
    assert len(races) == 1 and races[0]["attrs"]["entrants"] == 3
    assert stats["report"].outcomes["sat"] == 3


@pytest.mark.parametrize("mode", ["off", "auto"])
@within(60)
def test_portfolio_off_and_auto_register_nothing(mode):
    reqs = [trandom(length=12, seed=3)]
    reg = ttelemetry.Registry()
    TScheduler(device="cpu", portfolio=mode, registry=reg).submit(reqs)
    assert not any(k.startswith("deppy_race") for k in reg.snapshot())


@within(180)
def test_auto_races_with_a_measured_row(measured):
    measured({"cpu": {"portfolio": "host,grad_relax,device"}})
    for package in ("reference", "port"):
        m = PACKAGES[package][0]
        reqs = [_chain(m, 32)] * 2
        mod = jtelemetry if package == "reference" else ttelemetry
        reg = mod.Registry()
        off = _render(package, _sched(package, portfolio="off").submit(reqs))
        got = _render(package, _sched(
            package, portfolio="auto", portfolio_sample_check=0.0,
            registry=reg).submit(reqs))
        assert got == off
        assert sum(_wins(reg).values()) == 1


@within(60)
def test_host_backend_races_with_host_canonical():
    """On ``backend="host"`` the device never races and the canonical
    entrant is the host engine."""
    reqs = [_chain(tsat, 24)] * 2 + [_unsat(tsat)]
    reg = ttelemetry.Registry()
    sched = TScheduler(backend="host", device="cpu", portfolio="on",
                       portfolio_sample_check=1.0, registry=reg)
    plan = sched._racer.plan(
        [tsched_mod._Lane(tencode(vs), "k", None, 1, None) for vs in reqs],
        "host")
    assert plan.canonical == "host" and "device" not in plan.names
    off = _render("port", TScheduler(backend="host", device="cpu",
                                     portfolio="off").submit(reqs))
    assert _render("port", sched.submit(reqs)) == off


# -------------------------------------------------------------- chaos


@within(240)
def test_poisoned_loser_never_corrupts_the_winner():
    for package in ("reference", "port"):
        reqs = _mixed_requests(package, 4)
        off = _render(package, _sched(package, portfolio="off").submit(reqs))
        faults = jfaults if package == "reference" else tfaults
        mod = jtelemetry if package == "reference" else ttelemetry
        prev = faults.configure_plan(faults.plan_from_spec(json.dumps(
            {"faults": [{"point": "sched.race.device", "kind": "error",
                         "times": -1}]})))
        reg = mod.Registry()
        try:
            chaos = _render(package, _sched(
                package, portfolio="on", portfolio_k=3,
                portfolio_sample_check=0.0, registry=reg).submit(reqs))
        finally:
            faults.configure_plan(prev)
        assert chaos == off, package
        assert not _wins(reg).get("device")
        assert reg.snapshot()["deppy_race_cancels_total"]["device"] == 1


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


def _race_device_first(monkeypatch, error, reg):
    """One raced submit whose device entrant raises ``error`` before the
    host entrant (which waits for it) finishes: the answers, or the
    exception the submit raised."""
    host_solve = tregistry._SOLVERS["host"]
    failed = threading.Event()

    def device_fails(problems, *args, **kwargs):
        failed.set()
        raise error

    def host_second(problems, *args, **kwargs):
        # Finish only after the device entrant's thread has ended.
        failed.wait(30)
        for t in threading.enumerate():
            if t.name == "deppy-race-device":
                t.join(30)
        return host_solve(problems, *args, **kwargs)

    monkeypatch.setitem(tregistry._SOLVERS, "device", device_fails)
    monkeypatch.setitem(tregistry._SOLVERS, "host", host_second)
    try:
        return TScheduler(device="cpu", portfolio="on", portfolio_k=2,
                          portfolio_sample_check=0.0, registry=reg).submit(
            [_chain(tsat, 16)] * 2)
    except RuntimeError as e:
        return e
    finally:
        monkeypatch.setitem(tregistry._SOLVERS, "host", host_solve)


@within(120)
def test_a_raising_device_entrant_raises_into_its_dispatch(monkeypatch):
    """A device entrant whose solve raises a device fault loses the race,
    as in the reference (the driver's envelope has already retried it):
    counted and evented with its type, the host answer served.  One that
    raises a defect of the tree (a kernel that does not build) is not a
    lost entrant: its error reaches the flush's submitter, as racing off
    would raise it, and no host answer is served around it."""
    reqs = [_chain(tsat, 16)] * 2
    off = _render("port", TScheduler(device="cpu",
                                     portfolio="off").submit(reqs))
    for error, raises in ((RuntimeError("launch failed"), False),
                          (KernelBuildError("kernel build failed"), True),
                          (KernelLaunchError("launch refused"), True)):
        reg = ttelemetry.Registry()
        with _FaultEvents() as ev:
            out = _race_device_first(monkeypatch, error, reg)
        snap = reg.snapshot()
        assert snap["deppy_race_entrant_errors_total"] == {"device": 1}
        (e,) = ev.of("race_entrant_error")
        assert e["backend"] == "device"
        assert e["error"] == f"{type(error).__name__}: {error}"
        if raises:
            assert out is error
            assert not _wins(reg)
        else:
            assert _render("port", out) == off
            assert _wins(reg) == {"host": 1}


@within(120)
def test_cuda_without_a_card_raises_into_the_raced_dispatch(monkeypatch):
    """``Scheduler(device="cuda", portfolio="on")`` on a machine without a
    card: the device entrant's ``NoDeviceError`` reaches the submitter,
    and no host answer is served around it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device_solve = tregistry._SOLVERS["device"]
    host_solve = tregistry._SOLVERS["host"]
    ended = threading.Event()

    def device_then_flag(*args, **kwargs):
        try:
            return device_solve(*args, **kwargs)
        finally:
            ended.set()

    def host_second(*args, **kwargs):
        ended.wait(30)
        for t in threading.enumerate():
            if t.name == "deppy-race-device":
                t.join(30)
        return host_solve(*args, **kwargs)

    monkeypatch.setitem(tregistry._SOLVERS, "device", device_then_flag)
    monkeypatch.setitem(tregistry._SOLVERS, "host", host_second)
    reg = ttelemetry.Registry()
    sched = TScheduler(device="cuda", portfolio="on", portfolio_k=2,
                       portfolio_sample_check=0.0, registry=reg)
    with _FaultEvents() as ev:
        with pytest.raises(tdriver.NoDeviceError, match="cuda"):
            sched.submit([_chain(tsat, 16)] * 2)
    assert reg.snapshot()["deppy_race_starts_total"]["device"] == 1
    assert not _wins(reg)
    (e,) = ev.of("race_entrant_error")
    assert e["backend"] == "device" and e["error"].startswith(
        "NoDeviceError")


@within(120)
def test_a_device_error_after_the_win_raises_into_the_next_dispatch(
        monkeypatch):
    """A device entrant that raises after another entrant's answer was
    served is counted and evented at once.  A defect of the tree (a
    kernel that does not build) fails the scheduler's next dispatch, and
    the one after races again; a device fault fails nothing."""
    device_solve = tregistry._SOLVERS["device"]
    reqs = [_chain(tsat, 16)] * 2
    off = _render("port", TScheduler(device="cpu",
                                     portfolio="off").submit(reqs))
    for error in (RuntimeError("launch failed"),
                  KernelBuildError("kernel build failed")):
        served = threading.Event()

        def device_late(problems, *args, _error=error, _served=served,
                        **kwargs):
            _served.wait(30)
            raise _error

        monkeypatch.setitem(tregistry._SOLVERS, "device", device_late)
        reg = ttelemetry.Registry()
        sched = TScheduler(device="cpu", portfolio="on", portfolio_k=2,
                           portfolio_sample_check=0.0, cache_size=0,
                           registry=reg)
        with _FaultEvents() as ev:
            assert _render("port", sched.submit(reqs)) == off
            assert _wins(reg) == {"host": 1}
            served.set()
            tsched_mod._join_race_threads()
            assert [e["backend"] for e in ev.of("race_entrant_error")] == \
                ["device"]
        assert reg.snapshot()["deppy_race_entrant_errors_total"] == \
            {"device": 1}
        if isinstance(error, KernelBuildError):
            with pytest.raises(KernelBuildError, match="kernel build"):
                sched.submit(reqs)
        monkeypatch.setitem(tregistry._SOLVERS, "device", device_solve)
        assert _render("port", sched.submit(reqs)) == off
        assert sum(_wins(reg).values()) == 2


@within(240)
def test_noncanonical_incomplete_never_wins(monkeypatch):
    """An instantly finishing all-Incomplete non-canonical entrant must
    not win where the canonical engine decides."""
    from deppy_tpu.hostpool.worker import HostLaneResult as JHostLaneResult

    def j_incomplete(problems, max_steps, deadlines, cancel, mesh=None):
        return [JHostLaneResult("incomplete", [], [], 1) for _ in problems]

    def t_incomplete(problems, max_steps, deadlines, cancel, mesh=None,
                     device="cuda"):
        return [THostLaneResult("incomplete", [], [], 1) for _ in problems]

    monkeypatch.setitem(jregistry._SOLVERS, "grad_relax", j_incomplete)
    monkeypatch.setitem(tregistry._SOLVERS, "grad_relax", t_incomplete)
    for package in ("reference", "port"):
        random_instance = jrandom if package == "reference" else trandom
        reqs = [random_instance(length=12, seed=s) for s in range(4)]
        off = _render(package, _sched(package, portfolio="off").submit(reqs))
        mod = jtelemetry if package == "reference" else ttelemetry
        reg = mod.Registry()
        on = _render(package, _sched(
            package, portfolio="on", portfolio_k=3,
            portfolio_sample_check=0.0, registry=reg).submit(reqs))
        assert on == off, package
        assert not _wins(reg).get("grad_relax")


@within(240)
def test_every_entrant_poisoned_falls_back_to_canonical():
    for package in ("reference", "port"):
        random_instance = jrandom if package == "reference" else trandom
        reqs = [random_instance(length=12, seed=7)]
        off = _render(package, _sched(package, portfolio="off").submit(reqs))
        faults = jfaults if package == "reference" else tfaults
        prev = faults.configure_plan(faults.plan_from_spec(json.dumps(
            {"faults": [{"point": "sched.race.*", "kind": "error",
                         "times": -1}]})))
        try:
            got = _render(package, _sched(
                package, portfolio="on", portfolio_k=3,
                portfolio_sample_check=0.0).submit(reqs))
        finally:
            faults.configure_plan(prev)
        assert got == off, package


@within(120)
def test_a_mismatching_winner_serves_the_canonical_answer(monkeypatch):
    """A sampled cross-check that disagrees counts a mismatch and serves
    the canonical (device) answer."""
    answered = threading.Event()
    device_solve = tregistry._SOLVERS["device"]

    def wrong(problems, max_steps, deadlines, cancel, mesh=None,
              device="cuda"):
        answered.set()
        return [THostLaneResult("sat", [], [], 1) for _ in problems]

    def device_after(problems, *args, **kwargs):
        # The device finishes second, whatever the scheduling.
        answered.wait(30)
        return device_solve(problems, *args, **kwargs)

    monkeypatch.setitem(tregistry._SOLVERS, "host", wrong)
    monkeypatch.setitem(tregistry._SOLVERS, "device", device_after)
    reqs = [_chain(tsat, 16)] * 2
    off = _render("port", TScheduler(device="cpu",
                                     portfolio="off").submit(reqs))
    reg = ttelemetry.Registry()
    got = _render("port", TScheduler(device="cpu", portfolio="on",
                                     portfolio_sample_check=1.0,
                                     registry=reg).submit(reqs))
    assert got == off
    snap = reg.snapshot()
    # The (wrong) host entrant finishes first; the check serves the
    # device's answer, and the win is counted for the device.
    assert snap["deppy_race_check_mismatch_total"] == 1
    assert snap["deppy_race_wins_total"] == {"device": 1}


# -------------------------------------------------------- grad_relax


def _jax_logits(problems):
    """The reference's descent (``grad_relax.py:57-106``) with its final
    logits returned instead of their rounding; pinned to the reference
    by :func:`test_descent_logits_match_jax`'s rounding check."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = len(problems)
    d = jdriver._Dims(problems, max(n, 1))
    pts = jdriver.pad_stack(problems, d, d.B, pack=False)
    NV = d.NV

    def one(clauses, card_ids, card_n, card_valid, anchors, n_vars):
        var = jnp.abs(clauses) - 1
        pv = jnp.clip(var, 0, NV - 1)
        is_act = var >= n_vars
        pad = clauses == 0
        mmask = card_ids >= 0
        mv = jnp.clip(card_ids, 0, NV - 1)
        amask = anchors >= 0
        av = jnp.clip(anchors, 0, NV - 1)
        valid_row = (~pad).any(axis=1)

        def loss(x):
            p = jax.nn.sigmoid(x)
            p_eff = jnp.where(is_act, 1.0, p[pv])
            s = jnp.where(clauses > 0, p_eff, 1.0 - p_eff)
            un = jnp.where(pad, 1.0, 1.0 - s)
            total = jnp.where(valid_row, jnp.prod(un, axis=1), 0.0).sum()
            mp = jnp.where(mmask, p[mv], 0.0)
            over = jnp.maximum(mp.sum(axis=1) - card_n, 0.0)
            total += jnp.where(card_valid > 0, over * over, 0.0).sum()
            return total + jnp.where(amask, 1.0 - p[av], 0.0).sum()

        grad = jax.grad(loss)
        return lax.fori_loop(
            0, jgrad.DESCENT_ITERS,
            lambda _, x: x - jgrad.DESCENT_LR * grad(x),
            jnp.zeros(NV, jnp.float32))

    out = jax.jit(jax.vmap(one))(
        pts.clauses, pts.card_ids, pts.card_n.astype(np.float32),
        pts.card_valid, pts.anchors, pts.n_vars)
    return np.asarray(out)[:n]


GRAD_SHAPES = {
    "random": (lambda m, s: jrandom(length=16, seed=s),
               lambda m, s: trandom(length=16, seed=s), 4),
    "chains": (lambda m, s: jchains(20, 3, seed=s),
               lambda m, s: tchains(20, 3, seed=s), 4),
    "tenants": (lambda m, s: jpinned(seed=s),
                lambda m, s: tpinned(seed=s), 4),
    "deep_chain": (lambda m, s: _chain(jsat, 96),
                   lambda m, s: _chain(tsat, 96), 1),
}


@pytest.mark.parametrize("shape", sorted(GRAD_SHAPES))
@within(120)
def test_descent_logits_match_jax(shape):
    jbuild, tbuild, n = GRAD_SHAPES[shape]
    jps = [jencode(jbuild(jsat, s)) for s in range(n)]
    tps = [tencode(tbuild(tsat, s)) for s in range(n)]
    jl = _jax_logits(jps)
    jmodels = np.asarray(jgrad.candidate_models(jps))
    live = np.arange(jl.shape[1]) < np.array([p.n_vars for p in jps])[:, None]
    # The test's copy of the descent rounds exactly as the reference's.
    assert np.array_equal((1.0 / (1.0 + np.exp(-jl)) > 0.5) & live, jmodels)
    tl = tgrad.candidate_logits(tps, device="cpu").numpy()
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
    tmodels = tgrad.candidate_models(tps, device="cpu")
    far = np.abs(1.0 / (1.0 + np.exp(-tl)) - 0.5) > MARGIN
    assert np.array_equal(tmodels[far], jmodels[far])
    assert far[live].any()


@within(60)
def test_descent_is_reproducible_and_its_gradient_is_autograds():
    """Two runs agree bit for bit, and the fixed-point scatter's
    gradient equals autograd through ``p[pv]`` on the CPU (float32
    summation order aside)."""
    tps = [tencode(tchains(20, 3, seed=s)) for s in range(3)]
    a = tgrad.candidate_logits(tps, device="cpu")
    b = tgrad.candidate_logits(tps, device="cpu")
    assert torch.equal(a, b)
    g = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    idx = torch.randint(0, 16, (3, 50),
                        generator=torch.Generator().manual_seed(1))
    want = torch.zeros(3, 16).scatter_add_(1, idx, g)
    torch.testing.assert_close(tgrad._segment_sum(g, idx, 16), want,
                               rtol=0, atol=1e-6)
    # One descent step through plain autograd on x.
    d = tdriver._Dims(tps, 3)
    pts = tdriver.pad_stack(tps, d, d.B)
    f = [torch.from_numpy(np.ascontiguousarray(x)) for x in
         (pts.clauses, pts.card_ids, pts.card_n, pts.card_valid,
          pts.anchors, pts.n_vars)]
    one_step = tgrad._descend(*f, NV=d.NV, iters=1)
    x = torch.zeros(d.B, d.NV, requires_grad=True)
    p = torch.sigmoid(x)
    clauses, card_ids, card_n, card_valid, anchors, n_vars = f
    var = clauses.abs().long() - 1
    pv = var.clamp(0, d.NV - 1)
    pe = torch.gather(p, 1, pv.view(d.B, -1)).view(pv.shape)
    p_eff = torch.where(var >= n_vars.long().view(-1, 1, 1), 1.0, pe)
    s = torch.where(clauses > 0, p_eff, 1.0 - p_eff)
    un = torch.where(clauses == 0, 1.0, 1.0 - s)
    total = torch.where((clauses != 0).any(2), un.prod(2), 0.0).sum()
    mv = card_ids.long().clamp(0, d.NV - 1)
    pm = torch.where(card_ids >= 0,
                     torch.gather(p, 1, mv.view(d.B, -1)).view(mv.shape),
                     0.0)
    over = torch.clamp(pm.sum(2) - card_n.float(), min=0.0)
    total = total + torch.where(card_valid > 0, over * over, 0.0).sum()
    av = anchors.long().clamp(0, d.NV - 1)
    total = total + torch.where(anchors >= 0,
                                1.0 - torch.gather(p, 1, av), 0.0).sum()
    (gx,) = torch.autograd.grad(total, [x])
    torch.testing.assert_close(one_step, -tgrad.DESCENT_LR * gx,
                               rtol=1e-6, atol=1e-7)


@within(60)
def test_unverified_roundings_are_never_served():
    p = tencode(_unsat(tsat))
    assert tgrad.attempt(p, np.ones(p.n_vars, dtype=bool)) is None
    assert tgrad.attempt(p, np.zeros(p.n_vars, dtype=bool)) is None


@within(120)
def test_guided_solve_matches_canonical_and_the_reference():
    """Every served lane is the canonical answer exactly, and the port
    serves the same lanes (same answers, same steps) as the reference."""
    tps = [tencode(trandom(length=16, seed=s)) for s in range(10)]
    jps = [jencode(jrandom(length=16, seed=s)) for s in range(10)]
    got = tgrad.solve_lanes(tps, device="cpu")
    ref = jgrad.solve_lanes(jps)
    for p, r in zip(tps, got):
        if r is not None:
            assert r.outcome == "sat"
            assert r.installed_idx == HostEngine(p).solve()[1]
    assert [None if r is None else r.key() for r in got] == \
        [None if r is None else r.key() for r in ref]


@within(60)
def test_chain_serves_via_fixpoint_shortcut():
    p = tencode(_chain(tsat, 96))
    r = tgrad.solve_lanes([p], device="cpu")[0]
    want = HostEngine(p).solve()[1]
    assert r is not None and r.installed_idx == want
    eng = HostEngine(p)
    eng.solve()
    assert r.steps < eng.steps or eng.steps <= 2


@within(30)
def test_baseline_unsat_raises():
    eng = HostEngine(tencode(_unsat(tsat)))
    with pytest.raises(GuidanceUnverified):
        eng.solve_guided(None)


@within(30)
def test_cancel_stops_at_step_boundary():
    stop = threading.Event()
    stop.set()
    eng = HostEngine(tencode(_chain(tsat, 64)), cancel=stop)
    with pytest.raises(SolveCancelled):
        eng.solve()
    with pytest.raises(SolveCancelled):
        tgrad.solve_lanes([tencode(_chain(tsat, 8))], cancel=stop,
                          device="cpu")


@within(30)
def test_expired_deadline_degrades_the_grad_lane():
    p = tencode(_chain(tsat, 8))
    r = tgrad.attempt(p, None, deadline=tfaults.Deadline(0.0))
    assert r.degraded and r.outcome == "incomplete"


@within(30)
def test_chain_requests_match_the_reference_benchmarks():
    """The port's copy of ``deppy_tpu/benchmarks/hard.py``'s
    ``chain_requests`` lowers to the same problems."""
    from deppy_tpu.benchmarks.hard import DEPTHS as JDEPTHS
    from deppy_tpu.benchmarks.hard import chain_requests as jchain_requests
    from deppy_tpu_torch.models import chain_requests
    from deppy_tpu_torch.models.hard import DEPTHS

    assert DEPTHS == JDEPTHS
    got = [tencode(vs) for vs in chain_requests((5, 9), 2)]
    want = [jencode(vs) for vs in jchain_requests((5, 9), 2)]
    assert len(got) == len(want) == 4
    for t, j in zip(got, want):
        assert t.n_vars == j.n_vars and t.n_cons == j.n_cons
        for field in ("clauses", "card_ids", "anchors", "choice_cand"):
            assert np.array_equal(getattr(t, field), getattr(j, field))


# --------------------------------------------------- straggler triage


@within(120)
def test_tight_deadline_lanes_resubmit_to_the_pool():
    for package in ("reference", "port"):
        m = PACKAGES[package][0]
        mod = jtelemetry if package == "reference" else ttelemetry
        reg = mod.Registry()
        sched = _sched(package, portfolio="on", portfolio_k=3,
                       portfolio_sample_check=0.0, registry=reg)
        sched._dispatch_ewma_s = 30.0  # any finite deadline is tight
        results = sched.submit([_chain(m, 32), _chain(m, 32)],
                               deadline_s=20.0)
        snap = reg.snapshot()
        assert snap.get("deppy_race_straggler_resubmits_total") == 2
        assert [PACKAGES[package][1].result_to_dict(r)["status"]
                for r in results] == ["sat", "sat"]


@within(120)
def test_stragglers_beside_batchmates():
    """Only the tight-deadline request resubmits; its batchmate without
    a deadline is raced, and both answers equal racing off."""
    reg = ttelemetry.Registry()
    sched = TScheduler(device="cpu", portfolio="on",
                       portfolio_sample_check=0.0, registry=reg,
                       max_wait_ms=200.0)
    sched._dispatch_ewma_s = 30.0
    reqs = [[_chain(tsat, 20)], [_chain(tsat, 40)]]
    out = [None, None]
    sched.start()
    try:
        def tight():
            out[0] = sched.submit(reqs[0], deadline_s=20.0)

        t = threading.Thread(target=tight)
        t.start()
        out[1] = sched.submit(reqs[1])
        t.join()
    finally:
        sched.stop()
    snap = reg.snapshot()
    assert snap["deppy_race_straggler_resubmits_total"] == 1
    off = TScheduler(device="cpu", portfolio="off")
    for req, got in zip(reqs, out):
        assert _render("port", got) == _render("port", off.submit(req))


@within(60)
def test_triage_off_without_racer():
    reg = ttelemetry.Registry()
    sched = TScheduler(device="cpu", portfolio="off", registry=reg)
    sched._dispatch_ewma_s = 30.0
    results = sched.submit([_chain(tsat, 32)], deadline_s=20.0)
    assert "deppy_race_straggler_resubmits_total" not in reg.snapshot()
    assert tio.result_to_dict(results[0])["status"] == "sat"


# ------------------------------------------------------- two threads


@within(180)
def test_two_threads_in_the_driver_give_the_single_thread_answers():
    """``driver.solve_problems(device="cpu")`` from two threads at once
    (as a losing device entrant and the next flush's can be), switching
    often, returns what each returns alone."""
    batches = [[tencode(tpinned(seed=s)) for s in range(6)],
               [tencode(tchains(20, 3, seed=s)) for s in range(6)]]

    def key(results):
        return [(r.outcome, r.steps, r.trace_n,
                 np.asarray(r.installed).tolist(),
                 np.asarray(r.core).tolist()) for r in results]

    alone = [key(tdriver.solve_problems(b, device="cpu")) for b in batches]
    got = [None, None]
    gate = threading.Barrier(2)

    def run(i):
        gate.wait()
        got[i] = key(tdriver.solve_problems(batches[i], device="cpu"))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(150)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert got == alone
