"""The port's fault domain against the JAX package's, on the CPU.

The retry policy, the circuit breaker, the driver's recovery envelope
(retry, split, host fallback, deadlines, the chunk deadline), the budget
escalation ladder, group checkpoints and the ``auto`` backend (its
probe, the scheduler's flushes, the breaker-open drain and the deferred
re-probe, the racer and the warm screen under an open breaker) run on
both packages: the same fault plan, fresh breakers on a fake clock
where the scenario reads time, and no backoff.  Each scenario compares
outcome, installed set, core and steps, the fault counters' values and
the breaker's state sequence, with tolerance 0.  The port's one
deliberate difference, the defects of the tree passing through the
envelope untouched, is shown on its own.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from deppy_tpu import faults as jfaults
from deppy_tpu import io as jio
from deppy_tpu import sat as jsat
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import checkpoint as jcheckpoint
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import random_instance
from deppy_tpu.resolution import BatchResolver as JBatchResolver
from deppy_tpu.sat import solver as jsolver
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import checkpoint as tcheckpoint
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine._build import KernelBuildError, KernelLaunchError
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.resolution import BatchResolver as TBatchResolver
from deppy_tpu_torch.sat import solver as tsolver
from deppy_tpu_torch.sat.encode import encode as tencode
from deppy_tpu_torch.sched import Scheduler as TScheduler

PACKAGES = ("reference", "port")
FAULTS = {"reference": jfaults, "port": tfaults}
TELEMETRY = {"reference": jtelemetry, "port": ttelemetry}
DRIVER = {"reference": jdriver, "port": tdriver}
SOLVER = {"reference": jsolver, "port": tsolver}
CHECKPOINT = {"reference": jcheckpoint, "port": tcheckpoint}
PREFIX = {"reference": "DEPPY_TPU_", "port": "DEPPY_GPU_"}
DEVICE = {"reference": "tpu", "port": "device"}
REF_OFF = dict(portfolio="off", speculate="off")
COUNTERS = ("deppy_fault_retries", "deppy_fault_failures_total",
            "deppy_fault_host_routed_total", "deppy_deadline_exceeded",
            "deppy_breaker_transitions_total", "deppy_escalation_total")


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Per test: each package's fault plan, default registry (with a
    recorder of its ``breaker`` and ``fault`` events) and breaker; no
    backoff, no host pool, no ambient deadline, escalation off."""
    for package in PACKAGES:
        p = PREFIX[package]
        monkeypatch.setenv(f"{p}FAULT_BACKOFF_S", "0")
        monkeypatch.setenv(f"{p}HOST_WORKERS", "0")
        for knob in ("BATCH_DEADLINE_S", "CHUNK_DEADLINE_S",
                     "FAULT_RETRIES", "REPROBE"):
            monkeypatch.delenv(f"{p}{knob}", raising=False)
        monkeypatch.setattr(DRIVER[package], "STAGE1_STEPS", 0)
    prev = {}
    for package in PACKAGES:
        f, tel = FAULTS[package], TELEMETRY[package]
        reg = tel.Registry()
        reg.events_seen = []
        reg.add_forwarder(reg.events_seen.append)
        prev[package] = (f.configure_plan(None),
                         f.set_default_breaker(f.CircuitBreaker()),
                         tel.set_default_registry(reg))
    yield
    for package in PACKAGES:
        f, tel = FAULTS[package], TELEMETRY[package]
        plan, breaker, reg = prev[package]
        f.configure_plan(plan)
        f.set_default_breaker(breaker)
        tel.set_default_registry(reg)


def both(fn):
    """``fn(package)`` on each package: {package: result}."""
    return {package: fn(package) for package in PACKAGES}


def plan(package: str, spec: str) -> None:
    FAULTS[package].configure_plan(FAULTS[package].plan_from_spec(spec))


def breaker(package: str, **kw):
    """A fresh default breaker for ``package``."""
    br = FAULTS[package].CircuitBreaker(**kw)
    FAULTS[package].set_default_breaker(br)
    return br


def observed(package: str) -> dict:
    """The fault counters' values and the breaker's state sequence."""
    reg = TELEMETRY[package].default_registry()
    snap = reg.snapshot()
    out = {name: snap.get(name, 0) for name in COUNTERS}
    out["breaker"] = [e["state"] for e in reg.events_seen
                      if e.get("kind") == "breaker"]
    return out


def faults_seen(package: str, fault: str) -> list:
    return [e for e in TELEMETRY[package].default_registry().events_seen
            if e.get("kind") == "fault" and e.get("fault") == fault]


def key(r) -> tuple:
    return (int(r.outcome), np.nonzero(np.asarray(r.installed))[0].tolist(),
            np.nonzero(np.asarray(r.core))[0].tolist(), int(r.steps))


def keys(results) -> list:
    return [key(r) for r in results]


def answers(results) -> list:
    """Outcome, installed set and core (the checkpoint round trip's
    equality: a group may pad to other widths and route its cores
    otherwise than the whole batch)."""
    return [k[:3] for k in keys(results)]


def make_problems(n: int = 8, seed0: int = 0, length: int = 10):
    jvars = [random_instance(length=length, seed=seed0 + s)
             for s in range(n)]
    return {"reference": [jencode(vs) for vs in jvars],
            "port": [tencode(variables_from_objects(vs)) for vs in jvars]}


def solve(package: str, problems, **kw):
    if package == "port":
        kw.setdefault("device", "cpu")
    return DRIVER[package].solve_problems(problems[package], **kw)


@pytest.fixture(scope="module")
def batch():
    return make_problems()


@pytest.fixture(scope="module")
def clean(batch):
    out = {package: keys(solve(package, batch)) for package in PACKAGES}
    assert out["port"] == out["reference"]
    return out


# ---------------------------------------------------------------- policy


def _retry_script(f, prefix, monkeypatch) -> list:
    p = f.RetryPolicy(base_backoff_s=0.1, max_backoff_s=0.5,
                      multiplier=2.0, jitter=0.0)
    out = [round(p.backoff_s(k), 9) for k in (1, 2, 3, 4, 10)]
    p = f.RetryPolicy(base_backoff_s=0.1, jitter=0.5)
    out += [round(p.backoff_s(1, rng=lambda: 0.0), 9),
            round(p.backoff_s(1, rng=lambda: 1.0), 9)]
    monkeypatch.setenv(f"{prefix}FAULT_RETRIES", "5")
    monkeypatch.setenv(f"{prefix}FAULT_BACKOFF_S", "0.25")
    monkeypatch.setenv(f"{prefix}FAULT_BACKOFF_MAX_S", "3")
    monkeypatch.setenv(f"{prefix}CHUNK_DEADLINE_S", "0.5")
    p = f.RetryPolicy.from_env()
    out.append((p.max_attempts, p.base_backoff_s, p.max_backoff_s,
                p.chunk_deadline_s))
    monkeypatch.setenv(f"{prefix}FAULT_RETRIES", "lots")
    monkeypatch.setenv(f"{prefix}CHUNK_DEADLINE_S", "-1")
    p = f.RetryPolicy.from_env()
    out.append((p.max_attempts, p.chunk_deadline_s))
    return out


def test_retry_policy(monkeypatch):
    """Backoff grows and clamps, jitter stays in bounds, ``from_env``
    reads the four knobs and a malformed value degrades to the default."""
    got = both(lambda package: _retry_script(
        FAULTS[package], PREFIX[package], monkeypatch))
    assert got["port"] == got["reference"]
    assert got["port"] == [0.1, 0.2, 0.4, 0.5, 0.5, 0.1, 0.15,
                           (5, 0.25, 3.0, 0.5), (2, 0.0)]


# ---------------------------------------------------------------- breaker


def _trips(f, clock):
    br = f.CircuitBreaker(failure_threshold=3, reset_after_s=60, clock=clock)
    return [br.record_failure(), br.record_failure(), br.state(),
            br.allow(), br.record_failure(), br.state(), br.allow(),
            br.blocks_device()]


def _streak(f, clock):
    br = f.CircuitBreaker(failure_threshold=2, reset_after_s=60, clock=clock)
    br.record_failure()
    br.record_success()
    return [br.record_failure(), br.state()]


def _half_open_closes(f, clock):
    br = f.CircuitBreaker(failure_threshold=1, reset_after_s=10, clock=clock)
    br.record_failure()
    out = [br.state(), br.allow()]
    clock.t += 11
    out += [br.state(), br.blocks_device(), br.allow(), br.allow()]
    br.record_success()
    return out + [br.state(), br.allow()]


def _abandoned_probe(f, clock):
    br = f.CircuitBreaker(failure_threshold=1, reset_after_s=10, clock=clock)
    br.record_failure()
    clock.t += 11
    out = [br.allow()]
    br.abandon_probe()
    out.append(br.allow())
    br.record_success()
    return out + [br.state()]


def _probe_failure_reopens(f, clock):
    br = f.CircuitBreaker(failure_threshold=1, reset_after_s=10, clock=clock)
    br.record_failure()
    clock.t += 11
    out = [br.allow(), br.record_failure(), br.state(), br.remaining_s()]
    clock.t += 4
    return out + [br.remaining_s(), br.state_code()]


def _telemetry(f, clock):
    br = f.CircuitBreaker(failure_threshold=1, reset_after_s=60, clock=clock)
    br.record_failure()
    return [br.state_code(), br.state()]


def _reset(f, clock):
    br = f.CircuitBreaker(failure_threshold=1, reset_after_s=60, clock=clock)
    br.record_failure()
    br.reset()
    return [br.state(), br.state_code(), br.remaining_s()]


BREAKER_SCRIPTS = {
    "trips": (_trips, [False, False, "closed", True, True, "open", False,
                       True]),
    "streak": (_streak, [False, "closed"]),
    "half-open-closes": (_half_open_closes,
                         ["open", False, "half_open", False, True, False,
                          "closed", True]),
    "abandoned-probe": (_abandoned_probe, [True, True, "closed"]),
    "probe-failure-reopens": (_probe_failure_reopens,
                              [True, True, "open", 10.0, 6.0, 2]),
    "telemetry": (_telemetry, [2, "open"]),
    "reset": (_reset, ["closed", 0, 0.0]),
}


@pytest.mark.parametrize("name", list(BREAKER_SCRIPTS))
def test_circuit_breaker(name):
    """Each breaker script of the reference's suite on both packages:
    the same verdicts, states and cooldowns, the same gauge, transitions
    counter and ``breaker`` events."""
    fn, want = BREAKER_SCRIPTS[name]
    got = both(lambda package: fn(FAULTS[package], Clock()))
    assert got["port"] == got["reference"] == want
    snaps = both(lambda package: (
        TELEMETRY[package].default_registry().snapshot().get(
            "deppy_breaker_state"), observed(package)))
    assert snaps["port"] == snaps["reference"]


def test_default_breaker_env_config(monkeypatch):
    def read(package):
        monkeypatch.setenv(f"{PREFIX[package]}BREAKER_THRESHOLD", "7")
        monkeypatch.setenv(f"{PREFIX[package]}BREAKER_RESET_S", "2.5")
        FAULTS[package].set_default_breaker(None)
        br = FAULTS[package].default_breaker()
        return br.failure_threshold, br.reset_after_s

    assert both(read) == {"reference": (7, 2.5), "port": (7, 2.5)}


def test_fresh_trip_dumps_the_flight_recorder(monkeypatch):
    """A closed→open trip dumps the flight recorder once; a half-open
    probe failure re-opens without a second dump."""
    dumps = []
    monkeypatch.setattr(ttelemetry.trace, "notify_breaker_open",
                        lambda: dumps.append(1))
    clock = Clock()
    br = tfaults.CircuitBreaker(failure_threshold=1, reset_after_s=10,
                                clock=clock)
    br.record_failure()
    clock.t += 11
    assert br.allow()
    br.record_failure()
    assert dumps == [1]


# --------------------------------------------------- the driver envelope


def _transient(point):
    def run(package, batch):
        plan(package, f'[{{"point": "{point}", "times": 1}}]')
        return solve(package, batch)
    return run


def _every_first_attempt(package, batch, tmp_path):
    sink = tmp_path / f"{package}.jsonl"
    TELEMETRY[package].default_registry().configure_sink(str(sink))
    plan(package, '[{"point": "driver.dispatch", "period": 2, '
                  '"times": 1}]')
    try:
        return solve(package, batch)
    finally:
        TELEMETRY[package].default_registry().configure_sink(None)
        kinds = {json.loads(line)["kind"]
                 for line in sink.read_text().splitlines()}
        assert {"fault", "span"} <= kinds


def _persistent(package, batch):
    breaker(package, failure_threshold=2, reset_after_s=60)
    plan(package, '[{"point": "driver.dispatch", "times": -1}]')
    return solve(package, batch)


def _open_short_circuits(package, batch):
    breaker(package, failure_threshold=1, reset_after_s=60).record_failure()
    FAULTS[package].configure_plan(FAULTS[package].FaultPlan.from_doc(
        [{"point": "driver.dispatch", "kind": "latency", "latency_s": 0,
          "times": -1}]))
    out = solve(package, batch)
    assert FAULTS[package].current_plan().rules[0].hits == 0
    return out


def _half_open_recovers(package, batch):
    clock = Clock()
    br = breaker(package, failure_threshold=1, reset_after_s=10,
                 clock=clock)
    plan(package, '[{"point": "driver.dispatch", "times": 1}]')
    first = keys(solve(package, batch))  # trips open: host
    assert br.state() == "open"
    clock.t += 11
    return first, solve(package, batch)


def _poison_split(package, batch, monkeypatch):
    monkeypatch.setenv(f"{PREFIX[package]}FAULT_RETRIES", "1")
    breaker(package, failure_threshold=100, reset_after_s=60)
    plan(package, '[{"point": "driver.dispatch", "times": 1}]')
    out = solve(package, batch)
    assert [e["problems"] for e in faults_seen(package, "group_split")] \
        == [len(batch[package])]
    return out


def _expired_scope(package, batch):
    with FAULTS[package].deadline_scope(0.0):
        return solve(package, batch)


def _env_deadline(package, batch, monkeypatch):
    monkeypatch.setenv(f"{PREFIX[package]}BATCH_DEADLINE_S", "0.000001")
    return solve(package, batch)


def _chunk_overrun(package, batch, monkeypatch):
    monkeypatch.setenv(f"{PREFIX[package]}CHUNK_DEADLINE_S", "0.001")
    br = breaker(package, failure_threshold=1, reset_after_s=60)
    plan(package, '[{"point": "driver.dispatch", "kind": "latency", '
                  '"latency_s": 0.05, "times": 1}]')
    out = solve(package, batch)
    assert br.state() == "open"
    return out


def _budget_exhaustion(package, batch):
    breaker(package, failure_threshold=1, reset_after_s=60)
    plan(package, '[{"point": "driver.dispatch", "times": -1}]')
    out = solve(package, batch, max_steps=1)
    assert all(int(r.outcome) == 0 for r in out)
    return out


SCENARIOS = {
    "transient-dispatch": _transient("driver.dispatch"),
    "transient-device-put": _transient("driver.device_put"),
    "every-first-attempt": _every_first_attempt,
    "persistent-to-host": _persistent,
    "open-breaker-short-circuits": _open_short_circuits,
    "half-open-recovers": _half_open_recovers,
    "poison-split": _poison_split,
    "expired-deadline": _expired_scope,
    "env-batch-deadline": _env_deadline,
    "chunk-deadline-overrun": _chunk_overrun,
    "budget-exhaustion-on-host": _budget_exhaustion,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_driver_recovery(name, batch, clean, monkeypatch, tmp_path):
    """Each recovery path of the reference's chaos suite, scripted by the
    same plan on both packages: every lane's outcome, installed set, core
    and steps, the retry, failure, host-routed and deadline counters,
    the transitions and the breaker's state sequence agree."""
    fn = SCENARIOS[name]
    extra = {"every-first-attempt": (tmp_path,),
             "poison-split": (monkeypatch,),
             "env-batch-deadline": (monkeypatch,),
             "chunk-deadline-overrun": (monkeypatch,)}.get(name, ())

    def run(package):
        out = fn(package, batch, *extra)
        if isinstance(out, tuple):
            return out[0], keys(out[1]), observed(package)
        return keys(out), observed(package)

    got = both(run)
    assert got["port"] == got["reference"]
    results, obs = got["port"][-2], got["port"][-1]
    n = len(batch["port"])
    if name in ("expired-deadline", "env-batch-deadline"):
        assert all(k[0] == 0 and k[3] == 0 for k in results)
        assert obs["deppy_deadline_exceeded"] >= 1
    elif name != "budget-exhaustion-on-host":
        # The answers are the clean solve's; host-routed lanes report
        # the host engine's steps.
        assert [k[:3] for k in results] == [k[:3] for k in clean["port"]]
    if name in ("transient-dispatch", "transient-device-put"):
        assert results == clean["port"]
        assert (obs["deppy_fault_retries"], obs["deppy_fault_failures_total"],
                obs["deppy_fault_host_routed_total"]) == (1, 1, 0)
        assert obs["breaker"] == []
    if name == "persistent-to-host":
        assert obs["deppy_fault_host_routed_total"] == n
        assert obs["breaker"] == ["open"]
    if name == "open-breaker-short-circuits":
        assert obs["deppy_fault_host_routed_total"] == n
        assert obs["deppy_fault_failures_total"] == 0
    if name == "half-open-recovers":
        assert results == clean["port"]
        assert obs["breaker"] == ["open", "half_open", "closed"]
    if name == "poison-split":
        assert results == clean["port"]
        assert obs["deppy_fault_host_routed_total"] == 0


def test_host_fallback_preserves_unsat_cores():
    """The fallback carries exact conflict sets, and an UNSAT that fits
    the budget once stays UNSAT (no second charge for its core)."""
    jvars = [[jsat.variable("a", jsat.mandatory(), jsat.prohibited())],
             [jsat.variable("b", jsat.mandatory())]]
    exact = [jsat.variable("a", jsat.mandatory(), jsat.prohibited()),
             jsat.variable("b", jsat.mandatory())]
    probs = {"reference": [jencode(vs) for vs in jvars],
             "port": [tencode(variables_from_objects(vs)) for vs in jvars]}
    one = {"reference": [jencode(exact)],
           "port": [tencode(variables_from_objects(exact))]}
    from deppy_tpu_torch.sat.host import HostEngine

    probe = HostEngine(one["port"][0])
    with pytest.raises(Exception):
        probe.solve()

    def run(package):
        clean = keys(solve(package, probs))
        breaker(package, failure_threshold=1, reset_after_s=60)
        plan(package, '[{"point": "driver.dispatch", "times": -1}]')
        routed = keys(solve(package, probs))
        exact_budget = keys(solve(package, one, max_steps=probe.steps))
        return clean, routed, exact_budget, observed(package)

    got = both(run)
    assert got["port"] == got["reference"]
    clean, routed, (exact_budget,), _ = got["port"]
    assert [k[:3] for k in routed] == [k[:3] for k in clean]
    assert exact_budget[0] == -1 and exact_budget[2]


def test_env_deadline_bounds_host_backend(monkeypatch):
    """``BATCH_DEADLINE_S`` bounds the facade's host batch too, counting
    ONE deadline event for the whole remainder."""
    problems = [[jsat.variable(f"v{i}", jsat.mandatory())]
                for i in range(5)]

    def run(package):
        monkeypatch.setenv(f"{PREFIX[package]}BATCH_DEADLINE_S", "0.000001")
        if package == "port":
            out = TBatchResolver(backend="host").solve(
                [variables_from_objects(vs) for vs in problems])
            render = tio.result_to_dict
        else:
            out = JBatchResolver(backend="host").solve(problems)
            render = jio.result_to_dict
        return [render(r) for r in out], observed(package)

    got = both(run)
    assert got["port"] == got["reference"]
    assert got["port"][1]["deppy_deadline_exceeded"] == 1
    assert {r["status"] for r in got["port"][0]} == {"incomplete"}


def test_facade_deadline_on_the_device_path(batch):
    """``BatchResolver(deadline_s=)`` without a scheduler: an expired
    deadline degrades every problem, a generous one answers."""
    jvars = [random_instance(length=10, seed=s) for s in range(8)]

    def run(package):
        if package == "port":
            tvars = [variables_from_objects(vs) for vs in jvars]
            expired = TBatchResolver(device="cpu", deadline_s=0.0).solve(
                tvars)
            live = TBatchResolver(device="cpu", deadline_s=600.0).solve(
                tvars)
            render = tio.result_to_dict
        else:
            expired = JBatchResolver(backend="tpu", deadline_s=0.0).solve(
                jvars)
            live = JBatchResolver(backend="tpu", deadline_s=600.0).solve(
                jvars)
            render = jio.result_to_dict
        return ([render(r) for r in expired], [render(r) for r in live],
                observed(package))

    got = both(run)
    assert got["port"] == got["reference"]
    assert {r["status"] for r in got["port"][0]} == {"incomplete"}
    assert "incomplete" not in {r["status"] for r in got["port"][1]}


@pytest.mark.parametrize("error", [
    KernelBuildError("nvcc failed on search.cu"),
    KernelLaunchError("search launch refused: CUDA error 701"),
    tdriver.NoDeviceError("device='cuda' was requested"),
    ValueError("shape the wrapper refuses"),
    TypeError("dtype the wrapper refuses")],
    ids=["build", "launch", "no-device", "value", "type"])
def test_defects_of_the_tree_pass_through(error, batch, monkeypatch):
    """The port's one deliberate difference: a kernel that does not
    build, a launch it cannot take, a card that is not there and a
    wrapper's contract error leave the envelope untouched — no retry, no
    failure counted, no breaker charge, no host route — and a claimed
    half-open probe slot is handed back."""
    def broken(*args, **kwargs):
        raise error

    monkeypatch.setattr(tdriver, "_solve_split", broken)
    clock = Clock()
    br = breaker("port", failure_threshold=1, reset_after_s=10, clock=clock)
    for _ in range(2):
        with pytest.raises(type(error)):
            solve("port", batch)
    obs = observed("port")
    assert (obs["deppy_fault_retries"], obs["deppy_fault_failures_total"],
            obs["deppy_fault_host_routed_total"]) == (0, 0, 0)
    assert br.state() == "closed"
    br.record_failure()
    clock.t += 11
    with pytest.raises(type(error)):
        solve("port", batch)
    assert br.allow()  # the probe slot came back


def test_kernel_build_error_is_a_runtime_error(monkeypatch, tmp_path):
    """The build raises ``KernelBuildError`` (a ``RuntimeError``, so
    callers that catch that still do) for a missing ``nvcc`` and for a
    library that does not load."""
    from deppy_tpu_torch.engine import _build

    assert issubclass(KernelBuildError, RuntimeError)
    assert issubclass(KernelLaunchError, RuntimeError)
    assert issubclass(tdriver.NoDeviceError, RuntimeError)
    assert set(tdriver.TREE_DEFECTS) == {
        KernelBuildError, KernelLaunchError, tdriver.NoDeviceError,
        ValueError, TypeError}
    with monkeypatch.context() as m:
        m.setattr(_build.shutil, "which", lambda name: None)
        m.setattr(_build.os.path, "exists", lambda path: False)
        with pytest.raises(KernelBuildError, match="nvcc not found"):
            _build._nvcc()
    junk = tmp_path / "h" / _build.LIB_NAME
    junk.parent.mkdir()
    junk.write_bytes(b"not a shared library")
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "library_path", lambda: junk)
    with pytest.raises(KernelBuildError, match="does not load"):
        _build.load()
    assert _build._LIB is None


# CUDA error codes: a launch the kernel cannot take (invalid value,
# invalid configuration, invalid device function, invalid kernel image,
# no kernel image for the device, invalid PTX, unsupported PTX version,
# out of resources, a cooperative grid too large, no cooperative
# launches), then faults of the card (allocation, illegal address,
# launch timeout, launch failure).
LAUNCH_DEFECT_CODES = (1, 9, 98, 200, 209, 218, 222, 701, 720, 801)
CARD_FAULT_CODES = (2, 700, 702, 719)


@pytest.mark.parametrize("rc", LAUNCH_DEFECT_CODES + CARD_FAULT_CODES)
def test_launch_error_codes(rc, batch, clean, monkeypatch):
    """``_build.check`` sorts a launch function's CUDA error code: a
    launch the kernel cannot take raises ``KernelLaunchError``, which
    passes through the envelope un-routed and charges nothing; any other
    code is a fault of the card, which the envelope retries (here once,
    then the launch succeeds) with the answers and steps of a clean
    solve."""
    from deppy_tpu_torch.engine import _build

    assert _build.LAUNCH_DEFECT_CODES == frozenset(LAUNCH_DEFECT_CODES)
    _build.check(0, "search")
    real = tdriver._solve_split
    calls = []

    def launch_fails_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            _build.check(rc, "search (bits)")
        return real(*args, **kwargs)

    monkeypatch.setattr(tdriver, "_solve_split", launch_fails_once)
    br = breaker("port", failure_threshold=3, reset_after_s=10,
                 clock=Clock())
    defect = rc in LAUNCH_DEFECT_CODES
    if defect:
        with pytest.raises(KernelLaunchError, match=f"CUDA error {rc},"):
            solve("port", batch)
    else:
        assert keys(solve("port", batch)) == clean["reference"]
    obs = observed("port")
    assert (obs["deppy_fault_retries"], obs["deppy_fault_failures_total"],
            obs["deppy_fault_host_routed_total"]) == (
                (0, 0, 0) if defect else (1, 1, 0))
    assert br.state() == "closed" and obs["breaker"] == []
    # One call that raised; after a retry, one call for each bucket.
    assert len(calls) == (1 if defect else 1 + len(
        tdriver.partition_buckets(batch["port"])))
    if not defect:
        with pytest.raises(RuntimeError) as info:
            _build.check(rc, "search (bits)")
        assert type(info.value) is RuntimeError
        assert f"launch failed: CUDA error {rc}" in str(info.value)


# ------------------------------------------------------------ escalation


@pytest.fixture(scope="module")
def esc_batch(batch):
    """The shared batch: its step distribution has a tail (one UNSAT
    lane well past the others), so a stage-1 budget strands one lane."""
    return batch


def _escalated(package, esc_batch, monkeypatch, stage1):
    """One solve with the ladder at ``stage1``, on a fresh registry:
    (keys, observed)."""
    reg = TELEMETRY[package].Registry()
    reg.events_seen = []
    monkeypatch.setattr(DRIVER[package], "STAGE1_MIN_BATCH", 8)
    monkeypatch.setattr(DRIVER[package], "STAGE1_STEPS", stage1)
    prev = TELEMETRY[package].set_default_registry(reg)
    try:
        return keys(solve(package, esc_batch)), observed(package)
    finally:
        TELEMETRY[package].set_default_registry(prev)


@pytest.mark.parametrize("stage1,stage", [(None, 2), (1, 2)],
                         ids=["compacted-redo", "misized-stage1"])
def test_escalation_parity(stage1, stage, esc_batch, monkeypatch):
    """Escalation is invisible: answers AND steps equal the single-stage
    solve, on the compacted redo (few stragglers) and on the full rerun
    (stage 1 of one step strands every lane), and the port reaches the
    reference's stages.  The ladder's batch floor is cut to 8 on both
    sides to keep the batch small."""
    base = both(lambda package: keys(solve(package, esc_batch)))
    assert base["port"] == base["reference"]
    steps = sorted(k[3] for k in base["port"])
    if stage1 is None:
        # The largest budget that strands some lanes, at most a quarter.
        stage1 = max(c for c in steps
                     if 0 < sum(s > c for s in steps) <= len(steps) // 4)
    got = both(lambda package: _escalated(package, esc_batch, monkeypatch,
                                          stage1))
    assert got["port"] == got["reference"]
    assert got["port"][0] == base["port"]
    assert got["port"][1]["deppy_escalation_total"] == {str(stage): 1}
    stragglers = sum(s > stage1 for s in steps)
    full = stragglers > tdriver.STAGE1_MAX_STRAGGLERS * len(steps)
    assert full == (stage1 == 1)


def test_steps_identical_to_single_stage(esc_batch, monkeypatch):
    base = keys(solve("port", esc_batch))
    stage1 = sorted(k[3] for k in base)[len(base) // 2]
    esc, obs = _escalated("port", esc_batch, monkeypatch, stage1)
    assert [k[3] for k in esc] == [k[3] for k in base]
    assert esc == base
    assert obs["deppy_escalation_total"] == {"2": 1}


def test_tracing_disables_escalation(esc_batch, monkeypatch):
    """With a trace buffer the ladder stays off: one call at the full
    budget, as in the reference."""
    def spied(package):
        calls = []
        real = DRIVER[package]._solve_split

        if package == "port":
            def spy(problems, budget, dev, monolith, trace_cap=0):
                calls.append((len(problems), int(budget)))
                return real(problems, budget, dev, monolith,
                            trace_cap=trace_cap)
        else:
            def spy(problems, budget, mesh, trace_cap):
                calls.append((len(problems), int(budget)))
                return real(problems, budget, mesh, trace_cap)

        monkeypatch.setattr(DRIVER[package], "STAGE1_STEPS", 8)
        monkeypatch.setattr(DRIVER[package], "STAGE1_MIN_BATCH", 8)
        monkeypatch.setattr(DRIVER[package], "_solve_split", spy)
        solve(package, esc_batch, trace_cap=4)
        return calls, observed(package)["deppy_escalation_total"]

    got = both(spied)
    assert got["port"] == got["reference"]
    (calls, stages) = got["port"]
    assert len(calls) == 1 and calls[0][1] > 8 and stages == {"0": 1}


# ----------------------------------------------------------- checkpoints


def ckpt(package, problems, path, **kw):
    if package == "port":
        kw.setdefault("device", "cpu")
    return CHECKPOINT[package].solve_problems_checkpointed(
        problems[package], str(path), **kw)


def test_checkpoint_fingerprint_equals_reference():
    for seed0 in (0, 100):
        problems = make_problems(n=6, seed0=seed0)
        assert tcheckpoint.batch_fingerprint(problems["port"]) == \
            jcheckpoint.batch_fingerprint(problems["reference"])


def test_checkpoint_roundtrip_matches_plain_solve(batch, clean, tmp_path):
    out = ckpt("port", batch, tmp_path, group=4)
    assert answers(out) == [k[:3] for k in clean["reference"]]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "batch.json", "group_00000.npz", "group_00001.npz"]
    again = ckpt("port", batch, tmp_path, group=4)
    assert keys(again) == keys(out)
    assert all(isinstance(r.outcome, int) and isinstance(r.steps, int)
               and r.installed.dtype == torch.bool for r in again)


def test_resume_skips_completed_groups(batch, clean, tmp_path, monkeypatch):
    ckpt("port", batch, tmp_path, group=4)
    calls = []
    real = tdriver.solve_problems

    def spy(chunk, **kw):
        calls.append(len(chunk))
        return real(chunk, **kw)

    monkeypatch.setattr(tdriver, "solve_problems", spy)
    out = ckpt("port", batch, tmp_path, group=4)
    assert calls == []
    assert answers(out) == [k[:3] for k in clean["reference"]]


def test_partial_resume_recomputes_missing_group(batch, clean, tmp_path):
    ckpt("port", batch, tmp_path, group=4)
    (tmp_path / "group_00001.npz").unlink()
    out = ckpt("port", batch, tmp_path, group=4)
    assert answers(out) == [k[:3] for k in clean["reference"]]
    assert (tmp_path / "group_00001.npz").exists()


def test_changed_batch_invalidates_stale_groups(batch, clean, tmp_path):
    ckpt("port", batch, tmp_path, group=4)
    other = {package: problems[::-1] for package, problems in batch.items()}
    assert tcheckpoint.batch_fingerprint(other["port"]) != \
        tcheckpoint.batch_fingerprint(batch["port"])
    out = ckpt("port", other, tmp_path, group=4)
    assert answers(out) == [k[:3] for k in clean["reference"][::-1]]


def test_changed_max_steps_invalidates(batch, tmp_path):
    tiny = ckpt("port", batch, tmp_path, group=4, max_steps=1)
    assert all(int(r.outcome) == 0 for r in tiny)
    full = ckpt("port", batch, tmp_path, group=4)
    assert answers(full) == answers(solve("reference", batch))


def test_torn_group_file_recomputed(batch, clean, tmp_path):
    ckpt("port", batch, tmp_path, group=4)
    (tmp_path / "group_00000.npz").write_bytes(b"not an npz")
    out = ckpt("port", batch, tmp_path, group=4)
    assert answers(out) == [k[:3] for k in clean["reference"]]


def test_crash_between_groups_resumes(batch, clean, tmp_path):
    """A scripted crash at ``checkpoint.save_group`` after group 0 was
    written: both packages raise there and leave the same files; the
    rerun resumes and answers as the clean solve."""
    def run(package):
        path = tmp_path / package
        plan(package, '[{"point": "checkpoint.save_group", "after": 1, '
                      '"times": -1}]')
        with pytest.raises(FAULTS[package].InjectedFault):
            ckpt(package, batch, path, group=4)
        files = sorted(p.name for p in path.iterdir())
        FAULTS[package].configure_plan(None)
        return files, answers(ckpt(package, batch, path, group=4))

    got = both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == ["batch.json", "group_00000.npz"]
    assert got["port"][1] == [k[:3] for k in clean["reference"]]


def test_device_faults_during_checkpointed_run_recovered(batch, clean,
                                                         tmp_path):
    def run(package):
        path = tmp_path / package
        plan(package, '[{"point": "driver.dispatch", "period": 2, '
                      '"times": 1}]')
        out = answers(ckpt(package, batch, path, group=4))
        FAULTS[package].configure_plan(None)
        return out, answers(ckpt(package, batch, path, group=4)), \
            observed(package)

    got = both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == got["port"][1] == \
        [k[:3] for k in clean["reference"]]


def test_host_fallback_groups_round_trip_npz(batch, clean, tmp_path):
    def run(package):
        path = tmp_path / package
        breaker(package, failure_threshold=1,
                reset_after_s=600).record_failure()
        out = keys(ckpt(package, batch, path, group=4))
        return out, keys(ckpt(package, batch, path, group=4)), \
            observed(package)

    got = both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == got["port"][1]
    assert [k[:3] for k in got["port"][0]] == \
        [k[:3] for k in clean["reference"]]


def test_batch_resolver_checkpoint_wiring(tmp_path):
    jvars = [random_instance(length=10, seed=s) for s in range(8)]
    tvars = [variables_from_objects(vs) for vs in jvars]
    plain = TBatchResolver(device="cpu").solve(tvars)
    ck = TBatchResolver(device="cpu", checkpoint_dir=str(tmp_path)).solve(
        tvars)
    again = TBatchResolver(device="cpu",
                           checkpoint_dir=str(tmp_path)).solve(tvars)
    ref = JBatchResolver(backend="tpu").solve(jvars)
    want = [jio.result_to_dict(r) for r in ref]
    for out in (plain, ck, again):
        assert [tio.result_to_dict(r) for r in out] == want
    # The checkpoint's mesh= places each group's lanes over the mesh's
    # slots (checkpoint.py:170-171): the same results, resumed too.
    from deppy_tpu_torch.parallel import default_mesh

    mesh = default_mesh([torch.device("cpu")] * 2)
    problems = [tencode(vs) for vs in tvars]
    base = tdriver.solve_problems(problems, device="cpu")
    for _ in range(2):
        got = tcheckpoint.solve_problems_checkpointed(
            problems, str(tmp_path / "mesh"), group=4, mesh=mesh)
        assert [(r.outcome, r.steps) for r in got] == \
            [(r.outcome, r.steps) for r in base]


def test_host_backend_checkpoint_dir_warns(tmp_path, capsys):
    out = TBatchResolver(backend="host", checkpoint_dir=str(tmp_path)).solve(
        [variables_from_objects([jsat.variable("a", jsat.mandatory())])])
    assert out == [{"a": True}]
    assert "checkpoint_dir is a device-backend feature" in \
        capsys.readouterr().err


# ------------------------------------------------------------------ auto


@pytest.fixture()
def verdicts(monkeypatch):
    """Fresh probe caches on both packages (restored afterwards)."""
    monkeypatch.setattr(jsolver, "_ENGINE_USABLE", None)
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {})


def test_open_breaker_degrades_auto_to_host(verdicts, monkeypatch):
    monkeypatch.setattr(jsolver, "_ENGINE_USABLE", True)
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {"cuda": True})

    def run(package):
        s, dev = SOLVER[package], DEVICE[package]
        out = [s.resolve_backend("auto"), s.resolve_backend("auto",
                                                            batch=False)]
        breaker(package, failure_threshold=1,
                reset_after_s=60).record_failure()
        out += [s.resolve_backend("auto"), s.resolve_backend(dev),
                s.resolve_backend("host")]
        return [{"tpu": "device"}.get(b, b) for b in out]

    got = both(run)
    assert got["port"] == got["reference"] == [
        "device", "host", "host", "device", "host"]


def test_successful_reprobe_closes_breaker(verdicts, monkeypatch):
    monkeypatch.setattr(jsolver, "_probe_verdict", lambda: True)
    monkeypatch.setattr(tsolver, "_probe_verdict", lambda kind: True)

    def run(package):
        br = breaker(package, failure_threshold=1, reset_after_s=60)
        br.record_failure()
        before = br.state()
        ok = SOLVER[package].reprobe_engine()
        return before, ok, br.state(), observed(package)["breaker"]

    got = both(run)
    assert got["port"] == got["reference"] == (
        "open", True, "closed", ["open", "closed"])
    assert tsolver._ENGINE_USABLE == {"cuda": True}


def test_block_false_without_a_verdict(verdicts):
    """The dispatch loop's non-blocking resolution: host on the card
    until a verdict lands, the device at once on the CPU."""
    assert tsolver.resolve_backend("auto", block=False) == "host"
    assert tsolver._ENGINE_USABLE == {}
    assert tsolver.resolve_backend("auto", block=False,
                                   device="cpu") == "device"
    assert tsolver._ENGINE_USABLE == {"cpu": True}
    with pytest.raises(tsolver.InternalSolverError):
        tsolver.resolve_backend("tpu")


def test_real_probe_on_a_box_without_a_card(verdicts):
    """One real subprocess probe on ``cuda``: this box has no card, so the
    verdict is False, cached, and ``auto`` resolves to the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a card; the probe's True verdict is the "
                    "chip run's to show")
    assert tsolver._probe_verdict("cuda") is False
    assert tsolver.resolve_backend("auto", device="cuda") == "host"
    assert tsolver._ENGINE_USABLE == {"cuda": False}


def test_single_problem_auto_solves_on_the_host():
    problem = [jsat.variable("a", jsat.mandatory(),
                             jsat.dependency("b")), jsat.variable("b")]
    t = tsolver.Solver(variables_from_objects(problem), backend="auto",
                       device="cpu")
    j = jsolver.Solver(problem, backend="auto")
    assert [v.identifier for v in t.solve()] == \
        [v.identifier for v in j.solve()] == ["a", "b"]
    assert t.report.backend == "host"


# ------------------------------------------------------------- scheduler


def _sched(package, backend="device", **kw):
    """A scheduler of ``package``: ``backend`` in the port's names, the
    reference's unported tiers off unless ``kw`` sets them."""
    if package == "port":
        return TScheduler(backend=backend, device="cpu",
                          registry=ttelemetry.Registry(), **kw)
    return JScheduler(backend={"device": "tpu"}.get(backend, backend),
                      registry=jtelemetry.Registry(), **{**REF_OFF, **kw})


def _submit(package, sched, jvars, stats=None):
    reqs = (jvars if package == "reference"
            else [variables_from_objects(vs) for vs in jvars])
    io = jio if package == "reference" else tio
    return [io.result_to_dict(r) for r in sched.submit(reqs, stats=stats)]


def _label(rep):
    return {"tpu": "device"}.get(rep.backend, rep.backend)


def test_auto_flushes(batch):
    jvars = [random_instance(length=10, seed=s) for s in range(8)]

    def run(package):
        sched = _sched(package, backend="auto", incremental="off")
        st: dict = {}
        out = _submit(package, sched, jvars, st)
        return out, _label(st["report"])

    got = both(run)
    assert got["port"] == got["reference"]
    assert got["port"][1] == "device"


def test_breaker_open_drain_and_reprobe(monkeypatch):
    """Under ``auto`` with the breaker open, a flush drains on the host
    and kicks the deferred re-probe; once the cooldown lapses the probe
    upgrades routing (one ``upgraded``), resets the breaker, and the next
    flush runs on the device path."""
    jvars = [random_instance(length=10, seed=s) for s in range(4)]
    monkeypatch.setattr(jsolver, "_probe_verdict", lambda: True)
    monkeypatch.setattr(tsolver, "_probe_verdict", lambda kind: True)

    def run(package):
        monkeypatch.setenv(f"{PREFIX[package]}REPROBE", "1")
        breaker(package, failure_threshold=1,
                reset_after_s=0.05).record_failure()
        sched = _sched(package, backend="auto", incremental="off",
                       cache_size=0)
        st1: dict = {}
        first = _submit(package, sched, jvars, st1)
        t = sched._reprobe_thread
        assert t is not None
        t.join(10)
        assert not t.is_alive()
        st2: dict = {}
        second = _submit(package, sched, jvars, st2)
        sched.stop()
        snap = sched._registry.snapshot()
        upgraded = faults_seen(package, "sched_reprobe_upgraded")
        return (first == second, _label(st1["report"]),
                _label(st2["report"]), snap["deppy_sched_reprobes_total"],
                len(upgraded), FAULTS[package].default_breaker().state())

    got = both(run)
    assert got["port"] == got["reference"] == (
        True, "host", "device", {"upgraded": 1}, 1, "closed")


def test_racer_offers_no_device_under_an_open_breaker():
    jvars = [random_instance(length=10, seed=s) for s in range(2)]

    def run(package):
        breaker(package, failure_threshold=1,
                reset_after_s=600).record_failure()
        sched = _sched(package, incremental="off", portfolio="on",
                       portfolio_k=3, portfolio_sample_check=0.0,
                       cache_size=0)
        out = _submit(package, sched, jvars)
        snap = sched._registry.snapshot()
        return out, sorted(snap.get("deppy_race_starts_total", {}))

    got = both(run)
    assert got["port"] == got["reference"]
    assert "device" not in got["port"][1] and got["port"][1]


def _bundles(tweak=None, n_bundles=4, bsize=6):
    vs = []
    for b in range(n_bundles):
        for j in range(bsize):
            cons = [jsat.mandatory()] if j == 0 else []
            if j < bsize - 2:
                cons.append(jsat.dependency(f"b{b}v{j + 1}", f"b{b}v{j + 2}"))
            if tweak == b and j == 2:
                cons.append(jsat.dependency(f"b{b}v{bsize - 1}",
                                            f"b{b}v{bsize - 2}"))
            vs.append(jsat.variable(f"b{b}v{j}", *cons))
    return vs


@pytest.mark.parametrize("state", ["closed", "open"])
def test_warm_screen_skipped_under_an_open_breaker(state, monkeypatch):
    """A warm flush of two lanes screens on the device path while the
    breaker is closed and skips the screen while it is open; the answers
    are the same either way, and equal the reference's."""
    def run(package):
        calls = []
        real = DRIVER[package].warm_screen

        def spy(*args, **kwargs):
            calls.append(len(args[0]))
            return real(*args, **kwargs)

        monkeypatch.setattr(DRIVER[package], "warm_screen", spy)
        sched = _sched(package, cache_size=0)
        _submit(package, sched, [_bundles()])
        if state == "open":
            breaker(package, failure_threshold=1,
                    reset_after_s=600).record_failure()
        out = _submit(package, sched, [_bundles(0), _bundles(1)])
        snap = sched._registry.snapshot()
        return out, calls, snap.get("deppy_incremental_hits_total", 0)

    got = both(run)
    assert got["port"] == got["reference"]
    out, calls, hits = got["port"]
    assert calls == ([] if state == "open" else [2])
    assert hits == 2
    assert {r["status"] for r in out} == {"sat"}


def test_warm_screen_error_degrades_with_its_event(monkeypatch):
    def run(package):
        def boom(*args, **kwargs):
            raise RuntimeError("screen launch failed")

        monkeypatch.setattr(DRIVER[package], "warm_screen", boom)
        sched = _sched(package, cache_size=0)
        _submit(package, sched, [_bundles()])
        out = _submit(package, sched, [_bundles(0), _bundles(1)])
        return out, [(e["error"], e["lanes"]) for e in faults_seen(
            package, "incremental_screen_failed")]

    got = both(run)
    assert got["port"] == got["reference"]
    assert got["port"][1] == [("RuntimeError", 2)]


def test_prewarm_and_stop(monkeypatch):
    """``start()`` under ``auto`` on the card kicks one background probe
    (none on the CPU, whose verdict is instant); ``stop()`` sets the
    re-probe loop's stop event."""
    probes = []
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {})
    monkeypatch.setattr(tsolver, "_probe_verdict",
                        lambda kind: probes.append(kind) or False)
    for device, want in (("cpu", []), ("cuda", ["cuda"])):
        sched = TScheduler(backend="auto", device=device,
                           registry=ttelemetry.Registry())
        sched.start()
        deadline = time.monotonic() + 10
        while len(probes) < len(want) and time.monotonic() < deadline:
            time.sleep(0.01)
        sched.stop()
        assert sched._reprobe_stop.is_set()
        assert probes == want
        probes.clear()
        monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {})
