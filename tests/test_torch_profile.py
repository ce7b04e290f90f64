"""The port's trip profiler and SLO accounting against the JAX package's.

The reference's ``tests/test_profile.py`` shapes, on the CPU: the port's
driver and scheduler run on ``device="cpu"`` (the kernels' plain
versions) or ``backend="host"``, the reference's ``solve_problems`` on
CPU XLA (two shapes), its scheduler on ``backend="host"``.  Every
comparison is exact:

  * the ledger: armed dispatches fill the report, the sink and the
    ``deppy_profile_*`` families; disarmed is inert; sampling is 1-in-N
    per site; host-engine core steps stay out; the knobs;
  * the merge rules of the ledger fields;
  * the ``profile`` events of one batch and of one problem (SAT, UNSAT,
    one host-routed core) equal the reference's in every field but
    ``solve_s``, and ``summarize`` of one sink equals the reference's;
  * the ``host``, ``warm`` and ``hostpool`` sites, tenant-stamped where
    the flush serves one tenant;
  * the SLO accountant.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import profile as jprofile
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import pinned_tenant_catalog as jpinned
from deppy_tpu.models import random_instance as jrandom
from deppy_tpu.profile import report as jreport
from deppy_tpu.sat import constraints as jsat
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch import faults, profile, sat, telemetry
from deppy_tpu_torch.engine import driver
from deppy_tpu_torch.models import pinned_tenant_catalog, random_instance
from deppy_tpu_torch.profile import report
from deppy_tpu_torch.sat.encode import encode
from deppy_tpu_torch.sched import Scheduler


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each package's breaker, fault plan and default registry per test,
    both profilers disarmed and re-resolved from the environment; the
    reference's escalation off."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    monkeypatch.delenv("DEPPY_GPU_PROFILE", raising=False)
    monkeypatch.delenv("DEPPY_GPU_PROFILE_SAMPLE", raising=False)
    monkeypatch.delenv("DEPPY_GPU_SLO", raising=False)
    prev_breakers = (jfaults.set_default_breaker(jfaults.CircuitBreaker()),
                     faults.set_default_breaker(faults.CircuitBreaker()))
    prev_plans = (jfaults.configure_plan(None), faults.configure_plan(None))
    prev = (jtelemetry.set_default_registry(jtelemetry.Registry()),
            telemetry.set_default_registry(telemetry.Registry()))
    jprofile.configure(mode=None, sample=None)
    profile.configure(mode=None, sample=None)
    yield
    telemetry.set_default_registry(prev[1])
    jtelemetry.set_default_registry(prev[0])
    faults.configure_plan(prev_plans[1])
    jfaults.configure_plan(prev_plans[0])
    faults.set_default_breaker(prev_breakers[1])
    jfaults.set_default_breaker(prev_breakers[0])
    profile.configure(mode=None, sample=None)
    jprofile.configure(mode=None, sample=None)


def _fuzz(n, length=24):
    return [encode(random_instance(length=length, seed=s))
            for s in range(n)]


def _sink_events(path):
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            if line.strip():
                out.append(json.loads(line))
    return out


def _profile_events(reg):
    """A forwarder list of the registry's ``profile`` events."""
    evs = []
    reg.add_forwarder(lambda e: evs.append(e)
                      if e.get("kind") == "profile" else None)
    return evs


def bundle_catalog(n_bundles=4, bsize=6, tweak=None):
    """The churn workload shape (``tests/test_profile.py:65-84``):
    dependency bundles where ``tweak=(kind, bundle)`` mutates exactly
    one."""
    vs = []
    for b in range(n_bundles):
        for j in range(bsize):
            cons = []
            if j == 0:
                cons.append(sat.mandatory())
            if j < bsize - 2:
                cons.append(sat.dependency(f"b{b}v{j + 1}",
                                           f"b{b}v{j + 2}"))
            if tweak is not None and tweak[1] == b and tweak[0] == "add-dep" \
                    and j == 2:
                cons.append(sat.dependency(f"b{b}v{bsize - 1}",
                                           f"b{b}v{bsize - 2}"))
            vs.append(sat.variable(f"b{b}v{j}", *cons))
    return vs


# --------------------------------------------------------------- trip ledger


class TestLedger:
    def test_armed_dispatch_fills_report_and_sink(self, tmp_path):
        sink = tmp_path / "t.jsonl"
        telemetry.default_registry().configure_sink(str(sink))
        with profile.override("on", 1.0):
            driver.solve_problems(_fuzz(12), device="cpu")
        telemetry.default_registry().configure_sink(None)
        rep = telemetry.last_report()
        assert rep.profiled_dispatches == 1
        assert rep.ledger_trips > 0
        assert rep.ledger_trip_slots >= rep.ledger_trips
        assert rep.ledger_lane_steps > 0
        assert 0.0 < rep.useful_work_ratio <= 1.0
        assert 0.0 < rep.straggler_p99_ratio <= 1.0
        profs = [e for e in _sink_events(sink) if e["kind"] == "profile"]
        assert len(profs) == 1
        ev = profs[0]
        assert ev["backend"] == "device"
        assert ev["trips"] == rep.ledger_trips
        assert ev["lane_steps"] == rep.ledger_lane_steps
        assert ev["live"] == 12
        assert ev["lane_p50"] <= ev["lane_p99"] <= ev["trips"]
        assert 0.0 <= ev["pad_waste_ratio"] <= 1.0
        assert ev["solve_s"] > 0
        snap = telemetry.default_registry().snapshot()
        assert snap["deppy_profile_dispatches_total"] == 1
        assert snap["deppy_profile_trips_total"] == rep.ledger_trips
        assert snap["deppy_profile_backend_lanes_total"]["device"] == 12

    def test_disarmed_is_inert(self, tmp_path):
        sink = tmp_path / "t.jsonl"
        telemetry.default_registry().configure_sink(str(sink))
        with profile.override("off"):
            driver.solve_problems(_fuzz(8), device="cpu")
        telemetry.default_registry().configure_sink(None)
        assert not [e for e in _sink_events(sink)
                    if e["kind"] == "profile"]
        rep = telemetry.last_report()
        assert rep.profiled_dispatches == 0
        assert rep.useful_work_ratio == 0.0
        snap = telemetry.default_registry().snapshot()
        assert "deppy_profile_dispatches_total" not in snap
        assert profile.render_metric_lines() == []

    def test_sampling_is_one_in_n(self):
        with profile.override("on", 0.5):
            for _ in range(4):
                driver.solve_problems(_fuzz(4, length=12), device="cpu")
        snap = telemetry.default_registry().snapshot()
        assert snap["deppy_profile_dispatches_total"] == 2

    @pytest.mark.parametrize("sample,n,want", [(0.25, 8, 2), (0.0, 3, 0)])
    def test_sampling_rates(self, sample, n, want):
        with profile.override("on", sample):
            hits = sum(profile.dispatch_t0("device") is not None
                       for _ in range(n))
            assert profile.sample_rate() == sample
        assert hits == want

    def test_sampling_counters_are_per_site(self):
        """One global modulo counter would phase-lock under periodic call
        patterns — each site keeps its own 1-in-N cadence."""
        with profile.override("on", 0.5):
            hits = {"device": 0, "warm": 0}
            for _ in range(4):
                if profile.dispatch_t0("warm") is not None:
                    hits["warm"] += 1
                if profile.dispatch_t0("device") is not None:
                    hits["device"] += 1
        assert hits == {"device": 2, "warm": 2}

    def test_host_core_steps_stay_out_of_the_ledger(self, monkeypatch):
        """A host-routed UNSAT row's ledger steps are the device-only
        snapshot, while the lane's reported steps include the host
        sweep."""
        monkeypatch.setattr(driver, "HOST_CORE_NCONS", 0)
        problem = encode([
            sat.variable("a", sat.mandatory(), sat.prohibited()),
            sat.variable("b"),
        ])
        with profile.override("on", 1.0):
            (res,) = driver.solve_problems([problem], device="cpu")
        rep = telemetry.last_report()
        assert rep.profiled_dispatches == 1
        assert rep.ledger_lane_steps < int(res.steps)

    def test_configure_mode_alone_arms_with_default_sample(self):
        profile.configure(mode="on")
        try:
            assert profile.armed()
            assert profile.sample_rate() == 1.0
            driver.solve_problems(_fuzz(4, length=12), device="cpu")
            snap = telemetry.default_registry().snapshot()
            assert snap["deppy_profile_dispatches_total"] == 1
        finally:
            profile.configure(mode=None, sample=None)

    @pytest.mark.parametrize("mode,sample,armed,rate", [
        ("on", "0.5", True, 0.5), ("yes", "", True, 1.0),
        ("off", "0.5", False, 0.5), ("on", "junk", True, 1.0)])
    def test_knobs_come_from_the_environment(self, monkeypatch, mode,
                                             sample, armed, rate):
        monkeypatch.setenv("DEPPY_GPU_PROFILE", mode)
        monkeypatch.setenv("DEPPY_GPU_PROFILE_SAMPLE", sample)
        profile.configure(mode=None, sample=None)
        assert profile.armed() is armed
        assert profile.sample_rate() == rate

    def test_profile_families_render(self):
        """The families live on the pipeline-global default registry and
        are absent until the first sampled dispatch."""
        assert profile.render_metric_lines() == []
        with profile.override("on", 1.0):
            driver.solve_problems(_fuzz(4, length=12), device="cpu")
        text = "\n".join(profile.render_metric_lines())
        for fam in ("deppy_profile_dispatches_total",
                    "deppy_profile_trips_total",
                    "deppy_profile_useful_work_ratio_bucket",
                    'deppy_profile_backend_lanes_total{backend="device"}'):
            assert fam in text, f"{fam} missing from the render"

    def test_ledger_reads_are_post_fetch_host_numpy(self):
        """The recorded trips equal a host recomputation from the
        returned results (one bucket, one chunk)."""
        problems = _fuzz(10)
        with profile.override("on", 1.0):
            results = driver.solve_problems(problems, device="cpu")
        rep = telemetry.last_report()
        steps = np.array([int(r.steps) for r in results])
        assert rep.ledger_trips == int(steps.max())
        assert rep.ledger_lane_steps == int(steps.sum())

    def test_every_chunk_and_bucket_is_a_dispatch(self, monkeypatch):
        """Two chunks of one bucket: one event, the trips summed per
        chunk; a second bucket: a second event."""
        monkeypatch.setattr(driver, "MAX_LANES", 4)
        problems = _fuzz(7)
        evs = _profile_events(telemetry.default_registry())
        with profile.override("on", 1.0):
            results = driver.solve_problems(problems, device="cpu")
        steps = np.array([int(r.steps) for r in results])
        assert len(evs) == 1 and evs[0]["chunk"] == 4
        assert evs[0]["lanes"] == 8 and evs[0]["live"] == 7
        assert evs[0]["lane_steps"] == int(steps.sum())
        assert evs[0]["trips"] >= int(steps[:4].max()) + int(steps[4:].max())

    def test_fault_host_fallback_records_the_hostpool_site(self):
        """The fault envelope's host fallback: one ``hostpool`` event a
        fallback group (the failing group is split in halves first) with
        its lanes and their steps, no device event for the failed
        attempts."""
        evs = _profile_events(telemetry.default_registry())
        faults.configure_plan(faults.plan_from_spec(
            '[{"point": "driver.dispatch", "times": -1}]'))
        problems = _fuzz(3, length=12)
        try:
            with profile.override("on", 1.0):
                results = driver.solve_problems(problems, device="cpu")
        finally:
            faults.configure_plan(None)
        assert [(e["backend"], e["lanes"], e["live"]) for e in evs] == \
            [("hostpool", 2, 2), ("hostpool", 1, 1)]
        assert sum(e["lane_steps"] for e in evs) == \
            sum(int(r.steps) for r in results)
        assert all("tenant" not in e and "trips" not in e for e in evs)
        snap = telemetry.default_registry().snapshot()
        assert snap["deppy_profile_backend_lanes_total"] == {"hostpool": 3}


# --------------------------------------------------------------- merge rules


class TestMergeRules:
    def test_ledger_fields_sum_on_merge(self):
        a = telemetry.SolveReport()
        a.record_ledger(trips=10, trip_slots=100, lane_steps=40,
                        p99_trips=8)
        a.add_wall("solve", 1.0)
        b = telemetry.SolveReport()
        b.record_ledger(trips=6, trip_slots=30, lane_steps=20,
                        p99_trips=6)
        b.record_ledger(trips=4, trip_slots=16, lane_steps=10,
                        p99_trips=4)
        b.add_wall("solve", 2.0)
        a.merge(b)
        assert a.profiled_dispatches == 3
        assert a.ledger_trips == 20
        assert a.ledger_trip_slots == 146
        assert a.ledger_lane_steps == 70
        assert a.ledger_p99_trips == 18
        assert a.useful_work_ratio == pytest.approx(70 / 146)
        assert a.straggler_p99_ratio == pytest.approx(18 / 20)
        assert a.wall["solve"] == pytest.approx(3.0)

    def test_to_from_dict_roundtrip(self):
        a = telemetry.SolveReport()
        a.record_ledger(trips=7, trip_slots=70, lane_steps=21,
                        p99_trips=6)
        d = a.to_dict()
        assert d["useful_work_ratio"] == pytest.approx(0.3)
        back = telemetry.SolveReport.from_dict(d)
        assert back.ledger_trips == 7
        assert back.straggler_p99_ratio == pytest.approx(6 / 7)

    def test_report_fields_sum_the_events(self):
        """A multi-bucket batch: the report's ledger fields equal the
        sums of its events."""
        problems = _fuzz(20, length=12) + _fuzz(20, length=60)
        evs = _profile_events(telemetry.default_registry())
        with profile.override("on", 1.0):
            driver.solve_problems(problems, device="cpu")
        rep = telemetry.last_report()
        assert len(evs) == rep.profiled_dispatches >= 2
        assert rep.ledger_trips == sum(e["trips"] for e in evs)
        assert rep.ledger_lane_steps == sum(e["lane_steps"] for e in evs)
        assert sum(e["live"] for e in evs) == len(problems)

    def test_mixed_cold_warm_submit_merges_groups(self):
        """One submit spanning a cold group (a device dispatch: ledger
        trips) and a warm group (backend attribution, no trips)."""
        reg = telemetry.default_registry()
        s = Scheduler(device="cpu", registry=telemetry.Registry(),
                      cache_size=0)
        s.start()
        try:
            with profile.override("on", 1.0):
                s.submit([bundle_catalog()])
                stats: dict = {}
                got = s.submit(
                    [bundle_catalog(tweak=("add-dep", 1)),
                     random_instance(length=24, seed=99)],
                    stats=stats)
        finally:
            s.stop()
        assert len(got) == 2 and all(r is not None for r in got)
        rep = stats["report"]
        assert rep is not None
        assert rep.profiled_dispatches >= 1
        assert rep.ledger_trips > 0
        t = stats["timings"]
        assert t.get("queue_wait_s") is not None
        assert t.get("solve_s", 0) >= 0
        backends = reg.snapshot()["deppy_profile_backend_lanes_total"]
        assert "warm" in backends and backends["warm"] >= 1
        assert "device" in backends


# -------------------------------------------------- against the reference


def _big_unsat(sat_mod, n: int = 60):
    """An UNSAT problem with more than 50 applied constraints: a
    mandatory-and-prohibited root beside ``n`` mandatory fillers."""
    return ([sat_mod.variable("a", sat_mod.mandatory(),
                              sat_mod.prohibited())]
            + [sat_mod.variable(f"f{i}", sat_mod.mandatory())
               for i in range(n)])


def _batches(sat_mod, rand, pinned):
    """The differential's two calls: a batch of SAT (random) and UNSAT
    (pinned tenant) lanes with one host-routed core, and one problem
    alone whose core is host-routed (the one-problem dispatch)."""
    batch = ([rand(length=24, seed=s) for s in range(6)]
             + [pinned(seed=s) for s in range(4)]
             + [_big_unsat(sat_mod)])
    return [batch, [_big_unsat(sat_mod, 55)]]


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "solve_s")}


class TestAgainstReference:
    def test_profile_events_equal_the_reference(self, monkeypatch,
                                                 tmp_path):
        """The same problems through both packages' ``solve_problems``,
        armed at sample 1.0: every ``profile`` event field but
        ``solve_s`` equal; ``summarize`` of the sink equal."""
        monkeypatch.setattr(driver, "HOST_CORE_NCONS", 50)
        monkeypatch.setattr(jdriver, "HOST_CORE_NCONS", 50)
        sink = tmp_path / "t.jsonl"
        telemetry.default_registry().configure_sink(str(sink))
        mine = _profile_events(telemetry.default_registry())
        theirs = _profile_events(jtelemetry.default_registry())
        reports = []
        for tb, jb in zip(_batches(sat, random_instance, pinned_tenant_catalog),
                          _batches(jsat, jrandom, jpinned)):
            with profile.override("on", 1.0):
                got = driver.solve_problems([encode(v) for v in tb],
                                            device="cpu")
                reports.append(telemetry.last_report())
            with jprofile.override("on", 1.0):
                want = jdriver.solve_problems([jencode(v) for v in jb])
                reports.append(jtelemetry.last_report())
            assert [(int(r.outcome), int(r.steps)) for r in got] == \
                [(int(r.outcome), int(r.steps)) for r in want]
        telemetry.default_registry().configure_sink(None)
        assert len(mine) == len(theirs) == 2
        assert [_strip(e) for e in mine] == [_strip(e) for e in theirs]
        # The batch has UNSAT lanes on the card's core path and one on
        # the host engine; the single problem's core is host-routed.
        assert mine[0]["live"] == 11 and mine[1]["lanes"] == 1
        for a, b in ((reports[0], reports[1]), (reports[2], reports[3])):
            assert (a.profiled_dispatches, a.ledger_trips,
                    a.ledger_trip_slots, a.ledger_lane_steps,
                    a.ledger_p99_trips) == \
                (b.profiled_dispatches, b.ledger_trips, b.ledger_trip_slots,
                 b.ledger_lane_steps, b.ledger_p99_trips)
        assert report.summarize(str(sink)) == jreport.summarize(str(sink))

    def test_summarize_equals_the_reference(self, tmp_path):
        """One sink holding device, host, hostpool and warm ``profile``
        events, ``race`` and ``optimize`` events: both packages'
        ``summarize`` give equal dicts, and ``render_text`` renders
        it."""
        from deppy_tpu_torch.optimize import Planner

        sink = tmp_path / "t.jsonl"
        reg = telemetry.default_registry()
        reg.configure_sink(str(sink))
        with profile.override("on", 1.0):
            driver.solve_problems(_fuzz(6, length=12), device="cpu")
            driver.solve_problems(_fuzz(12, length=30), device="cpu")
            s = Scheduler(backend="host", cache_size=0)
            s.start()
            try:
                s.submit([random_instance(length=16, seed=1)],
                         tenant="solo")
                doc = {"variables": [
                    {"id": f"x{i}"} for i in range(6)],
                    "query": "soft", "warm": True,
                    "soft": [{"id": f"x{i}", "installed": True}
                             for i in range(6)]}
                Planner(s).handle(doc)
                Planner(s).handle({**doc, "warm": False})
            finally:
                s.stop()
        reg.event("race", size_class_name="s", winner="device",
                  canonical="device", entrants=["device", "host"], lanes=4,
                  cancelled=["host"], losers=[
                      {"backend": "host", "wall_s": 0.5,
                       "censored": False}],
                  win_margin_s=0.25, checked="ok", wall_s=0.25)
        reg.configure_sink(None)
        got = report.summarize(str(sink))
        assert got == jreport.summarize(str(sink))
        assert got["device_dispatches"] == 2
        assert set(got["backends"]) == {"device", "host"}
        assert set(got["optimize"]) == {"warm", "cold"}
        assert got["races"]["s"]["wins"] == {"device": 1}
        text = report.render_text(got, str(sink))
        assert "size classes:" in text and "optimization probes" in text
        assert report.summarize([str(sink), str(sink)]) == \
            jreport.summarize([str(sink), str(sink)])


# ----------------------------------------------------------------- SLO tier


class TestSLO:
    def test_sanitize_tenant(self):
        assert profile.sanitize_tenant(None) == "default"
        assert profile.sanitize_tenant("  ") == "default"
        assert profile.sanitize_tenant("team-a.prod_1") == "team-a.prod_1"
        assert profile.sanitize_tenant('evil"} 1\n') == "evil1"
        assert len(profile.sanitize_tenant("x" * 200)) == 64
        from deppy_tpu_torch.profile.slo import OVERFLOW_TENANT

        assert profile.sanitize_tenant(OVERFLOW_TENANT) == "overflow"
        assert profile.sanitize_tenant("___") == "default"

    @pytest.mark.parametrize("raw", [
        None, "", "a", "team-a.prod_1", 'evil"} 1\n', "x" * 200, "_x",
        "host:8080", "[::1]:80", "  sp ace  "])
    def test_sanitizers_equal_the_reference(self, raw):
        assert profile.sanitize_tenant(raw) == jprofile.sanitize_tenant(raw)
        assert profile.sanitize_replica(raw) == \
            jprofile.sanitize_replica(raw)

    def test_config_from_spec_and_defaults(self, tmp_path):
        c = profile.SLOConfig.from_spec(
            '{"gold": {"target_p99_s": 0.2, "error_budget": 0.05}}')
        assert c.for_tenant("gold")["target_p99_s"] == 0.2
        assert c.for_tenant("other")["target_p99_s"] == 1.0
        f = tmp_path / "slo.json"
        f.write_text('{"default": {"target_p99_s": 9.0}}')
        c2 = profile.SLOConfig.from_spec(f"@{f}")
        assert c2.for_tenant("anyone")["target_p99_s"] == 9.0
        assert profile.SLOConfig.from_spec(str(f)) \
            .for_tenant("x")["target_p99_s"] == 9.0
        with pytest.raises(ValueError):
            profile.SLOConfig.from_spec('["not", "a", "mapping"]')
        with pytest.raises(ValueError):
            profile.SLOConfig({"t": 3})

    def test_config_from_env(self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_SLO",
                           '{"gold": {"target_p99_s": 0.3}}')
        c = profile.slo_config_from_env()
        assert c.for_tenant("gold") == {"target_p99_s": 0.3,
                                        "error_budget": 0.01}
        monkeypatch.delenv("DEPPY_GPU_SLO")
        assert profile.slo_config_from_env().tenants == {}

    def test_burn_rate_window(self):
        acc = profile.SLOAccountant(profile.SLOConfig.from_spec(
            '{"default": {"target_p99_s": 0.1, "error_budget": 0.5}}'))
        for _ in range(3):
            acc.observe("t", 0.01)
        acc.observe("t", 0.5)
        view = acc.snapshot()["t"]
        assert view["requests"] == 4
        assert view["violations"] == 1
        assert view["burn_rate"] == pytest.approx((1 / 4) / 0.5)
        assert view["p99_s"] == pytest.approx(0.5)
        text = "\n".join(acc.render_metric_lines())
        assert 'deppy_tenant_requests_total{tenant="t"} 4' in text
        assert 'deppy_tenant_burn_rate{tenant="t"} 0.5' in text

    def test_accountant_equals_the_reference(self):
        """The same observations give the reference's snapshot and
        exposition lines, with and without a replica name."""
        spec = '{"gold": {"target_p99_s": 0.05, "error_budget": 0.1}}'
        rng = np.random.default_rng(3)
        for replica in (None, "host:9000"):
            acc = profile.SLOAccountant(profile.SLOConfig.from_spec(spec),
                                        replica=replica)
            jacc = jprofile.SLOAccountant(
                jprofile.SLOConfig.from_spec(spec), replica=replica)
            for i in range(300):
                t = ("gold", "bronze", "x")[i % 3]
                lat = float(rng.exponential(0.04))
                miss = bool(rng.random() < 0.05)
                err = bool(rng.random() < 0.02)
                acc.observe(t, lat, deadline_miss=miss, error=err)
                jacc.observe(t, lat, deadline_miss=miss, error=err)
            assert acc.snapshot() == jacc.snapshot()
            assert acc.render_metric_lines() == jacc.render_metric_lines()

    def test_deadline_miss_counts(self):
        acc = profile.SLOAccountant()
        acc.observe("t", 0.001, deadline_miss=True)
        view = acc.snapshot()["t"]
        assert view["deadline_misses"] == 1
        assert view["violations"] == 1

    def test_tenant_cardinality_is_bounded(self):
        from deppy_tpu_torch.profile.slo import MAX_TENANTS, OVERFLOW_TENANT

        acc = profile.SLOAccountant()
        for i in range(MAX_TENANTS + 50):
            acc.observe(f"t{i}", 0.001)
        snap = acc.snapshot()
        assert len(snap) == MAX_TENANTS + 1
        assert snap[OVERFLOW_TENANT]["requests"] == 50
        acc.observe("t0", 0.002)
        assert acc.snapshot()["t0"]["requests"] == 2

    def test_single_tenant_flush_stamps_profile_event(self, tmp_path):
        sink = tmp_path / "t.jsonl"
        telemetry.default_registry().configure_sink(str(sink))
        s = Scheduler(backend="host", registry=telemetry.Registry(),
                      cache_size=0)
        s.start()
        try:
            with profile.override("on", 1.0):
                s.submit([random_instance(length=16, seed=1)],
                         tenant="solo")
        finally:
            s.stop()
            telemetry.default_registry().configure_sink(None)
        profs = [e for e in _sink_events(sink)
                 if e.get("kind") == "profile"]
        assert profs and profs[0]["backend"] == "host"
        assert profs[0]["tenant"] == "solo"

    def test_mixed_tenant_flush_stays_unstamped(self):
        """Two tenants' groups in one host flush: the event carries no
        tenant rather than a wrong one."""
        evs = _profile_events(telemetry.default_registry())
        s = Scheduler(backend="host", registry=telemetry.Registry(),
                      cache_size=0, max_wait_ms=200.0)
        s.start()
        try:
            import threading

            with profile.override("on", 1.0):
                ts = [threading.Thread(
                    target=s.submit,
                    args=([random_instance(length=16, seed=i)],),
                    kwargs={"tenant": f"t{i}"}) for i in range(2)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(60)
        finally:
            s.stop()
        assert [e["lanes"] for e in evs] == [2]
        assert "tenant" not in evs[0]

    def test_warm_flush_stamps_its_tenant(self):
        evs = _profile_events(telemetry.default_registry())
        s = Scheduler(device="cpu", registry=telemetry.Registry(),
                      cache_size=0)
        s.start()
        try:
            with profile.override("on", 1.0):
                s.submit([bundle_catalog()], tenant="w")
                s.submit([bundle_catalog(tweak=("add-dep", 1))],
                         tenant="w")
        finally:
            s.stop()
        warm = [e for e in evs if e["backend"] == "warm"]
        assert len(warm) == 1 and warm[0]["tenant"] == "w"
        assert warm[0]["lanes"] == 1 and warm[0]["lane_steps"] > 0

    def test_tenant_rides_fault_events(self, tmp_path):
        sink = tmp_path / "t.jsonl"
        telemetry.default_registry().configure_sink(str(sink))
        s = Scheduler(backend="host", registry=telemetry.Registry(),
                      cache_size=0)
        s.start()
        try:
            stats: dict = {}
            got = s.submit([random_instance(length=16, seed=0)],
                           deadline_s=1e-9, stats=stats,
                           tenant="team-x")
        finally:
            s.stop()
            telemetry.default_registry().configure_sink(None)
        from deppy_tpu_torch.sat.errors import Incomplete

        assert isinstance(got[0], Incomplete)
        assert stats["deadline_misses"] == 1
        misses = [e for e in _sink_events(sink) if e.get("kind") == "fault"
                  and e.get("fault") == "deadline_exceeded"]
        assert misses and misses[0].get("tenant") == "team-x"
