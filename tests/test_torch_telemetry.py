"""The port's telemetry against the JAX package's.

The registry's behaviours (the cases of ``tests/test_telemetry.py:24-133``)
run on both packages' registries; a real batch goes through both drivers
(the reference's budget escalation off, ``STAGE1_STEPS = 0``, its default,
set here so the run does not depend on the environment) and every
``SolveReport`` field the two share is compared with tolerance 0; then
the port's span names, ``Solver.report``, ``BatchResolver.last_report``
on both backends, and the JSONL sink through ``DEPPY_GPU_TELEMETRY_FILE``.
"""

from __future__ import annotations

import json

import pytest

from deppy_tpu import sat as jsat
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import (gvk_conflict_catalog, pinned_tenant_catalog,
                              random_instance, version_pinned_chains)
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine.convert import variables_from_objects
from deppy_tpu_torch.resolution import BatchResolver

PACKAGES = {"reference": jtelemetry, "port": ttelemetry}

# The fields both drivers fill; wall clocks and the backend label differ
# by nature.
REPORT_FIELDS = ("n_problems", "outcomes", "steps", "backtracks",
                 "batch_lanes", "live_lanes", "pad_cells", "live_cells",
                 "n_chunks", "n_buckets", "host_fallback_rows")

DRIVER_SPANS = {"driver.pad_pack", "driver.device_put", "driver.solve",
                "driver.decode"}


# ------------------------------------------------------------- primitives


def _counter_render_and_types(t, tmp_path):
    r = t.Registry()
    c = r.counter("x_total", "Things.")
    c.inc()
    c.inc(2)
    assert "x_total 3" in r.render()
    f = r.counter("y_total", "Seconds.", initial=0.0)
    f.inc(0.5)
    assert "y_total 0.5" in r.render()


def _labeled_counter_sorted_and_preset(t, tmp_path):
    r = t.Registry()
    c = r.counter("o_total", "Outcomes.", labelname="outcome")
    c.preset("sat", "unsat", "incomplete")
    c.inc(2, label="sat")
    lines = [ln for ln in r.render_lines() if ln.startswith("o_total{")]
    assert lines == [
        'o_total{outcome="incomplete"} 0',
        'o_total{outcome="sat"} 2',
        'o_total{outcome="unsat"} 0',
    ]


def _gauge_absent_until_set(t, tmp_path):
    r = t.Registry()
    g = r.gauge("verdict", "A verdict.")
    assert "verdict" not in r.render()
    g.set(1)
    assert "verdict 1" in r.render()


def _histogram_cumulative_monotonic(t, tmp_path):
    r = t.Registry()
    h = r.histogram("lat", "Latency.", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    cum = h.cumulative()
    assert cum == [("0.1", 1), ("1", 3), ("10", 4), ("+Inf", 5)]
    assert h.count == 5
    assert h.sum == pytest.approx(56.05)
    text = r.render()
    assert 'lat_bucket{le="+Inf"} 5' in text
    assert "lat_count 5" in text


def _family_kind_conflict_raises(t, tmp_path):
    r = t.Registry()
    r.counter("dup", "x")
    with pytest.raises(ValueError, match="already registered"):
        r.histogram("dup", "x")


def _span_records_duration_and_attrs(t, tmp_path):
    r = t.Registry()
    with r.span("stage", items=3) as sp:
        sp["extra"] = 1
    assert sp.dur_s >= 0
    (ev,) = r.recent_spans()
    assert ev["name"] == "stage"
    assert ev["attrs"] == {"items": 3, "extra": 1}


def _span_and_emit_to_jsonl(t, tmp_path):
    path = tmp_path / "telemetry.jsonl"
    r = t.Registry(sink_path=str(path))
    with r.span("a", k=1):
        pass
    r.emit({"kind": "custom", "v": 2})
    r.configure_sink(None)
    events = list(t.iter_sink_events(str(path)))
    assert [e["kind"] for e in events] == ["span", "custom"]
    assert events[0]["name"] == "a" and events[0]["attrs"] == {"k": 1}


def _no_sink_is_silent(t, tmp_path):
    r = t.Registry()
    with r.span("a"):
        pass
    r.emit({"kind": "x"})
    assert r.sink_path is None


def _sink_failure_disables_not_raises(t, tmp_path):
    r = t.Registry(sink_path=str(tmp_path / "no" / "dir" / "t.jsonl"))
    r.emit({"kind": "x"})
    assert r.sink_path is None


def _report_ratios(t, tmp_path):
    rep = t.SolveReport()
    rep.record_batch(live_lanes=3, batch_lanes=4, live_cells=30,
                     pad_cells=120, n_chunks=2)
    assert rep.batch_fill_ratio == pytest.approx(0.75)
    assert rep.pad_waste_ratio == pytest.approx(0.75)
    d = rep.to_dict()
    assert d["n_chunks"] == 2 and d["n_buckets"] == 1
    assert "escalation stage" in rep.format_table()
    back = t.SolveReport.from_dict(d)
    assert back.to_dict() == d
    other = t.SolveReport(n_problems=2, steps=5)
    other.count_outcome("sat", 2)
    back.merge(other)
    assert back.n_problems == 2 and back.steps == 5
    assert back.outcomes["sat"] == 2 and back.n_buckets == 1


def _nested_begin_merges(t, tmp_path):
    rep, owns = t.begin_report(n_problems=2)
    assert owns
    try:
        inner, inner_owns = t.begin_report(n_problems=3)
        assert inner is rep and not inner_owns
        assert rep.n_problems == 5
        t.end_report(inner, inner_owns)
        assert t.current_report() is rep
    finally:
        t.end_report(rep, owns)
    assert t.current_report() is None
    assert t.last_report() is rep
    rep2, owns2 = t.begin_report(n_problems=1)
    t.detach_report(rep2, owns2)
    assert t.current_report() is None and t.last_report() is rep


def _percentile_nearest_rank(t, tmp_path):
    vals = sorted([5, 1, 4, 2, 3])
    assert t.percentile(vals, 50) == 3
    assert t.percentile(vals, 99) == 5
    assert t.percentile([], 50) == 0


REGISTRY_CASES = [
    _counter_render_and_types, _labeled_counter_sorted_and_preset,
    _gauge_absent_until_set, _histogram_cumulative_monotonic,
    _family_kind_conflict_raises, _span_records_duration_and_attrs,
    _span_and_emit_to_jsonl, _no_sink_is_silent,
    _sink_failure_disables_not_raises, _report_ratios,
    _nested_begin_merges, _percentile_nearest_rank,
]


@pytest.mark.parametrize("package", list(PACKAGES))
@pytest.mark.parametrize("case", REGISTRY_CASES,
                         ids=[c.__name__.strip("_") for c in REGISTRY_CASES])
def test_registry_behaviour(case, package, tmp_path):
    case(PACKAGES[package], tmp_path)


def test_env_configures_default_registry(tmp_path, monkeypatch):
    path = tmp_path / "t.jsonl"
    monkeypatch.setenv("DEPPY_GPU_TELEMETRY_FILE", str(path))
    prev = ttelemetry.set_default_registry(None)
    try:
        assert ttelemetry.default_registry().sink_path == str(path)
    finally:
        ttelemetry.set_default_registry(prev)


def test_flight_recorder_ring_knobs(monkeypatch):
    monkeypatch.setenv("DEPPY_GPU_TRACE_RING", "3")
    monkeypatch.setenv("DEPPY_GPU_TRACE_ERROR_RING", "2")
    rec = ttelemetry.trace.FlightRecorder()
    assert (rec.capacity, rec.error_capacity) == (3, 2)
    for _ in range(5):
        rec.record(ttelemetry.trace.TraceContext(), status=500)
    assert len(rec.traces()) == 3
    ctx = ttelemetry.trace.TraceContext()
    with ttelemetry.trace.activate(ctx):
        reg = ttelemetry.Registry()
        with reg.span("outer"):
            with reg.span("inner"):
                pass
    spans = {s["name"]: s for s in ctx.spans}
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]


# ------------------------------------------------- driver instrumentation


@pytest.fixture()
def registries(tmp_path):
    """Both default registries swapped for fresh ones with JSONL sinks."""
    paths = {k: tmp_path / f"{k}.jsonl" for k in PACKAGES}
    prev = {k: t.set_default_registry(t.Registry(sink_path=str(paths[k])))
            for k, t in PACKAGES.items()}
    yield paths
    for k, t in PACKAGES.items():
        t.default_registry().configure_sink(None)  # closes the file
        t.set_default_registry(prev[k])


def _batch():
    """A mixed catalog batch that splits into several size-class
    buckets, with UNSAT lanes (pinned tenants) and lanes that backtrack."""
    out = []
    for s in range(4):
        out.append(gvk_conflict_catalog(8, 3, 4, seed=s))
        out.append(pinned_tenant_catalog(seed=s))
    for s in range(16):
        out.append(version_pinned_chains(6, 3, seed=s))
        out.append(random_instance(length=16, seed=s))
    return out


def _fields(rep) -> dict:
    d = rep.to_dict()
    return {k: d[k] for k in REPORT_FIELDS}


@pytest.mark.parametrize("host_ncons", [None, 8],
                         ids=["device-cores", "host-routed-cores"])
def test_batch_report_matches_reference(registries, monkeypatch, host_ncons):
    """The same batch through both drivers' ``solve_batch``: every shared
    report field equal (with the host-core threshold lowered in both
    drivers, the routed rows too), and the span names in each sink."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    monkeypatch.setattr(tdriver, "STAGE1_STEPS", 0)
    if host_ncons is not None:
        monkeypatch.setattr(jdriver, "HOST_CORE_NCONS", host_ncons)
        monkeypatch.setattr(tdriver, "HOST_CORE_NCONS", host_ncons)
    jvs = _batch()
    jstats, tstats = {}, {}
    want = jdriver.solve_batch(jvs, stats=jstats)
    got = tdriver.solve_batch([variables_from_objects(v) for v in jvs],
                              stats=tstats, device="cpu")
    assert len(want) == len(got) == len(jvs)
    jrep, trep = jstats["report"], tstats["report"]
    assert trep.backend == "device"
    assert _fields(trep) == _fields(jrep)
    assert trep.n_buckets > 1
    assert (trep.host_fallback_rows > 0) == (host_ncons is not None)
    for k in ("pad_pack", "device_put", "solve"):
        assert trep.wall[k] >= 0
    events = list(ttelemetry.iter_sink_events(str(registries["port"])))
    names = {e["name"] for e in events if e["kind"] == "span"}
    assert DRIVER_SPANS <= names
    # The escalation ladder is off (STAGE1_STEPS 0 in both drivers): one
    # stage-0 escalation span per bucket, as the reference emits.
    stages = [e["attrs"]["stage"] for e in events
              if e["kind"] == "span" and e["name"] == "driver.escalation"]
    assert stages == [0] * trep.n_buckets
    assert trep.escalation_stage == jrep.escalation_stage == 0
    reports = [e["report"] for e in events if e["kind"] == "report"]
    assert len(reports) == 1 and reports[0] == trep.to_dict()
    snap = ttelemetry.default_registry().snapshot()
    assert snap["deppy_solve_seconds"]["count"] == 1
    assert snap["deppy_chunks_total"] == trep.n_chunks
    assert snap["deppy_pad_cells_total"] == trep.pad_cells
    assert snap["deppy_live_cells_total"] == trep.live_cells
    assert snap.get("deppy_host_fallback_rows_total", 0) == \
        trep.host_fallback_rows


def _backtracking_instance():
    return [
        jsat.variable("a", jsat.mandatory(), jsat.dependency("b", "c")),
        jsat.variable("c"),
        jsat.variable("b", jsat.dependency("x", "y"),
                      jsat.dependency("w", "z")),
        jsat.variable("x", jsat.conflict("w"), jsat.conflict("z")),
        jsat.variable("y", jsat.conflict("w"), jsat.conflict("z")),
        jsat.variable("w"),
        jsat.variable("z"),
    ]


def _solve(solver):
    try:
        solver.solve()
    except (jsat.NotSatisfiable, tsat.NotSatisfiable):
        pass
    return solver.report


@pytest.mark.parametrize("make", [_backtracking_instance,
                                  lambda: pinned_tenant_catalog(seed=1)],
                         ids=["backtrack-sat", "tenant"])
def test_solver_report_matches_reference(registries, monkeypatch, make):
    """``Solver.report``: on the device backend the driver's report
    equals the reference tensor backend's; on the host backend the
    engine's counters equal the reference host engine's."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    jvs = make()
    tvs = variables_from_objects(jvs)
    want = _solve(jsat.Solver(jvs, backend="tpu"))
    got = _solve(tsat.Solver(tvs, device="cpu"))
    assert got.backend == "device" and got is ttelemetry.last_report()
    assert _fields(got) == _fields(want)
    host_fields = ("n_problems", "outcomes", "steps", "backtracks",
                   "decisions", "propagation_rounds")
    want = _solve(jsat.Solver(jvs, backend="host",
                              tracer=jsat.DefaultTracer())).to_dict()
    got = _solve(tsat.Solver(tvs, backend="host")).to_dict()
    assert got["backend"] == "host"
    assert {k: got[k] for k in host_fields} == \
        {k: want[k] for k in host_fields}
    assert got["wall_s"]["solve"] >= 0


def test_batch_resolver_last_report_both_backends(registries):
    """``BatchResolver.last_report`` on either backend: the same
    outcomes and counters; the host batch runs under a
    ``facade.host_solve`` span and publishes its report."""
    pool = [variables_from_objects(pinned_tenant_catalog(seed=s))
            for s in range(3)] + [variables_from_objects(
                _backtracking_instance())]
    dev = BatchResolver(device="cpu")
    host = BatchResolver(backend="host")

    def render(r):
        if isinstance(r, dict):
            return sorted(k for k, on in r.items() if on)
        return sorted(str(c) for c in r.constraints)

    assert [render(r) for r in dev.solve(pool)] == \
        [render(r) for r in host.solve(pool)]
    drep, hrep = dev.last_report, host.last_report
    assert drep.backend == "device" and hrep.backend == "host"
    assert hrep is ttelemetry.last_report()
    for k in ("n_problems", "outcomes", "backtracks"):
        assert getattr(drep, k) == getattr(hrep, k)
    assert drep.steps == dev.last_steps and hrep.steps == host.last_steps
    assert hrep.decisions > 0
    events = list(ttelemetry.iter_sink_events(str(registries["port"])))
    assert "facade.host_solve" in {e.get("name") for e in events}
    assert [e["report"]["backend"] for e in events
            if e["kind"] == "report"] == ["device", "host"]


def test_sink_through_env_knob(tmp_path, monkeypatch):
    """``DEPPY_GPU_TELEMETRY_FILE`` alone: a solve's four driver spans and
    its one report event reach the JSONL file."""
    path = tmp_path / "sink.jsonl"
    monkeypatch.setenv("DEPPY_GPU_TELEMETRY_FILE", str(path))
    prev = ttelemetry.set_default_registry(None)
    try:
        BatchResolver(device="cpu").solve(
            [variables_from_objects(random_instance(length=12, seed=s))
             for s in range(3)])
        ttelemetry.default_registry().configure_sink(None)
    finally:
        ttelemetry.set_default_registry(prev)
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert DRIVER_SPANS <= {e["name"] for e in events if e["kind"] == "span"}
    reports = [e for e in events if e["kind"] == "report"]
    assert len(reports) == 1 and reports[0]["report"]["n_problems"] == 3
