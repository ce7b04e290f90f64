"""The port's sink verbs (``stats``, ``profile``, ``trace``, ``routes``)
against the reference's CLI, on sinks the port wrote.

Each case writes a JSONL sink through the port (its solves, its host
pool, its server, its racing scheduler, its fleet aggregator), or takes
the reference test's synthetic events, then runs the reference's
``deppy_tpu.cli.main`` and the port's ``deppy_tpu_torch.cli.main`` on the
same argv and file and holds the exit code and stdout equal (stderr too,
but for the knob's name in a message).  The cases are the reference's
own: ``tests/test_profile.py::TestCLI``, ``tests/test_routes.py::
TestRoutesReport::test_cli_*``, ``tests/test_trace.py``'s
``test_cli_trace_*``, ``tests/test_obs.py:461-473`` and ``:605-610``,
``tests/test_hostpool.py:410-424``.
"""

from __future__ import annotations

import json
from http.client import HTTPConnection

import pytest

from deppy_tpu import cli as ref_cli
from deppy_tpu_torch import cli as port_cli
from deppy_tpu_torch import faults, profile, telemetry
from deppy_tpu_torch.engine import driver
from deppy_tpu_torch.models import (gvk_conflict_catalog,
                                    pinned_tenant_catalog, random_instance)
from deppy_tpu_torch.sat.encode import encode
from deppy_tpu_torch.telemetry import trace


@pytest.fixture(autouse=True)
def fresh_port_state(monkeypatch):
    """A fresh port registry, recorder, breaker and fault plan per test;
    no sink named by either package's environment; host lanes inline."""
    for name in ("DEPPY_TPU_TELEMETRY_FILE", "DEPPY_GPU_TELEMETRY_FILE",
                 "DEPPY_TPU_OBS_SINK", "DEPPY_GPU_OBS_SINK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "0")
    prev_breaker = faults.set_default_breaker(faults.CircuitBreaker())
    prev_plan = faults.configure_plan(None)
    prev_reg = telemetry.set_default_registry(telemetry.Registry())
    prev_rec = trace.set_default_recorder(trace.FlightRecorder())
    yield
    telemetry.default_registry().configure_sink(None)
    trace.set_default_recorder(prev_rec)
    telemetry.set_default_registry(prev_reg)
    faults.configure_plan(prev_plan)
    faults.set_default_breaker(prev_breaker)


def run(capsys, main, argv):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def both(capsys, argv):
    """(reference, port): each (exit code, stdout, stderr), the
    reference's knob names in the port's spelling."""
    rc, out, err = run(capsys, ref_cli.main, argv)
    ref = (rc, out.replace("DEPPY_TPU_", "DEPPY_GPU_"),
           err.replace("DEPPY_TPU_", "DEPPY_GPU_"))
    return ref, run(capsys, port_cli.main, argv)


def same(capsys, argv, rc=0):
    ref, got = both(capsys, argv)
    assert ref[0] == rc, ref
    assert got == ref
    return got[1]


def write_events(path, events):
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return str(path)


def _fuzz(n, length=12):
    return [encode(random_instance(length=length, seed=s)) for s in range(n)]


@pytest.fixture
def sink(tmp_path):
    """The port's default registry writes to this file while the test
    runs."""
    path = tmp_path / "port.jsonl"
    telemetry.default_registry().configure_sink(str(path))
    return str(path)


def _close(sink_path):
    telemetry.default_registry().configure_sink(None)
    return sink_path


# --------------------------------------------- tests/test_profile.py::TestCLI


def _synthetic_profile(tmp_path):
    """Known-linear sink: solve_s = 1ms + 100µs * trips."""
    events = []
    for i, trips in enumerate((10, 20, 40, 80)):
        events.append({
            "ts": 1.0 + i, "kind": "profile", "backend": "device",
            "size_class": 256, "lanes": 16, "live": 12,
            "chunk": 16, "trips": trips, "lane_steps": trips * 4,
            "lane_p50": 3, "lane_p99": trips - 1,
            "useful_work_ratio": 0.25,
            "straggler_p99_ratio": 0.9, "pad_waste_ratio": 0.5,
            "pad_cells": 1000, "live_cells": 500,
            "solve_s": 0.001 + 100e-6 * trips})
    events.append({"ts": 9.0, "kind": "profile", "backend": "host",
                   "lanes": 8, "live": 8, "lane_steps": 99,
                   "solve_s": 0.004})
    return write_events(tmp_path / "t.jsonl", events)


class TestProfile:
    @pytest.mark.parametrize("output", ["json", "text"])
    def test_synthetic_regression(self, tmp_path, capsys, output):
        out = same(capsys, ["profile", _synthetic_profile(tmp_path),
                            "--output", output])
        if output == "json":
            reg = json.loads(out)["trip_overhead"]
            assert reg["points"] == 4
            assert reg["us_per_trip"] == pytest.approx(100.0, rel=1e-3)
        else:
            assert "us/trip" in out and "backends:" in out

    def test_live_trip_overhead(self, capsys, sink):
        """Mixed load on the port's plain device path, profiled: both
        CLIs fit the same cost model from the port's sink."""
        with profile.override("on", 1.0):
            for n, length in ((4, 12), (10, 24), (16, 36)):
                driver.solve_problems(_fuzz(n, length=length), device="cpu")
        _close(sink)
        out = json.loads(same(capsys, ["profile", sink, "--output",
                                       "json"]))
        assert out["device_dispatches"] == 3
        assert out["trip_overhead"]["points"] == 3
        assert "us/trip" in same(capsys, ["profile", sink])

    def test_no_profile_events_and_missing_file(self, tmp_path, capsys):
        path = write_events(tmp_path / "spans.jsonl", [
            {"ts": 1.0, "kind": "span", "name": "x", "dur_s": 0.1}])
        assert "DEPPY_GPU_PROFILE=on" in same(capsys, ["profile", path])
        same(capsys, ["profile", str(tmp_path / "nope.jsonl")], rc=2)
        same(capsys, ["profile"], rc=2)


# ------------------------------------------------------------------- stats


class TestStats:
    def test_tenant_filter_and_profile_tally(self, tmp_path, capsys):
        path = write_events(tmp_path / "t.jsonl", [
            {"ts": 1.0, "kind": "span", "name": "service.request",
             "dur_s": 0.5, "attrs": {"tenant": "a"}},
            {"ts": 2.0, "kind": "span", "name": "service.request",
             "dur_s": 0.1, "attrs": {"tenant": "b"}},
            {"ts": 3.0, "kind": "fault", "fault": "deadline_exceeded",
             "tenant": "a", "where": "sched.dispatch", "problems": 1},
            {"ts": 4.0, "kind": "profile", "backend": "device",
             "trips": 5, "lane_steps": 10, "useful_work_ratio": 0.5,
             "solve_s": 0.01}])
        out = json.loads(same(capsys, ["stats", path, "--output", "json",
                                       "--tenant", "a"]))
        assert out["events"] == 2
        assert out["event_kinds"] == {"span": 1, "fault": 1}
        text = same(capsys, ["stats", path])
        assert "profile: 1 events" in text and "trips=5" in text
        same(capsys, ["stats", path, "--tenant", "b"])

    def test_json_profile_keys_are_stable(self, tmp_path, capsys):
        path = write_events(tmp_path / "t.jsonl", [
            {"ts": 1.0, "kind": "profile", "backend": "host",
             "lanes": 4, "live": 4, "lane_steps": 9, "solve_s": 0.002}])
        out = json.loads(same(capsys, ["stats", path, "--output", "json"]))
        assert out["profile"]["mean_useful_work_ratio"] is None
        assert "_useful" not in out["profile"]

    def test_percentiles_and_span_filter(self, tmp_path, capsys):
        events = [{"ts": i, "kind": "span", "name": "driver.solve",
                   "dur_s": dur, "attrs": {}}
                  for i, dur in enumerate([0.1] * 98 + [1.0, 10.0])]
        events.append({"ts": 99, "kind": "span", "name": "other",
                       "dur_s": 0.5, "attrs": {}})
        path = write_events(tmp_path / "t.jsonl", events)
        agg = json.loads(same(capsys, ["stats", path, "--output",
                                       "json"]))["spans"]["driver.solve"]
        assert agg["count"] == 100 and agg["p99_s"] == pytest.approx(1.0)
        doc = json.loads(same(capsys, ["stats", path, "--span",
                                       "driver.solve", "--output", "json"]))
        assert list(doc["spans"]) == ["driver.solve"]
        text = same(capsys, ["stats", path, "--span", "driver.solve"])
        assert "p95_ms" in text and "other" not in text
        same(capsys, ["stats", path, "--span", "nope"])

    def test_merges_repeated_file(self, tmp_path, capsys):
        """``tests/test_obs.py:461-473``: a dump copy deduped."""
        span = {"ts": 1.0, "kind": "span", "name": "service.request",
                "dur_s": 0.01, "trace_id": "t", "span_id": "s1",
                "replica": "rep0"}
        a = write_events(tmp_path / "a.jsonl", [span])
        b = write_events(tmp_path / "b.jsonl",
                         [span, dict(span, span_id="s2", replica="rep1")])
        for output in ("text", "json"):
            out = same(capsys, ["stats", "--file", a, "--file", b,
                                "--output", output])
        assert json.loads(out)["spans"]["service.request"]["count"] == 2

    def test_hostpool_dispatch_span(self, capsys, sink):
        """``tests/test_hostpool.py:410-424`` over the port's pool."""
        from deppy_tpu_torch import hostpool

        pool = hostpool.HostPool(workers=2)
        try:
            pool.solve(_fuzz(8))
        finally:
            pool.shutdown()
        _close(sink)
        assert "hostpool.dispatch" in same(
            capsys, ["stats", sink, "--span", "hostpool.dispatch"])
        doc = json.loads(same(capsys, ["stats", sink, "--output", "json"]))
        assert doc["spans"]["hostpool.dispatch"]["count"] >= 1
        assert doc["spans"]["hostpool.worker_solve"]["count"] >= 1

    def test_resolve_sink_and_last_report(self, tmp_path, capsys):
        """``resolve --telemetry-file`` on the port's plain device path;
        both CLIs summarize its spans and render its last report."""
        from deppy_tpu_torch import io as port_io

        path = tmp_path / "batch.json"

        states = ([gvk_conflict_catalog(20, 4, 10, seed=s) for s in range(3)]
                  + [pinned_tenant_catalog(seed=s) for s in range(3)])
        path.write_text(json.dumps({"problems": [
            {"variables": [port_io.variable_to_dict(v) for v in vs]}
            for vs in states]}))
        sink = str(tmp_path / "resolve.jsonl")
        try:
            assert run(capsys, port_cli.main, [
                "resolve", str(path), "--device", "cpu",
                "--telemetry-file", sink])[0] == 1
        finally:
            telemetry.configure_sink(None)
        text = same(capsys, ["stats", sink])
        assert "driver.solve" in text and "last " in text
        doc = json.loads(same(capsys, ["stats", sink, "--output", "json"]))
        assert doc["last_report"] is not None

    def test_no_file_is_a_usage_error(self, capsys):
        same(capsys, ["stats"], rc=2)
        same(capsys, ["routes"], rc=2)


# ------------------------------------------------------------------- trace


def _server(**kw):
    from deppy_tpu_torch.service import Server

    srv = Server(device="cpu", bind_address="127.0.0.1:0",
                 probe_address="127.0.0.1:0", **kw)
    srv.start()
    return srv


def _resolve(port, doc, headers):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/resolve", json.dumps(doc),
                     dict(headers, **{"Content-Type": "application/json"}))
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def _doc(seed):
    from deppy_tpu_torch import io as port_io

    return {"variables": [port_io.variable_to_dict(v) for v in
                          random_instance(length=12, seed=seed)]}


class TestTrace:
    def test_server_sink_trees(self, tmp_path, capsys, sink):
        """``tests/test_trace.py:436-455`` and ``:578-597`` on a port
        server's sink: a request id resolved from live spans, a
        ``traceparent`` tree with the coalesced dispatch grafted in, an
        unknown id; and ``--fleet`` over the same events merged by the
        port's aggregator (``tests/test_obs.py:605-610``)."""
        from deppy_tpu_torch import obs

        tid = "6f" * 16
        srv = _server(sched_max_wait_ms=10.0)
        try:
            assert _resolve(srv.api_port, _doc(0),
                            {"X-Deppy-Request-Id": "my-req-77"}) == 200
            assert _resolve(srv.api_port, _doc(1), {
                "traceparent": f"00-{tid}-{'cd' * 8}-01"}) == 200
        finally:
            srv.shutdown()
        _close(sink)
        out = same(capsys, ["trace", "my-req-77", "--file", sink])
        assert "service.request" in out and "request my-req-77" in out
        out = same(capsys, ["trace", tid, "--file", sink])
        assert "sched.dispatch" in out and "sched.queue_wait" in out
        same(capsys, ["trace", tid, "--file", sink, "--output", "json"])
        same(capsys, ["trace", "ffff", "--file", sink], rc=2)
        merged = str(tmp_path / "merged.jsonl")
        agg = obs.Aggregator(merged)
        with open(sink) as fh:
            events = [json.loads(line) for line in fh if line.strip()]
        try:
            assert agg.ingest({"replica": "r0", "events": events})[0] == \
                len(events)
        finally:
            agg.close()
        for argv in (["trace", "--fleet", "my-req-77", "--file", merged],
                     ["trace", "--fleet", tid, "--file", merged,
                      "--output", "json"]):
            assert "service.request" in same(capsys, argv)
        same(capsys, ["trace", "--fleet", "my-req-77"], rc=2)

    def test_profile_events_in_the_tree(self, capsys, sink):
        """A profile event stamped under a dispatch trace shows in the
        reconstructed tree."""
        ctx = trace.TraceContext()
        with trace.activate(ctx), profile.override("on", 1.0):
            with telemetry.default_registry().span("service.request",
                                                   request_id="r1"):
                driver.solve_problems(_fuzz(6), device="cpu")
        _close(sink)
        out = same(capsys, ["trace", ctx.trace_id, "--file", sink])
        assert "(profile)" in out and "trips=" in out

    @pytest.mark.parametrize("case", ["dumped", "distinct", "orphan"])
    def test_synthetic_events(self, tmp_path, capsys, case):
        """``tests/test_trace.py:630-693``: a dumped fault event printed
        once, two identical-looking events kept by their ``seq``, an event
        whose parent span never completed."""
        tid, root = "7a" * 16, "8b" * 8
        span = {"ts": 1.0, "kind": "span", "name": "service.request",
                "dur_s": 0.5, "attrs": {}, "trace_id": tid,
                "span_id": root}
        fault = {"ts": 1.1, "kind": "fault", "fault": "dispatch_failed",
                 "attempt": 1, "trace_id": tid, "parent_id": root}
        events = {
            "dumped": [span, fault, {
                "ts": 2.0, "kind": "trace", "reason": "sigusr2",
                "trace": {"trace_id": tid, "request_id": tid,
                          "spans": [span], "events": [fault]}}],
            "distinct": [span] + [dict(fault, fault="deadline_exceeded",
                                       seq=s) for s in (7, 8)],
            "orphan": [span, dict(fault, parent_id="ff" * 8, seq=1)]}[case]
        path = write_events(tmp_path / "t.jsonl", events)
        doc = json.loads(same(capsys, ["trace", tid, "--file", path,
                                       "--output", "json"]))
        assert len(doc["events"]) == {"dumped": 1, "distinct": 2,
                                      "orphan": 1}[case]
        out = same(capsys, ["trace", tid, "--file", path])
        assert ("unattached events:" in out) == (case == "orphan")


# ------------------------------------------------------------------ routes


ROUTE_EVENTS = [
    {"ts": 1.0, "kind": "race", "size_class": 512, "size_class_name": "m",
     "backends": ["device", "host"], "winner": "host", "margin_s": 0.01,
     "canonical": "device", "frozen": "device", "wall_s": 0.02,
     "losers": {"device": {"wall_s": 0.06, "censored": False}}},
    {"ts": 2.0, "kind": "route_stale", "key": "portfolio.m",
     "size_class_name": "m", "reason": "stale", "age_s": 9e9},
    {"ts": 3.0, "kind": "route", "size_class": 512, "size_class_name": "m",
     "backend": "grad_relax", "lanes": 4, "shadow": True,
     "wall_s": 0.002, "ok": True},
    {"ts": 4.0, "kind": "route_learned", "key": "portfolio.m",
     "row": "host,device", "size_class_name": "m",
     "source": "live", "platform": "cpu",
     "est_us_per_lane": {"host": 10000.0, "device": 50000.0}},
]


class TestRoutes:
    def test_synthetic_sink_and_registry(self, tmp_path, capsys):
        """``tests/test_routes.py:574-590``, and the registry's
        provenance joined from ``--registry``."""
        path = write_events(tmp_path / "sink.jsonl", ROUTE_EVENTS)
        reg = tmp_path / "rows.json"
        reg.write_text(json.dumps({"cpu": {
            "portfolio": "device,host",
            "evidence": {"portfolio": {"ts": 1000.0, "box": "b"}}}}))
        out = same(capsys, ["routes", path, "--registry", str(reg)])
        assert "m" in out and "regret" in out
        doc = json.loads(same(capsys, ["routes", path, "--output", "json",
                                       "--registry", str(reg)]))
        assert doc["totals"]["learned_rows"] == 1
        same(capsys, ["routes", str(tmp_path / "nope.jsonl")], rc=2)

    def test_racing_scheduler_sink(self, tmp_path, capsys, sink):
        """A racing port scheduler's ``race`` events, rendered alike."""
        from deppy_tpu_torch.sched import Scheduler

        racing = Scheduler(device="cpu", portfolio="on", portfolio_k=3,
                           cache_size=0)
        assert len(racing.submit([pinned_tenant_catalog(seed=0)] * 2)) == 2
        from deppy_tpu_torch.sched import scheduler as sched_mod

        sched_mod._join_race_threads()
        _close(sink)
        empty = str(tmp_path / "none.json")
        for output in ("text", "json"):
            out = same(capsys, ["routes", sink, "--registry", empty,
                                "--output", output])
        assert json.loads(out)["totals"]["races"] >= 1
