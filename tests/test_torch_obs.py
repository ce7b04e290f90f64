"""The port's observability plane against the JAX package's.

``deppy_tpu.obs`` beside ``deppy_tpu_torch.obs`` on the same inputs, on
the CPU:

  * the server-free cases of ``tests/test_obs.py`` on both packages —
    the streamer's bounded queue, batching, hold-off, reconnect count,
    close flush and forwarder registration; the aggregator's stamping
    and rejects; the fleet rollups and the scrape merge; the baseline
    shapes and the drift watchdog; the merged-sink dedupe — and the
    route rollups of ``tests/test_routes.py::TestFleetRollups``;
  * ``collect``/``render_fleet_metrics`` over a stub router with two
    stdlib HTTP replicas and a dead one, and ``top`` over a stub serving
    ``/fleet/metrics`` and ``/fleet/status``;
  * one recorded stream of ``profile`` events from the port's CPU
    ``driver.solve_problems``, fed to both watchdogs;
  * a ``route_learned`` event from each package's online route registry
    streamed to a stub aggregator, stamped with its replica;
  * the six ``DEPPY_GPU_OBS_*`` knobs, read as the reference reads its
    ``DEPPY_TPU_OBS_*``, malformed values included.

Every comparison is exact, except an event's ``ts`` (a wall clock).
Every HTTP server a test starts is shut down in its ``finally``, and
every streamer and watchdog is closed, so no thread outlives its test.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import obs as jobs
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.obs import aggregate as jaggregate
from deppy_tpu.obs import drift as jdrift
from deppy_tpu.obs import federate as jfederate
from deppy_tpu.obs import stream as jstream
from deppy_tpu.obs import top as jtop
from deppy_tpu.routes.learn import OnlineRouteRegistry as JLearner
from deppy_tpu.engine import registry as jregistry
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import obs as tobs
from deppy_tpu_torch import profile as tprofile
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.engine import registry as tregistry
from deppy_tpu_torch.models import random_instance
from deppy_tpu_torch.obs import aggregate as taggregate
from deppy_tpu_torch.obs import drift as tdrift
from deppy_tpu_torch.obs import federate as tfederate
from deppy_tpu_torch.obs import stream as tstream
from deppy_tpu_torch.obs import top as ttop
from deppy_tpu_torch.profile import report as treport
from deppy_tpu_torch.routes.learn import OnlineRouteRegistry as TLearner
from deppy_tpu_torch.sat.encode import encode

SIDES = {
    "reference": dict(obs=jobs, aggregate=jaggregate, drift=jdrift,
                      federate=jfederate, stream=jstream, top=jtop,
                      telemetry=jtelemetry, learner=JLearner,
                      registry=jregistry, prefix="DEPPY_TPU_OBS_"),
    "port": dict(obs=tobs, aggregate=taggregate, drift=tdrift,
                 federate=tfederate, stream=tstream, top=ttop,
                 telemetry=ttelemetry, learner=TLearner,
                 registry=tregistry, prefix="DEPPY_GPU_OBS_"),
}
KNOBS = ("QUEUE", "BATCH", "FLUSH_MS", "BACKOFF_MAX_S", "DRIFT_BAND",
         "DRIFT_MIN")
DEAD = "127.0.0.1:9"  # the discard port: nothing listens


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each package's breaker, fault plan and default registry per test;
    no obs knob set; both packages' process streamer and watchdog and
    route overlays cleared after."""
    for name in KNOBS:
        monkeypatch.delenv(f"DEPPY_TPU_OBS_{name}", raising=False)
        monkeypatch.delenv(f"DEPPY_GPU_OBS_{name}", raising=False)
    prev_breakers = (jfaults.set_default_breaker(jfaults.CircuitBreaker()),
                     tfaults.set_default_breaker(tfaults.CircuitBreaker()))
    prev_plans = (jfaults.configure_plan(None), tfaults.configure_plan(None))
    prev = (jtelemetry.set_default_registry(jtelemetry.Registry()),
            ttelemetry.set_default_registry(ttelemetry.Registry()))
    yield
    jobs.stop_all()
    tobs.stop_all()
    jregistry.set_route_overlay({})
    tregistry.set_route_overlay({}, "cpu")
    jtelemetry.set_default_registry(prev[0])
    ttelemetry.set_default_registry(prev[1])
    jfaults.configure_plan(prev_plans[0])
    tfaults.configure_plan(prev_plans[1])
    jfaults.set_default_breaker(prev_breakers[0])
    tfaults.set_default_breaker(prev_breakers[1])


def both(fn):
    """``fn(side)`` for the reference, then the port: (want, got)."""
    return fn("reference"), fn("port")


def strip(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def counters(side, *names):
    reg = SIDES[side]["telemetry"].default_registry()
    return [reg.counter(n).value for n in names]


def samples(lines):
    """Exposition lines without their ``# HELP`` text: one help string
    of the port's is worded apart from the reference's."""
    return [ln for ln in lines if not ln.startswith("# HELP")]


class Served:
    """A stdlib HTTP server on ``127.0.0.1:0`` answering from ``routes``
    (``{(method, path): fn(body) -> (status, bytes)}``), shut down on
    exit."""

    def __init__(self, routes):
        table = routes

        class Handler(BaseHTTPRequestHandler):
            def _answer(self, method):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                fn = table.get((method, self.path))
                status, data = fn(body) if fn else (404, b"")
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — the stdlib's name
                self._answer("GET")

            def do_POST(self):  # noqa: N802 — the stdlib's name
                self._answer("POST")

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(5.0)


# -------------------------------------------------------------- streaming


def test_streamer_enqueue_never_blocks_and_counts_drops():
    def run(side):
        st = SIDES[side]["stream"].TelemetryStreamer(
            DEAD, replica="r1", queue_cap=4, flush_ms=10_000)
        for i in range(10):
            st.enqueue({"kind": "fault", "i": i})
        return st.queue_depth(), counters(
            side, "deppy_obs_stream_events_total",
            "deppy_obs_stream_dropped_total")
    want, got = both(run)
    assert got == want == (4, [4, 6])


def test_streamer_flush_batches_and_drops_failed_posts():
    def run(side):
        st = SIDES[side]["stream"].TelemetryStreamer(
            DEAD, replica="r1", batch=2, flush_ms=10_000)
        posted = []

        def _post(batch):
            posted.append(list(batch))
            return True

        st._post = _post
        for i in range(5):
            st.enqueue({"i": i})
        st.flush()
        sizes, depth = [len(b) for b in posted], st.queue_depth()
        st._post = lambda batch: False
        st.enqueue({"i": 99})
        st.flush()
        return sizes, depth, st.queue_depth(), counters(
            side, "deppy_obs_stream_batches_total",
            "deppy_obs_stream_errors_total")
    want, got = both(run)
    assert got == want == ([2, 2, 1], 0, 0, [3, 1])


def test_streamer_failed_post_arms_bounded_exponential_holdoff(monkeypatch):
    monkeypatch.setenv("DEPPY_TPU_OBS_BACKOFF_MAX_S", "0.5")
    monkeypatch.setenv("DEPPY_GPU_OBS_BACKOFF_MAX_S", "0.5")

    def run(side):
        st = SIDES[side]["stream"].TelemetryStreamer(
            DEAD, replica="r1", batch=2, flush_ms=100)
        st._post = lambda batch: False
        st.enqueue({"i": 0})
        st.flush()
        trail = [(st._down, st._backoff_s)]
        st.enqueue({"i": 1})
        st.flush()
        trail.append((st.queue_depth(), counters(
            side, "deppy_obs_stream_errors_total")))
        for _ in range(4):
            st._retry_at = 0.0
            st.enqueue({"i": 2})
            st.flush()
            trail.append(st._backoff_s)
        return trail
    want, got = both(run)
    assert got == want
    assert got == [(True, 0.1), (1, [1]), 0.2, 0.4, 0.5, 0.5]


def test_streamer_first_success_after_down_streak_counts_reconnect():
    def run(side):
        st = SIDES[side]["stream"].TelemetryStreamer(
            DEAD, replica="r1", batch=2, flush_ms=100)
        st._post = lambda batch: False
        st.enqueue({"i": 0})
        st.flush()
        trail = [st._down]
        st._post = lambda batch: True
        st._retry_at = 0.0
        st.enqueue({"i": 1})
        st.flush()
        trail += [st._down, st._backoff_s, st.queue_depth(),
                  counters(side, "deppy_obs_stream_reconnects_total")]
        st.enqueue({"i": 2})
        st.flush()
        trail.append(counters(side, "deppy_obs_stream_reconnects_total"))
        return trail
    want, got = both(run)
    assert got == want == [True, False, 0.0, 0, [1], [1]]


def test_streamer_close_flush_bypasses_the_holdoff():
    def run(side):
        st = SIDES[side]["stream"].TelemetryStreamer(
            DEAD, replica="r1", batch=2, flush_ms=100)
        st._post = lambda batch: False
        st.enqueue({"i": 0})
        st.flush()
        st._post = lambda batch: True
        st.enqueue({"i": 1})
        st.flush()
        held = st.queue_depth()
        st._stop.set()
        st.flush()
        return held, st.queue_depth(), counters(
            side, "deppy_obs_stream_batches_total")
    want, got = both(run)
    assert got == want == (1, 0, [1])


def test_streamer_forwarder_captures_sink_events():
    def run(side):
        reg = SIDES[side]["telemetry"].default_registry()
        st = SIDES[side]["stream"].TelemetryStreamer(
            DEAD, replica="r1", flush_ms=10_000)
        st._post = lambda batch: True
        st.start()
        try:
            reg.event("fault", point="x")
            with reg.span("unit.span"):
                pass
            armed = st.queue_depth()
        finally:
            st.close()
        depth = st.queue_depth()
        reg.event("fault", point="y")
        return armed, depth, st.queue_depth(), st._thread
    want, got = both(run)
    assert got == want == (2, 0, 0, None)


def test_stream_families_and_post_timeout_equal():
    assert tstream.STREAM_FAMILIES == jstream.STREAM_FAMILIES
    assert tstream.POST_TIMEOUT_S == jstream.POST_TIMEOUT_S
    assert tobs.__all__ == jobs.__all__


def test_streamer_posts_batches_to_a_live_aggregator(tmp_path):
    """The real ``_post`` over HTTP: each package's streamer delivers to
    its own aggregator behind a stub ``POST /fleet/telemetry``; the
    merged sinks hold the same stamped events."""
    def run(side):
        s = SIDES[side]
        agg = s["aggregate"].Aggregator(str(tmp_path / f"{side}.jsonl"))

        def ingest(body):
            n, err = agg.ingest(json.loads(body))
            return (400, err.encode()) if err else (200, b"{}")

        with Served({("POST", "/fleet/telemetry"): ingest}) as srv:
            st = s["stream"].TelemetryStreamer(srv.addr, replica="r0",
                                               batch=3, flush_ms=10_000)
            for i in range(7):
                st.enqueue({"kind": "fault", "i": i})
            st.flush()
        agg.close()
        lines = (tmp_path / f"{side}.jsonl").read_text().splitlines()
        return ([json.loads(ln) for ln in lines], agg.counts(), counters(
            side, "deppy_obs_stream_batches_total",
            "deppy_obs_stream_errors_total"))
    want, got = both(run)
    assert got == want
    assert got[1] == {"r0": 7} and got[2] == [3, 0]
    assert {e["replica"] for e in got[0]} == {"r0"}


# ------------------------------------------------------------ aggregation


def test_aggregator_ingest_stamps_the_transport_source(tmp_path):
    def run(side):
        s = SIDES[side]
        sink = tmp_path / f"{side}.jsonl"
        reg = s["telemetry"].default_registry()
        agg = s["aggregate"].Aggregator(str(sink), registry=reg)
        out = [agg.ingest({
            "replica": "rep0",
            "events": [{"kind": "fault", "point": "x"},
                       {"kind": "profile", "replica": "forged"}]})]
        agg.ingest_event(s["aggregate"].ROUTER_REPLICA,
                         {"kind": "span", "name": "router.forward"})
        agg.close()
        return (out, sink.read_text(), agg.counts(),
                counters(side, "deppy_obs_ingest_events_total",
                         "deppy_obs_ingest_batches_total"),
                samples(reg.render_lines()))
    want, got = both(run)
    assert got == want
    assert got[0] == [(2, None)]
    assert [json.loads(ln)["replica"] for ln in got[1].splitlines()] == \
        ["rep0", "rep0", "router"]
    assert got[3] == [{"rep0": 2, "router": 1}, 1]


def test_aggregator_sanitizes_the_replica_stamp(tmp_path):
    def run(side):
        s = SIDES[side]
        sink = tmp_path / f"{side}.jsonl"
        agg = s["aggregate"].Aggregator(str(sink))
        agg.ingest({"replica": ' r0"}\n x', "events": [{"kind": "a"}]})
        agg.ingest({"events": [{"kind": "b"}, 7]})
        agg.close()
        return sink.read_text(), agg.counts()
    want, got = both(run)
    assert got == want
    assert got[1] == {"r0x": 1, "unknown": 1}


def test_aggregator_malformed_batches_reject_without_writing(tmp_path):
    def run(side):
        s = SIDES[side]
        sink = tmp_path / f"{side}.jsonl"
        reg = s["telemetry"].default_registry()
        agg = s["aggregate"].Aggregator(str(sink), registry=reg)
        out = [agg.ingest(doc) for doc in
               ([1, 2], {"events": "nope"}, {"no": "events"})]
        agg.close()
        return out, sink.exists(), counters(
            side, "deppy_obs_ingest_rejects_total")
    want, got = both(run)
    assert got == want
    assert [n for n, _ in got[0]] == [0, 0, 0] and all(
        e for _, e in got[0])
    assert got[1:] == (False, [3])


# -------------------------------------------------------------- federation


SCRAPE_A = """\
deppy_cache_hits_total 8
deppy_cache_misses_total 2
deppy_incremental_hits_total 1
deppy_sched_queue_depth 3
deppy_tenant_burn_rate{tenant="alpha"} 0.2
deppy_tenant_requests_total{tenant="alpha"} 30
deppy_race_wins_total{backend="device"} 3
"""
SCRAPE_B = """\
deppy_cache_hits_total 2
deppy_cache_misses_total 8
deppy_sched_queue_depth 1
deppy_tenant_burn_rate{tenant="alpha"} 0.6
deppy_tenant_requests_total{tenant="alpha"} 10
deppy_race_wins_total{backend="host"} 1
"""
ROUTE_SCRAPE = "\n".join([
    'deppy_route_regret_seconds_total{size_class="m",backend="device"} 1.5',
    "deppy_route_stale_classes 2",
    'deppy_route_shadow_dispatches_total{backend="host"} 3',
    "deppy_route_learned_rows 1",
])
HEADED_A = ("# HELP deppy_cache_hits_total h\n"
            "# TYPE deppy_cache_hits_total counter\n"
            "deppy_cache_hits_total 8\n"
            "# HELP deppy_solve_seconds s\n"
            "# TYPE deppy_solve_seconds histogram\n"
            'deppy_solve_seconds_bucket{le="0.1"} 1\n'
            'deppy_solve_seconds_bucket{le="+Inf"} 2\n'
            "deppy_solve_seconds_sum 0.3\n"
            "deppy_solve_seconds_count 2\n")
HEADED_B = ("# HELP deppy_cache_hits_total h\n"
            "# TYPE deppy_cache_hits_total counter\n"
            'deppy_cache_hits_total{tenant="t"} 2\n'
            "deppy_sched_queue_depth NaN-ish\n"
            "orphan_sample 4\n")


@pytest.mark.parametrize("scrapes", [
    [("a:1", SCRAPE_A), ("b:2", SCRAPE_B)],
    [("a:1", ROUTE_SCRAPE), ("b:2", ROUTE_SCRAPE)],
    [("a:1", "deppy_queue_depth 0")],
    [("a:1", HEADED_A), ("b:2", HEADED_B), ("c:3", SCRAPE_A + ROUTE_SCRAPE)],
    [],
], ids=["math", "route", "learn-off", "mixed", "empty"])
def test_fleet_rollups_merge_and_render_equal(scrapes):
    def run(side):
        fed = SIDES[side]["federate"]
        roll = fed.fleet_rollups(scrapes)
        return (roll, fed.render_rollup_lines(roll),
                fed.merge_scrapes(scrapes),
                [fed.parse_samples(text) for _, text in scrapes])
    want, got = both(run)
    assert got == want


def test_fleet_rollups_math():
    roll = tfederate.fleet_rollups([("a:1", SCRAPE_A), ("b:2", SCRAPE_B)])
    assert roll["warm_hit_ratio"] == round(11 / 20, 6)
    assert roll["queue_depth"] == 4.0
    assert roll["tenant_burn_rate"]["alpha"] == round(12 / 40, 6)
    assert roll["race_win_share"] == {"device": 0.75, "host": 0.25}
    assert roll["per_replica"]["a:1"]["warm_hit_ratio"] == 0.9


def test_merge_scrapes_relabels_under_replica():
    lines = tfederate.merge_scrapes([
        ("a:1", "# HELP deppy_cache_hits_total h\n"
                "# TYPE deppy_cache_hits_total counter\n"
                "deppy_cache_hits_total 8\n"),
        ("b:2", "# HELP deppy_cache_hits_total h\n"
                "# TYPE deppy_cache_hits_total counter\n"
                'deppy_cache_hits_total{tenant="t"} 2\n')])
    assert lines == [
        "# HELP deppy_cache_hits_total h",
        "# TYPE deppy_cache_hits_total counter",
        'deppy_cache_hits_total{replica="a:1"} 8',
        'deppy_cache_hits_total{replica="b:2",tenant="t"} 2']


def test_route_families_roll_up():
    roll = tfederate.fleet_rollups([("a:1", ROUTE_SCRAPE),
                                    ("b:2", ROUTE_SCRAPE)])
    assert roll["route_regret_s"] == pytest.approx(3.0)
    assert roll["route_stale_classes"] == 4
    assert roll["route_shadow_dispatches"] == 6
    assert roll["route_learned_rows"] == 2


def test_learn_off_fleet_renders_no_route_lines():
    roll = tfederate.fleet_rollups([("a:1", "deppy_queue_depth 0")])
    assert not any("route" in ln
                   for ln in tfederate.render_rollup_lines(roll))


class StubRouter:
    """What ``collect`` and ``render_fleet_metrics`` need of a router:
    the live replicas, one forwarded exchange, its own registry."""

    def __init__(self, replicas, own="deppy_fleet_replicas 3\n"):
        self.replicas = replicas
        self.own = own
        self.forwarded = []

    def live_replicas(self):
        return list(self.replicas)

    def forward(self, address, method, path, body, headers=None,
                timeout=10.0):
        import http.client

        self.forwarded.append((address, method, path))
        host, _, port = address.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read(), dict(resp.getheaders())
        finally:
            conn.close()

    def render_metrics(self):
        return self.own


def _metrics(text):
    return {("GET", "/metrics"): lambda _b: (200, text.encode())}


def test_collect_and_render_fleet_metrics_over_two_replicas():
    """Two stdlib replicas answer ``/metrics``; a third address is dead
    and a fourth answers 500: both are skipped, the scrape degrades."""
    with Served(_metrics(HEADED_A + SCRAPE_A)) as a, \
            Served(_metrics(HEADED_B + ROUTE_SCRAPE)) as b, \
            Served({("GET", "/metrics"): lambda _b: (500, b"x")}) as bad:
        replicas = [a.addr, DEAD, b.addr, bad.addr]

        def run(side):
            fed = SIDES[side]["federate"]
            router = StubRouter(replicas)
            return (fed.collect(router), fed.render_fleet_metrics(router),
                    sorted(router.forwarded))
        want, got = both(run)
    assert got == want
    scrapes, page, _ = got
    assert [addr for addr, _ in scrapes] == [a.addr, b.addr]
    assert page.endswith("deppy_fleet_replicas 3\n")
    assert f'deppy_cache_hits_total{{replica="{a.addr}"}} 8' in page
    assert "deppy_fleet_route_learned_rows 1" in page


# --------------------------------------------------------------------- top


STATUS = {
    "policy": "hash",
    "replicas": [{"replica": "a:1"}, {"replica": "b:2", "drained": True},
                 {"replica": "c:3", "dead": True}],
    "telemetry": {"ingested": {"a:1": 12, "b:2": 3}},
}


def _fleet_page():
    scrapes = [("a:1", SCRAPE_A + 'deppy_costmodel_drift_ratio'
                '{size_class="s"} 1.4\ndeppy_costmodel_drift_ratio'
                '{size_class="m"} 0.9\n' + ROUTE_SCRAPE),
               ("b:2", SCRAPE_B)]
    lines = tfederate.render_rollup_lines(tfederate.fleet_rollups(scrapes))
    lines += tfederate.merge_scrapes(scrapes)
    lines += ['deppy_fleet_tenant_burn_rate{tenant="beta"} 0.125']
    return "\n".join(lines) + "\n"


def test_top_snapshot_render_and_run_once():
    page = _fleet_page()
    routes = {("GET", "/fleet/status"):
              lambda _b: (200, json.dumps(STATUS).encode()),
              ("GET", "/fleet/metrics"): lambda _b: (200, page.encode())}
    with Served(routes) as srv:
        def run(side):
            top = SIDES[side]["top"]
            snap = top.fetch(srv.addr)
            out = io.StringIO()
            rc = top.run(srv.addr, once=True, out=out)
            return (snap, top.snapshot(srv.addr, STATUS, page),
                    top.render_text(snap), rc, out.getvalue())
        want, got = both(run)
    assert got == want
    snap, _, text, rc, out = got
    assert rc == 0 and out == text + "\n"
    assert [r["state"] for r in snap["replicas"]] == ["up", "drained",
                                                      "dead"]
    assert snap["replicas"][0]["drift_ratio"] == 1.4
    assert snap["fleet"]["tenant_burn_rate"]["beta"] == 0.125
    assert "1/3 live" in text


def test_top_run_fails_on_an_unreachable_router(capsys):
    assert (jtop.run(DEAD, once=True), ttop.run(DEAD, once=True)) == (1, 1)
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]


def test_top_render_of_an_empty_fleet():
    want, got = both(lambda side: SIDES[side]["top"].render_text(
        SIDES[side]["top"].snapshot("r:1", {}, "")))
    assert got == want


# ------------------------------------------------------------------ drift


@pytest.mark.parametrize("doc,expect", [
    ({"costmodel": {"us_per_trip": 150.0,
                    "size_classes": {"xs": {"us_per_trip": 90.0}}}},
     {"xs": 90.0, "*": 150.0}),
    ({"trip_overhead": {"us_per_trip": 175.0},
      "size_classes": {"s": {"trips": 1000, "solve_s": 0.2}}},
     {"s": 200.0, "*": 175.0}),
    ({"us_per_trip": 120.0}, {"*": 120.0}),
    ({"size_classes": {"s": {"us_per_trip": -1}, "m": "x",
                       "l": {"trips": 0, "solve_s": 1.0}}}, None),
    ([1, 2], None),
    ("not json", None),
    (None, None),
], ids=["bench", "profile-report", "bare", "no-figure", "list", "junk",
        "missing"])
def test_load_baseline_shapes(tmp_path, doc, expect):
    path = tmp_path / "baseline.json"
    if doc is not None:
        path.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    want, got = both(lambda side: SIDES[side]["drift"].load_baseline(
        str(path)))
    assert got == want == expect
    assert (tobs.start_watchdog(str(path)) is None) == (expect is None)


def _profile_event(cls="xs", trips=100, solve_s=0.01):
    return {"kind": "profile", "backend": "device", "trips": trips,
            "solve_s": solve_s, "size_class_name": cls}


def _drift_run(side, feed, **kw):
    """Feed ``feed`` (a list of events) to a fresh watchdog on a fresh
    registry; the ``costmodel_drift`` events, snapshot and lines after
    each phase."""
    s = SIDES[side]
    reg = s["telemetry"].Registry()
    events = []
    reg.add_forwarder(lambda ev: events.append(ev)
                      if ev.get("kind") == "costmodel_drift" else None)
    dog = s["drift"].CostModelWatchdog(registry=reg, **kw)
    trail = []
    for phase in feed:
        for ev in phase:
            dog(ev)
        trail.append((strip(events), dog.snapshot(),
                      samples(dog.render_metric_lines())))
    return trail


def test_drift_warmup_band_event_and_recovery():
    feed = [[_profile_event(solve_s=5.0)] * tdrift.WARMUP_SAMPLES,
            [_profile_event(solve_s=0.01)] * 4,
            [_profile_event(solve_s=0.03)] * 64,
            [_profile_event(solve_s=0.01)] * 64,
            [_profile_event(solve_s=0.03)] * 64]
    want, got = both(lambda side: _drift_run(
        side, feed, baseline={"xs": 100.0}, band=0.5, min_samples=2,
        replica="r1"))
    assert got == want
    assert (tdrift.WINDOW, tdrift.WARMUP_SAMPLES) == (jdrift.WINDOW,
                                                      jdrift.WARMUP_SAMPLES)
    assert got[0][1] == {}
    assert got[1][1]["xs"]["ratio"] == 1.0 and got[1][0] == []
    events, snap, lines = got[2]
    assert snap["xs"]["drift"] and len(events) == 1
    assert events[0]["replica"] == "r1"
    assert any(ln.startswith(
        'deppy_costmodel_drift_ratio{size_class="xs",replica="r1"}')
        for ln in lines)
    assert not got[3][1]["xs"]["drift"]
    assert len(got[4][0]) == 2


def test_drift_ignores_unbaselined_and_tripless_events():
    feed = [[{"kind": "fault", "point": "x"}, _profile_event(cls="xl"),
             {"kind": "profile", "backend": "host", "solve_s": 0.5}]]
    want, got = both(lambda side: _drift_run(
        side, feed, baseline={"xs": 100.0}, band=0.5, min_samples=2))
    assert got == want == [([], {}, [])]


def test_drift_over_a_recorded_cpu_profile_stream(tmp_path):
    """The port's CPU ``solve_problems``, armed at sample 1.0, records a
    stream of ``profile`` events; its ``summarize`` is the baseline on
    both sides, and both watchdogs read the stream, then the stream with
    every ``solve_s`` tripled, the same."""
    sink = tmp_path / "t.jsonl"
    reg = ttelemetry.default_registry()
    reg.configure_sink(str(sink))
    recorded = []
    reg.add_forwarder(lambda e: recorded.append(e)
                      if e.get("kind") == "profile" else None)
    with tprofile.override("on", 1.0):
        for seed in range(12):
            tdriver.solve_problems(
                [encode(random_instance(length=12, seed=seed + k))
                 for k in range(4)], device="cpu")
    reg.configure_sink(None)
    assert len(recorded) == 12 and all(e["trips"] for e in recorded)
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps(treport.summarize(str(sink))))
    slow = [dict(e, solve_s=e["solve_s"] * 3) for e in recorded]
    feed = [recorded, slow, recorded]

    def run(side):
        baseline = SIDES[side]["drift"].load_baseline(str(base))
        return baseline, _drift_run(side, feed, baseline=baseline,
                                    band=0.5, min_samples=8)
    want, got = both(run)
    assert got == want
    baseline, trail = got
    (cls,) = set(baseline) - {"*"}
    assert trail[0][0] == [] and not trail[0][1][cls]["drift"]
    assert len(trail[1][0]) == 1 and trail[1][1][cls]["drift"]


def test_process_watchdog_and_render_metric_lines(tmp_path):
    """Disarmed renders exactly ``[]``; the process streamer and watchdog
    render the same lines on both packages; ``stop_all`` detaches."""
    base = tmp_path / "b.json"
    base.write_text(json.dumps({"us_per_trip": 100.0}))

    def run(side):
        s = SIDES[side]
        reg = s["telemetry"].default_registry()
        trail = [s["obs"].render_metric_lines()]
        dog = s["obs"].start_watchdog(str(base), replica="r0")
        st = s["obs"].start_streamer(DEAD, replica="r0", flush_ms=10_000)
        for _ in range(12):
            reg.event("profile", trips=100, solve_s=0.02,
                      size_class_name="s")
        trail.append(samples(s["obs"].render_metric_lines()))
        trail.append((dog.snapshot(), st.queue_depth() > 0))
        s["obs"].stop_all()
        trail.append(s["obs"].render_metric_lines())
        return trail
    want, got = both(run)
    assert got == want
    assert got[0] == [] and got[-1] == []
    assert got[2][0]["s"]["ratio"] == 2.0


# ------------------------------------------------------- multi-sink merge


def test_merged_sinks_dedupe_dump_copies_by_replica_and_seq(tmp_path):
    a = tmp_path / "a.jsonl"
    b = tmp_path / "b.jsonl"
    fault = {"kind": "fault", "trace_id": "t1", "seq": 7, "replica": "rep0"}
    span = {"kind": "span", "name": "s", "trace_id": "t1",
            "span_id": "sp1", "replica": "rep0"}
    other = {"kind": "fault", "trace_id": "t1", "seq": 7, "replica": "rep1"}
    a.write_text("\n".join(json.dumps(e) for e in (fault, span)) + "\n")
    b.write_text("\n".join(json.dumps(e)
                           for e in (fault, span, other)) + "\n")
    want, got = both(lambda side: list(
        SIDES[side]["telemetry"].iter_merged_sink_events([str(a), str(b)])))
    assert got == want == [fault, span, other]


# ------------------------------------------------- the gossip leg's half


def test_route_learned_reaches_the_aggregator_stamped(tmp_path):
    """Each package's online route registry adopts a row on the default
    registry; its ``route_learned`` event reaches a stub aggregator
    through the process streamer, stamped with the streamer's
    replica."""
    class _Ledger:
        def estimates(self):
            return {"m": {"host": {"us_per_lane": 50.0, "samples": 4},
                          "device": {"us_per_lane": 900.0, "samples": 4}}}

    def run(side):
        s = SIDES[side]
        sink = tmp_path / f"{side}.jsonl"
        agg = s["aggregate"].Aggregator(str(sink))

        def ingest(body):
            agg.ingest(json.loads(body))
            return 200, b"{}"

        with Served({("POST", "/fleet/telemetry"): ingest}) as srv:
            s["obs"].start_streamer(srv.addr, replica="r0", flush_ms=5)
            learner = s["learner"](_Ledger(), min_samples=2,
                                   platform="cpu")
            row = learner.consider("m")
            s["obs"].stop_all()
        agg.close()
        events = [json.loads(ln) for ln in sink.read_text().splitlines()]
        return row, strip(e for e in events if e["kind"] == "route_learned")
    want, got = both(run)
    assert got == want
    row, learned = got
    assert row == "host,device"
    assert len(learned) == 1 and learned[0]["replica"] == "r0"
    assert learned[0]["key"] == "portfolio.m"


# ------------------------------------------------------------------ knobs


KNOB_VALUES = ["7", " 12 ", "", "   ", "abc", "1.5", "-3", "0", "1e3",
               "nan"]


@pytest.mark.parametrize("value", KNOB_VALUES,
                         ids=[repr(v) for v in KNOB_VALUES])
@pytest.mark.parametrize("name", KNOBS)
def test_knobs_read_as_the_reference_reads_its_own(monkeypatch, name,
                                                   value):
    def run(side):
        s = SIDES[side]
        monkeypatch.setenv(s["prefix"] + name, value)
        st = s["stream"].TelemetryStreamer(
            DEAD, registry=s["telemetry"].Registry())
        dog = s["drift"].CostModelWatchdog(
            {"*": 1.0}, registry=s["telemetry"].Registry())
        return [st._cap, st._batch, st._flush_s, st._backoff_max_s,
                dog.band, dog.min_samples]
    want, got = both(run)
    assert json.dumps(got) == json.dumps(want)


def test_knob_defaults():
    st = tstream.TelemetryStreamer(DEAD)
    dog = tdrift.CostModelWatchdog({"*": 1.0})
    assert (st._cap, st._batch, st._flush_s, st._backoff_max_s) == \
        (4096, 256, 0.2, 5.0)
    assert (dog.band, dog.min_samples) == (0.5, 8)
