"""The port's service against the JAX package's, over HTTP on the CPU.

``deppy_tpu.service.Server`` beside ``deppy_tpu_torch.service.Server``:
the same documents and headers go to both, and the status,
``Content-Type``, ``Retry-After`` and body bytes must be equal.  The
pairs are the reference's ``backend="host"`` against the port's
``backend="host"``, and, on three small shapes, the reference's
``backend="tpu"`` (CPU XLA) against the port's ``backend="device",
device="cpu"`` (the kernels' plain versions).  ``/metrics`` is compared
by family names and by every sample that does not measure time.

The cases mirror the reference's own server tests: ``tests/test_service.py``;
``tests/test_faults.py::TestServiceFaultSurface``; the ``Server`` cases of
``tests/test_sched.py``, ``tests/test_trace.py`` and
``tests/test_telemetry.py``; ``tests/test_sessions.py::TestService``;
``tests/test_optimize.py::TestServiceSurface``;
``tests/test_speculate.py::TestServiceEndpoints``; the three ``Server``
cases of ``tests/test_profile.py``; the server-armed streamer of
``tests/test_obs.py``; the server half of fleet join and drain against a
stub router; and a reference server's warm state carried to a port
server through ``/debug/warmstate``.

Every server and stub is shut down in a ``finally`` (or by the pair's
context manager), and every wait is bounded.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import namedtuple
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from deppy_tpu import faults as jfaults
from deppy_tpu import profile as jprofile
from deppy_tpu import service as jservice
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.resolution import facade as jfacade
from deppy_tpu.sat import solver as jsolver
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import obs as tobs
from deppy_tpu_torch import profile as tprofile
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch import service as tservice
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import defaults as tstore
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.resolution import facade as tfacade
from deppy_tpu_torch.sat import solver as tsolver
from deppy_tpu_torch.sat.encode import encode
from deppy_tpu_torch.speculate import PublishDelta

ROOT = Path(__file__).resolve().parents[1]

SIDES = {
    "reference": dict(service=jservice, faults=jfaults,
                      telemetry=jtelemetry, solver=jsolver,
                      profile=jprofile, driver=jdriver, facade=jfacade,
                      backend={"host": "host", "device": "tpu",
                               "auto": "auto"},
                      extra={}, prefix="DEPPY_TPU_"),
    "port": dict(service=tservice, faults=tfaults, telemetry=ttelemetry,
                 solver=tsolver, profile=tprofile, driver=tdriver,
                 facade=tfacade,
                 backend={"host": "host", "device": "device",
                          "auto": "auto"},
                 extra={"device": "cpu"}, prefix="DEPPY_GPU_"),
}

Resp = namedtuple("Resp", "status ctype retry_after body headers")


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    """Each package's breaker, fault plan, default registry and flight
    recorder per test; host lanes inline; no measured rows on either
    side (an empty registry file: a row another test file left in a
    reader's cache would make one side's route plane see a stale
    class); the reference's escalation off, as the port's is by
    default; no engine verdict on either side (one another test file
    left in the reference's cache would add ``deppy_auto_engine_usable``
    to its scrape only), each restored afterwards."""
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "0")
    monkeypatch.setenv("DEPPY_TPU_HOST_WORKERS", "0")
    rows = str(tmp_path / "no-rows.json")
    monkeypatch.setenv("DEPPY_TPU_MEASURED_DEFAULTS", rows)
    monkeypatch.setattr(jcore, "_MEASURED_DEFAULTS_PATH", rows)
    monkeypatch.setattr(jcore, "_MEASURED_DEFAULTS", None)
    monkeypatch.setenv("DEPPY_GPU_MEASURED_DEFAULTS", rows)
    tstore.reload_measured_defaults()
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    monkeypatch.setattr(jsolver, "_ENGINE_USABLE", None)
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {})
    prev = []
    for side in SIDES.values():
        f, t = side["faults"], side["telemetry"]
        prev.append((f.set_default_breaker(f.CircuitBreaker()),
                     f.configure_plan(None),
                     t.set_default_registry(t.Registry()),
                     t.trace.set_default_recorder(t.trace.FlightRecorder())))
    yield
    for side, (breaker, plan, reg, rec) in zip(SIDES.values(), prev):
        f, t = side["faults"], side["telemetry"]
        t.trace.set_default_recorder(rec)
        t.set_default_registry(reg)
        f.configure_plan(plan)
        f.set_default_breaker(breaker)


# ---------------------------------------------------------------- helpers


def request(port, method, path, body=None, headers=None, raw=None) -> Resp:
    """One HTTP exchange; ``raw`` sends those bytes as the body."""
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    h = dict(headers or {})
    if body is not None or raw is not None:
        h.setdefault("Content-Type", "application/json")
    payload = raw if raw is not None else (
        json.dumps(body) if body is not None else None)
    try:
        conn.request(method, path, body=payload, headers=h)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return Resp(resp.status, resp.getheader("Content-Type"),
                resp.getheader("Retry-After"), data, dict(resp.getheaders()))


def _server(side: str, backend: str = "host", start: bool = True, **kw):
    s = SIDES[side]
    srv = s["service"].Server(
        bind_address=kw.pop("bind_address", "127.0.0.1:0"),
        probe_address=kw.pop("probe_address", "127.0.0.1:0"),
        backend=s["backend"][backend], **s["extra"], **kw)
    if start:
        srv.start()
    return srv


class Pair:
    """A reference server and a port server built from the same
    arguments (``ref=``/``port=`` add per-side ones)."""

    def __init__(self, backend="host", ref=None, port=None, start=True,
                 **kw):
        self.srv = {}
        try:
            for side, own in (("reference", ref), ("port", port)):
                self.srv[side] = _server(side, backend, start=start,
                                         **dict(kw, **(own or {})))
        except BaseException:
            self.close()
            raise

    @property
    def ref(self):
        return self.srv["reference"]

    @property
    def port(self):
        return self.srv["port"]

    def call(self, method, path, body=None, headers=None, raw=None,
             probe=False) -> dict:
        return {side: request(srv.probe_port if probe else srv.api_port,
                              method, path, body, headers, raw)
                for side, srv in self.srv.items()}

    def same(self, method, path, body=None, headers=None, raw=None,
             probe=False) -> Resp:
        """Send to both; status, Content-Type, Retry-After and body
        bytes equal.  Returns the port's response."""
        out = self.call(method, path, body, headers, raw, probe)
        r, p = out["reference"], out["port"]
        assert (p.status, p.ctype, p.retry_after, _untimed(p)) == \
            (r.status, r.ctype, r.retry_after, _untimed(r)), (path, r, p)
        return p

    def metrics(self) -> dict:
        return {side: request(srv.api_port, "GET", "/metrics").body.decode()
                for side, srv in self.srv.items()}

    def same_metrics(self) -> str:
        """Family names and every time-free sample equal; the port's
        scrape."""
        m = self.metrics()
        assert _families(m["port"]) == _families(m["reference"])
        assert _timeless(m["port"]) == _timeless(m["reference"])
        return m["port"]

    def close(self):
        for srv in self.srv.values():
            srv.shutdown()


@contextlib.contextmanager
def pair(*args, **kw):
    p = Pair(*args, **kw)
    try:
        yield p
    finally:
        p.close()


def _untimed(r: Resp) -> bytes:
    """The body, with a breaker's ``retry_after_s`` (the cooldown left,
    read a few microseconds apart on the two servers) to the second the
    ``Retry-After`` header carries."""
    if r.status == 503 and b"breaker open" in r.body:
        doc = json.loads(r.body)
        doc["retry_after_s"] = round(doc["retry_after_s"])
        return json.dumps(doc).encode()
    return r.body


def _families(text: str) -> list:
    return [line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")]


def _samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = value
    return out


def _timeless(text: str) -> dict:
    """The samples that measure no time (a seconds family's counts
    stay), nor a latency percentile, its burn rate or the requests past
    the latency target."""
    out = {}
    for name, value in _samples(text).items():
        base = name.split("{")[0]
        if ("seconds" in base or "p99" in base or "burn_rate" in base
                or "slo_violations" in base) \
                and not base.endswith("_count"):
            continue
        out[name] = value
    return out


def _metric(text: str, name: str):
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[1])
    return None


def _doc(i, dep=("b", "c")):
    return {"variables": [
        {"id": f"a{i}", "constraints": [
            {"type": "mandatory"},
            {"type": "dependency", "ids": list(dep)}]},
        {"id": dep[0]}, {"id": dep[1]},
    ]}


SAT = {"variables": [
    {"id": "a", "constraints": [
        {"type": "mandatory"}, {"type": "dependency", "ids": ["b", "c"]}]},
    {"id": "b"}, {"id": "c"}]}
MIXED = {"problems": [
    {"variables": [{"id": "a", "constraints": [{"type": "mandatory"}]}]},
    {"variables": [{"id": "b", "constraints": [
        {"type": "mandatory"}, {"type": "prohibited"}]}]}]}
ONE = {"variables": [{"id": "a", "constraints": [{"type": "mandatory"}]}]}
HARD = {"variables": [
    {"id": "x", "constraints": [
        {"type": "mandatory"}, {"type": "dependency", "ids": ["y", "z"]}]},
    {"id": "y", "constraints": [{"type": "dependency", "ids": ["w"]}]},
    {"id": "z"},
    {"id": "w", "constraints": [{"type": "conflict", "id": "z"}]}]}
UNSAT = {"variables": [{"id": "u", "constraints": [
    {"type": "mandatory"}, {"type": "prohibited"}]}]}
STEPS = {"variables": [
    {"id": "a", "constraints": [
        {"type": "mandatory"}, {"type": "dependency", "ids": ["b", "c"]}]},
    {"id": "b", "constraints": [{"type": "conflict", "id": "d"}]},
    {"id": "c", "constraints": [{"type": "dependency", "ids": ["d"]}]},
    {"id": "d"}]}


def _wait(cond, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return bool(cond())


# ----------------------------------------------- tests/test_service.py


class TestProbes:
    @pytest.mark.parametrize("path", ["/healthz", "/readyz", "/other"])
    def test_probe_paths(self, path):
        with pair() as p:
            r = p.same("GET", path, probe=True)
            assert r.status == (404 if path == "/other" else 200)
            if r.status == 200:
                assert r.body == b"ok"

    def test_readyz_not_ready_after_shutdown_flag(self):
        with pair() as p:
            for srv in p.srv.values():
                srv.ready.clear()
            assert p.same("GET", "/readyz", probe=True).status == 503


class TestResolveAPI:
    @pytest.mark.parametrize("doc", [SAT, MIXED, UNSAT, HARD],
                             ids=["sat", "mixed", "unsat", "hard"])
    def test_resolve(self, doc):
        with pair() as p:
            r = p.same("POST", "/v1/resolve", doc)
            assert r.status == 200
            out = json.loads(r.body)["results"]
            if doc is SAT:
                assert out[0]["selected"] == ["a", "b"]
            if doc is MIXED:
                assert [x["status"] for x in out] == ["sat", "unsat"]
                assert out[1]["conflicts"] == ["b is mandatory",
                                               "b is prohibited"]
            p.same_metrics()

    @pytest.mark.parametrize("raw", [
        json.dumps({"variables": "nope"}), "{nope", json.dumps([1, 2])],
        ids=["malformed", "invalid-json", "not-a-document"])
    def test_bad_bodies_400(self, raw):
        with pair() as p:
            r = p.same("POST", "/v1/resolve", raw=raw)
            assert r.status == 400 and "error" in json.loads(r.body)
            assert _metric(p.same_metrics(),
                           "deppy_request_errors_total") == 1

    def test_unknown_path(self):
        with pair() as p:
            assert p.same("POST", "/other", {}).status == 404
            assert p.same("GET", "/other").status == 404

    def test_oversized_body_rejected_413(self):
        with pair(max_body_bytes=64) as p:
            r = p.same("POST", "/v1/resolve",
                       {"variables": [{"id": "x" * 200}]})
            assert r.status == 413 and b"exceeds" in r.body
            assert "deppy_request_errors_total 1" in p.same_metrics()

    def test_negative_content_length_rejected_400(self):
        with pair() as p:
            got = {}
            for side, srv in p.srv.items():
                conn = HTTPConnection("127.0.0.1", srv.api_port, timeout=10)
                try:
                    conn.putrequest("POST", "/v1/resolve")
                    conn.putheader("Content-Type", "application/json")
                    conn.putheader("Content-Length", "-5")
                    conn.endheaders()
                    resp = conn.getresponse()
                    got[side] = (resp.status, resp.read())
                finally:
                    conn.close()
            assert got["port"] == got["reference"]
            assert got["port"][0] == 400
            assert b"Content-Length" in got["port"][1]


class TestMetrics:
    def test_counters_advance(self):
        with pair() as p:
            p.same("POST", "/v1/resolve", MIXED)
            p.same("POST", "/v1/resolve", {"variables": "nope"})
            text = p.same_metrics()
            assert 'deppy_resolutions_total{outcome="sat"} 1' in text
            assert 'deppy_resolutions_total{outcome="unsat"} 1' in text
            assert "deppy_batches_total 1" in text
            assert "deppy_request_errors_total 1" in text

    def test_render_format(self):
        texts = {}
        for side, s in SIDES.items():
            m = s["service"].Metrics(engine_usable_probe=None)
            m.observe_batch({"sat": 3}, 0.5, steps=42)
            texts[side] = m.render()
            assert "# TYPE deppy_resolutions_total counter" in texts[side]
            assert "deppy_engine_steps_total 42" in texts[side]
        assert texts["port"] == texts["reference"]

    def test_engine_steps_metric_advances(self):
        with pair() as p:
            p.same("POST", "/v1/resolve", STEPS)
            text = p.same_metrics()
            assert _metric(text, "deppy_engine_steps_total") > 0


@pytest.mark.parametrize("addr,want", [
    (":8080", ("", 8080)), ("127.0.0.1:0", ("127.0.0.1", 0)),
    ("9090", ("", 9090)), ("[::1]:8080", ("::1", 8080)),
    ("localhost", "invalid listen address"), ("::1", "bracket IPv6")])
def test_parse_addr(addr, want):
    for side in SIDES.values():
        if isinstance(want, tuple):
            assert side["service"]._parse_addr(addr) == want
        else:
            with pytest.raises(ValueError, match=want):
                side["service"]._parse_addr(addr)


def test_dual_stack_default_bind():
    with pair(bind_address=":0", probe_address=":0") as p:
        r = p.same("GET", "/healthz", probe=True)
        assert (r.status, r.body) == (200, b"ok")


def test_ipv6_bind():
    try:
        p = Pair(bind_address="[::1]:0", probe_address="[::1]:0")
    except OSError:
        pytest.skip("IPv6 loopback unavailable")
    try:
        for srv in p.srv.values():
            conn = HTTPConnection("::1", srv.probe_port, timeout=10)
            try:
                conn.request("GET", "/healthz")
                assert conn.getresponse().status == 200
            finally:
                conn.close()
    finally:
        p.close()


def test_internal_error_returns_500():
    with pair() as p:
        for srv in p.srv.values():
            srv.resolve_document = lambda doc, **kw: (_ for _ in ()).throw(
                RuntimeError("boom"))
        r = p.same("POST", "/v1/resolve", {"variables": []})
        assert r.status == 500
        assert "internal error" in json.loads(r.body)["error"]
        for srv in p.srv.values():
            del srv.resolve_document
        assert "deppy_request_errors_total 1" in p.same_metrics()


def test_incomplete_counted_per_problem():
    with pair(max_steps=3) as p:
        r = p.same("POST", "/v1/resolve", {"problems": [ONE, HARD]})
        out = json.loads(r.body)["results"]
        assert [x["status"] for x in out] == ["sat", "incomplete"]
        text = p.same_metrics()
        assert 'deppy_resolutions_total{outcome="sat"} 1' in text
        assert 'deppy_resolutions_total{outcome="incomplete"} 1' in text


@pytest.mark.parametrize("side", sorted(SIDES))
def test_probe_port_conflict_does_not_leak_api_socket(side):
    srv = _server(side, start=False)
    try:
        with pytest.raises(OSError):
            _server(side, start=False,
                    probe_address=f"127.0.0.1:{srv.api_port}")
        _server(side, start=False).shutdown()
    finally:
        srv.shutdown()


def test_serve_exits_cleanly_on_sigterm():
    """``serve()`` in a subprocess on the CPU: the banner, one request,
    then SIGTERM drains and exits 0; jax and deppy_tpu never load."""
    code = (
        "import sys, atexit\n"
        "from deppy_tpu_torch.service import serve\n"
        "def check():\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in ('jax', 'deppy_tpu'))\n"
        "    print('modules', bad, flush=True)\n"
        "atexit.register(check)\n"
        "serve(bind_address='127.0.0.1:0', probe_address='127.0.0.1:0',"
        " device='cpu')\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "DEPPY_GPU_HOST_WORKERS": "0"})
    try:
        line = proc.stdout.readline()
        assert "deppy service listening on :" in line, line
        api = int(line.split(":")[1].split()[0])
        r = request(api, "POST", "/v1/resolve", SAT)
        assert r.status == 200
        assert json.loads(r.body)["results"][0]["selected"] == ["a", "b"]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        rest = proc.stdout.read()
        assert rc == 0, rest
        assert "modules []" in rest, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_auto_routing_upgrades_when_the_card_recovers(monkeypatch):
    """The pre-warm loop of an ``auto`` server re-probes every
    ``DEPPY_GPU_REPROBE`` seconds and flips the cached verdict of its
    device type when the engine comes back."""
    verdicts = iter([False, False, True])
    monkeypatch.setattr(tsolver, "_probe_verdict",
                        lambda kind: next(verdicts))
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {})
    monkeypatch.setenv("DEPPY_GPU_REPROBE", "0.05")
    srv = _server("port", "auto", portfolio="off")
    try:
        assert _wait(lambda: tsolver._ENGINE_USABLE.get("cpu") is True)
    finally:
        srv.shutdown()


def test_reprobe_engine_replaces_cached_verdict(monkeypatch):
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {"cpu": False})
    monkeypatch.setattr(tsolver, "_probe_verdict", lambda kind: True)
    assert tsolver.reprobe_engine(device="cpu") is True
    assert tsolver._ENGINE_USABLE["cpu"] is True
    monkeypatch.setattr(tsolver, "_probe_verdict", lambda kind: False)
    assert tsolver.reprobe_engine(device="cpu") is False
    assert tsolver._ENGINE_USABLE["cpu"] is False


def test_stale_verdict_readable_during_reprobe(monkeypatch):
    probing, release = threading.Event(), threading.Event()

    def slow_probe(kind):
        probing.set()
        assert release.wait(10)
        return True

    monkeypatch.setattr(tsolver, "_probe_verdict", slow_probe)
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {"cpu": False})
    t = threading.Thread(target=tsolver.reprobe_engine, args=("cpu",),
                         daemon=True)
    t.start()
    try:
        assert probing.wait(10)
        assert tsolver._engine_usable("cpu") is False
    finally:
        release.set()
        t.join(10)
    assert tsolver._ENGINE_USABLE["cpu"] is True


def test_metrics_expose_auto_routing_verdict(monkeypatch):
    """The gauge follows the verdict of the server's own device type,
    as the reference's follows its one verdict."""
    with pair() as p:
        for ref, port in ((None, {}), (False, {"cpu": False}),
                          (True, {"cpu": True, "cuda": False})):
            monkeypatch.setattr(jsolver, "_ENGINE_USABLE", ref)
            monkeypatch.setattr(tsolver, "_ENGINE_USABLE", port)
            text = p.same_metrics()
            if ref is None:
                assert "deppy_auto_engine_usable" not in text
            else:
                assert f"deppy_auto_engine_usable {int(ref)}" in text
    # A cuda server reads the cuda verdict only.
    monkeypatch.setattr(tsolver, "_ENGINE_USABLE", {"cpu": True})
    m = tservice.Metrics(
        engine_usable_probe=lambda: tservice._default_engine_probe("cuda"))
    assert "deppy_auto_engine_usable" not in m.render()


def test_non_numeric_reprobe_env_falls_back(monkeypatch, capsys):
    for side, s in SIDES.items():
        monkeypatch.setenv(s["prefix"] + "REPROBE", "ten-minutes")
    for side in SIDES:
        srv = _server(side, start=False)
        try:
            assert srv._reprobe_s == 600.0
        finally:
            srv.shutdown()
    err = capsys.readouterr().err
    assert "non-numeric DEPPY_GPU_REPROBE='ten-minutes'; using 600" in err


def test_port_only_arguments():
    """``mesh_devices`` reaches the scheduler, which sizes its mesh lazily
    over the distinct devices of the server's type (service.py:253, 369):
    the CPU is one device, so it serves single-device, as the reference
    does under two devices.  A backend name the port does not serve (the
    reference's ``tpu`` too) raises."""
    srv = _server("port", start=False, mesh_devices=2)
    try:
        assert srv.scheduler._mesh_devices == 2
        assert srv.scheduler._resolve_mesh() is None
    finally:
        srv.shutdown()
    with pytest.raises(tsat.errors.InternalSolverError):
        tservice.Server(bind_address="127.0.0.1:0",
                        probe_address="127.0.0.1:0", backend="tpu",
                        device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_default_server_needs_the_card():
    """``Server()`` serves on ``cuda`` with the device backend: with no
    card a resolve is a counted 500, never a silent CPU answer."""
    srv = tservice.Server(bind_address="127.0.0.1:0",
                          probe_address="127.0.0.1:0")
    srv.start()
    try:
        assert (srv.backend, srv.device) == ("device", "cuda")
        assert (srv.scheduler.backend, srv.scheduler.device) == \
            ("device", "cuda")
        r = request(srv.api_port, "POST", "/v1/resolve", SAT)
        assert r.status == 500 and b"cuda" in r.body
        text = request(srv.api_port, "GET", "/metrics").body.decode()
        assert _metric(text, "deppy_request_errors_total") == 1
        assert _metric(text, "deppy_fault_host_routed_total") == 0
    finally:
        srv.shutdown()


# --------------------------- tests/test_faults.py::TestServiceFaultSurface


class TestServiceFaultSurface:
    def test_metrics_expose_fault_families(self):
        with pair() as p:
            text = p.same_metrics()
            assert "deppy_breaker_state 0" in text
            assert "deppy_fault_retries 0" in text
            assert "deppy_deadline_exceeded 0" in text
            for family in ("deppy_breaker_transitions_total",
                           "deppy_fault_failures_total",
                           "deppy_fault_host_routed_total",
                           "deppy_faults_injected_total"):
                assert f"# TYPE {family} counter" in text, family
            ref = jfaults.render_metric_lines()
            assert tfaults.render_metric_lines() == ref

    def _trip(self):
        for side in SIDES.values():
            br = side["faults"].CircuitBreaker(failure_threshold=1,
                                               reset_after_s=60)
            side["faults"].set_default_breaker(br)
            br.record_failure()

    def test_metrics_reflect_open_breaker(self):
        with pair() as p:
            self._trip()
            assert "deppy_breaker_state 2" in p.same_metrics()

    def test_spent_deadline_rejected_503_retry_after(self):
        with pair() as p:
            r = p.same("POST", "/v1/resolve", ONE,
                       {"X-Deppy-Deadline-S": "0"})
            assert r.status == 503 and "deadline" in json.loads(
                r.body)["error"]
            assert int(r.retry_after) >= 1
            text = p.same_metrics()
            assert _metric(text, "deppy_deadline_exceeded") >= 1

    @pytest.mark.parametrize("value", ["soon", "nan", "inf"])
    def test_invalid_deadline_header_400(self, value):
        with pair() as p:
            r = p.same("POST", "/v1/resolve", ONE,
                       {"X-Deppy-Deadline-S": value})
            assert r.status == 400 and b"X-Deppy-Deadline-S" in r.body

    def test_generous_deadline_resolves(self):
        with pair() as p:
            r = p.same("POST", "/v1/resolve", ONE,
                       {"X-Deppy-Deadline-S": "30"})
            assert json.loads(r.body)["results"][0]["status"] == "sat"

    def test_device_backend_with_open_breaker_503(self):
        """The reference's ``tpu`` server and the port's ``device`` one
        shed the same 503 while the breaker is open."""
        self._trip()
        with pair("device", portfolio="off") as p:
            r = p.same("POST", "/v1/resolve", ONE)
            assert r.status == 503 and r.retry_after is not None
            assert b"accelerator breaker open" in r.body

    def test_auto_backend_with_open_breaker_drains_on_host(self):
        self._trip()
        with pair("auto", portfolio="off") as p:
            r = p.same("POST", "/v1/resolve", MIXED)
            assert r.status == 200

    def test_readyz_flags_degraded_mode(self):
        with pair() as p:
            r = p.same("GET", "/readyz", probe=True)
            assert (r.status, r.body) == (200, b"ok")
            self._trip()
            r = p.same("GET", "/readyz", probe=True)
            assert (r.status, r.body) == (
                200, b"ok (degraded: accelerator breaker open)")

    def test_service_resolve_fault_is_a_counted_500(self):
        with pair() as p:
            for side in SIDES.values():
                side["faults"].configure_plan(side["faults"].plan_from_spec(
                    '[{"point": "service.resolve", "times": 1}]'))
            r = p.same("POST", "/v1/resolve", ONE)
            assert r.status == 500
            assert b"injected fault at service.resolve" in r.body
            text = p.same_metrics()
            assert _metric(text, "deppy_request_errors_total") == 1
            assert 'deppy_faults_injected_total{point="service.resolve"} 1' \
                in text
            assert p.same("POST", "/v1/resolve", ONE).status == 200

    @pytest.mark.parametrize("side", sorted(SIDES))
    def test_graceful_shutdown_drains_inflight_requests(self, side):
        srv = _server(side, drain_s=10.0)
        f = SIDES[side]["faults"]
        f.configure_plan(f.plan_from_spec(
            '[{"point": "service.resolve", "kind": "latency",'
            ' "latency_s": 0.3, "times": 1}]'))
        result = {}
        th = threading.Thread(target=lambda: result.update(
            r=request(srv.api_port, "POST", "/v1/resolve", ONE)))
        try:
            th.start()
            assert _wait(lambda: srv._inflight == 1, 5)
        finally:
            srv.shutdown()
            th.join(10)
        assert result["r"].status == 200
        assert json.loads(result["r"].body)["results"][0]["status"] == "sat"

    @pytest.mark.parametrize("side", sorted(SIDES))
    def test_shutdown_drain_is_bounded(self, side):
        srv = _server(side, drain_s=0.05)
        f = SIDES[side]["faults"]
        f.configure_plan(f.plan_from_spec(
            '[{"point": "service.resolve", "kind": "latency",'
            ' "latency_s": 1.0, "times": 1}]'))
        th = threading.Thread(target=lambda: request(
            srv.api_port, "POST", "/v1/resolve", ONE))
        try:
            th.start()
            assert _wait(lambda: srv._inflight == 1, 5)
        finally:
            t0 = time.monotonic()
            srv.shutdown()
            took = time.monotonic() - t0
            th.join(10)
        assert took < 2.0

    @pytest.mark.parametrize("value,want", [
        ("12.5", (12.5, 12.5)), ("bogus", (None, 10.0)), (None, (None, 10.0))])
    def test_request_deadline_and_drain_knobs(self, monkeypatch, capsys,
                                              value, want):
        for s in SIDES.values():
            if value is None:
                monkeypatch.delenv(s["prefix"] + "REQUEST_DEADLINE_S",
                                   raising=False)
            else:
                monkeypatch.setenv(s["prefix"] + "REQUEST_DEADLINE_S", value)
        got = {}
        for side in SIDES:
            srv = _server(side, start=False)
            try:
                got[side] = (srv.request_deadline_s, srv._drain_s)
            finally:
                srv.shutdown()
        assert got["port"] == got["reference"] == want
        if value == "bogus":
            assert "ignoring non-numeric DEPPY_GPU_REQUEST_DEADLINE_S" in \
                capsys.readouterr().err


# ------------------------------------------ tests/test_sched.py's Server


class TestScheduledServer:
    def test_concurrent_requests_coalesce_and_match_unscheduled(self):
        n = 8
        docs = [_doc(i) for i in range(n)]
        with pair(sched_max_wait_ms=300.0) as p, pair(sched="off") as plain:
            assert plain.port.scheduler is None
            scheduled = [None] * n

            def go(i):
                scheduled[i] = request(p.port.api_port, "POST",
                                       "/v1/resolve", docs[i])

            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            flat = [plain.same("POST", "/v1/resolve", d) for d in docs]
            assert [s.status for s in scheduled] == [200] * n
            assert [s.body for s in scheduled] == [f.body for f in flat]
            text = request(p.port.api_port, "GET", "/metrics").body.decode()
            dispatches = _metric(text, "deppy_sched_dispatches_total")
            assert dispatches is not None and dispatches < n
            assert _metric(text, "deppy_cache_misses_total") == n
            again = request(p.port.api_port, "POST", "/v1/resolve", docs[0])
            assert again.body == scheduled[0].body
            text = request(p.port.api_port, "GET", "/metrics").body.decode()
            assert _metric(text, "deppy_sched_dispatches_total") == dispatches
            assert _metric(text, "deppy_cache_hits_total") == 1

    def test_unsat_and_incomplete_byte_identical(self):
        with pair(max_steps=3) as p, pair(max_steps=3, sched="off") as plain:
            for doc in (UNSAT, HARD, {"problems": [UNSAT, HARD]}):
                assert p.same("POST", "/v1/resolve", doc).body == \
                    plain.same("POST", "/v1/resolve", doc).body

    @pytest.mark.parametrize("doc", [
        {"variables": [{"id": "a", "constraints": [
            {"type": "mandatory"},
            {"type": "dependency", "ids": ["ghost"]}]}]},
        {"variables": [{"id": "a"}, {"id": "a"}]}],
        ids=["unknown-reference", "duplicate"])
    def test_malformed_and_unknown_reference(self, doc):
        with pair() as p, pair(sched="off") as plain:
            r = p.same("POST", "/v1/resolve", doc)
            assert r.status == 400
            assert plain.same("POST", "/v1/resolve", doc).body == r.body

    def test_queue_over_depth_feeds_503_retry_after(self):
        with pair(start=False) as p:
            for srv in p.srv.values():
                srv.scheduler.max_depth = 1
                srv.scheduler._depth = 5
                srv.scheduler._tenant_depth["default"] = 5
                srv.start()
            try:
                r = p.same("POST", "/v1/resolve", {"variables": [{"id": "a"}]})
                assert r.status == 503
                doc = json.loads(r.body)
                assert "overloaded" in doc["error"]
                assert doc["retry_after_s"] >= 1.0
            finally:
                for srv in p.srv.values():
                    srv.scheduler._depth = 0
                    srv.scheduler._tenant_depth.clear()
            assert p.same("POST", "/v1/resolve",
                          {"variables": [{"id": "a"}]}).status == 200

    def test_scheduler_metrics_exposed_on_scrape(self):
        with pair() as p:
            p.same("POST", "/v1/resolve", {"variables": [{"id": "a"}]})
            text = p.same_metrics()
            for family in ("deppy_sched_queue_depth",
                           "deppy_sched_coalesced_batch_size_bucket",
                           "deppy_cache_hit_ratio", "deppy_cache_hits_total",
                           "deppy_cache_misses_total",
                           "deppy_cache_evictions_total"):
                assert family in text, family


class TestDeviceBackend:
    """The reference's ``tpu`` server on CPU XLA against the port's
    ``device`` server on the plain versions, on three small shapes."""

    def test_device_backend_through_scheduler(self):
        n = 4
        with pair("device", sched_max_wait_ms=200.0, portfolio="off",
                  incremental="off", speculate="off") as p:
            got = {}
            for side, srv in p.srv.items():
                results = [None] * n

                def go(i, results=results, srv=srv):
                    results[i] = request(srv.api_port, "POST",
                                         "/v1/resolve", _doc(i))

                threads = [threading.Thread(target=go, args=(i,))
                           for i in range(n)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120)
                got[side] = [(r.status, r.body) for r in results]
                text = request(srv.api_port, "GET", "/metrics").body.decode()
                assert _metric(text, "deppy_sched_dispatches_total") < n
            assert got["port"] == got["reference"]
            for i, (status, body) in enumerate(got["port"]):
                assert status == 200
                assert json.loads(body)["results"][0]["selected"] == \
                    [f"a{i}", "b"]

    def test_device_batch_and_steps(self):
        with pair("device", portfolio="off", incremental="off",
                  speculate="off", sched="off") as p:
            p.same("POST", "/v1/resolve", {"problems": [ONE, UNSAT, STEPS]})
            text = p.same_metrics()
            assert _metric(text, "deppy_engine_steps_total") > 0

    def test_escalation_stage_reaches_metrics_scrape(self, monkeypatch):
        for side in SIDES.values():
            monkeypatch.setattr(side["driver"], "STAGE1_MIN_BATCH", 2)
            monkeypatch.setattr(side["driver"], "STAGE1_STEPS", 3)
        problems = [{"variables": [{"id": f"t{i}", "constraints": [
            {"type": "mandatory"}]}]} for i in range(7)] + [HARD]
        with pair("device", portfolio="off", incremental="off",
                  speculate="off") as p:
            r = p.same("POST", "/v1/resolve", {"problems": problems})
            assert all(x["status"] == "sat"
                       for x in json.loads(r.body)["results"])
            assert p.port.metrics._esc_hist.count == 1
            text = p.same_metrics()
            assert 'deppy_escalation_stage_bucket{le="1"} 0' in text
            assert 'deppy_escalation_stage_bucket{le="2"} 1' in text


# ------------------------------------------ tests/test_trace.py's Server


class TestTracing:
    def test_header_free_responses_match_unscheduled_path(self):
        with pair(sched_max_wait_ms=50.0) as p, pair(sched="off") as plain:
            for doc in (_doc(0), {"problems": [_doc(1), _doc(2)]}):
                s = p.same("POST", "/v1/resolve", doc)
                u = plain.same("POST", "/v1/resolve", doc)
                assert s.body == u.body
                assert b"timings" not in s.body and b"trace" not in s.body
                for hdrs in (s.headers, u.headers):
                    assert "X-Deppy-Request-Id" not in hdrs
                    assert "traceparent" not in hdrs

    def test_timings_opt_in(self):
        with pair(sched_max_wait_ms=10.0) as p:
            out = p.call("POST", "/v1/resolve", _doc(0),
                         {"X-Deppy-Timings": "1"})
            keys = {side: sorted(json.loads(r.body)["timings"])
                    for side, r in out.items()}
            assert keys["port"] == keys["reference"]
            timings = json.loads(out["port"].body)["timings"]
            assert {"queue_wait_s", "dispatch_s", "solve_s",
                    "total_s"} <= set(timings)
            assert timings["total_s"] >= timings["queue_wait_s"] >= 0.0
            plain = p.same("POST", "/v1/resolve", _doc(0))
            assert json.loads(plain.body)["results"] == \
                json.loads(out["port"].body)["results"]

    def test_request_histograms_observe(self):
        with pair(sched_max_wait_ms=10.0) as p:
            p.same("POST", "/v1/resolve", _doc(0))
            text = p.same_metrics()
            for family in ("deppy_request_total_seconds",
                           "deppy_request_queue_wait_seconds"):
                assert _metric(text, f"{family}_count") >= 1

    def test_debug_traces_index_and_lookup(self):
        tid = "5e" * 16
        with pair(sched_max_wait_ms=10.0) as p:
            tp = f"00-{tid}-{'cd' * 8}-01"
            r = p.same("POST", "/v1/resolve", _doc(0), {"traceparent": tp})
            assert r.headers["traceparent"].startswith(f"00-{tid}-")
            for srv in p.srv.values():
                index = json.loads(request(srv.api_port, "GET",
                                           "/debug/traces").body)["traces"]
                assert any(t["trace_id"] == tid for t in index)
                doc = json.loads(request(srv.api_port, "GET",
                                         f"/debug/traces?id={tid}").body)
                assert doc["trace"]["trace_id"] == tid
            assert p.same("GET", "/debug/traces?id=nope").status == 404

    def test_request_id_echo_and_lookup(self):
        with pair() as p:
            r = p.same("POST", "/v1/resolve", ONE,
                       {"X-Deppy-Request-Id": "req-7"})
            assert r.headers["X-Deppy-Request-Id"] == "req-7"
            assert "traceparent" not in r.headers
            for srv in p.srv.values():
                trace = json.loads(request(
                    srv.api_port, "GET", "/debug/traces?id=req-7").body)
                assert trace["trace"]["request_id"] == "req-7"
                assert trace["trace"]["status"] == 200

    def test_debug_dump(self, tmp_path):
        with pair(replica="r9") as p:
            r = p.same("POST", "/debug/dump", {"reason": "test"})
            assert json.loads(r.body) == {"dumped": 0, "replica": "r9"}
            p.same("POST", "/v1/resolve", ONE)
            sinks = {}
            for side, s in SIDES.items():
                sinks[side] = tmp_path / f"{side}.jsonl"
                s["telemetry"].default_registry().configure_sink(
                    str(sinks[side]))
            try:
                r = p.same("POST", "/debug/dump", {"reason": "test"})
            finally:
                for s in SIDES.values():
                    s["telemetry"].default_registry().configure_sink(None)
            assert json.loads(r.body) == {"dumped": 1, "replica": "r9"}
            for path in sinks.values():
                events = [json.loads(x) for x in path.read_text().splitlines()]
                assert [(e["kind"], e["reason"]) for e in events
                        if e["kind"] == "trace"] == [("trace", "test")]


# -------------------------------------- tests/test_telemetry.py's Server


def test_metrics_probe_is_injectable():
    for side in SIDES.values():
        Metrics = side["service"].Metrics
        assert "deppy_auto_engine_usable" not in Metrics(
            engine_usable_probe=lambda: None).render()
        assert "deppy_auto_engine_usable 1" in Metrics(
            engine_usable_probe=lambda: True).render()
        assert "deppy_auto_engine_usable 0" in Metrics(
            engine_usable_probe=lambda: False).render()

        def boom():
            raise RuntimeError("probe died")

        assert "deppy_auto_engine_usable" not in Metrics(
            engine_usable_probe=boom).render()


def test_metrics_histograms_observe_report():
    texts = {}
    for side, s in SIDES.items():
        m = s["service"].Metrics(engine_usable_probe=lambda: None)
        rep = s["telemetry"].SolveReport()
        rep.record_batch(live_lanes=1, batch_lanes=4, live_cells=10,
                         pad_cells=100)
        rep.note_escalation(2)
        m.observe_batch({"sat": 1}, 0.05, steps=7, report=rep)
        texts[side] = m.render()
    assert texts["port"] == texts["reference"]
    assert 'deppy_batch_fill_ratio_bucket{le="0.25"} 1' in texts["port"]
    assert 'deppy_escalation_stage_bucket{le="2"} 1' in texts["port"]


def test_exposition_contract():
    """Every sample belongs to a family with a TYPE and a HELP;
    histogram buckets are monotonic and +Inf equals _count."""
    with pair() as p:
        p.same("POST", "/v1/resolve", MIXED)
        text = p.same_metrics()
    types, helps, samples = {}, {}, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, h = line[7:].partition(" ")
            helps[name] = h
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            assert kind in ("counter", "gauge", "histogram"), line
            types[name] = kind
        elif line:
            name, _, value = line.rpartition(" ")
            samples.append((name, float(value)))
    assert set(types) == set(helps)
    assert all(h.strip() for h in helps.values())
    for name, _ in samples:
        base = name.split("{")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and types.get(
                    base[:-len(suffix)]) == "histogram":
                base = base[:-len(suffix)]
        assert base in types, name
    for hname in [n for n, k in types.items() if k == "histogram"]:
        buckets = [(n, v) for n, v in samples
                   if n.startswith(f"{hname}_bucket{{")]
        values = [v for _, v in buckets]
        assert values == sorted(values)
        assert buckets[-1][0].endswith('le="+Inf"}')
        assert buckets[-1][1] == dict(samples)[f"{hname}_count"]


# -------------------------------------------- the tiers' endpoints


def _catalog_doc(name: str = "s", bundles: int = 3, size: int = 4) -> dict:
    """``tests/test_sessions.py:67-83``'s multi-bundle catalog."""
    variables = []
    for b in range(bundles):
        for j in range(size):
            cons = []
            if j == 0 and b == 0:
                cons.append({"type": "mandatory"})
            if j < size - 1:
                cons.append({"type": "dependency",
                             "ids": [f"{name}b{b}v{j + 1}",
                                     f"{name}b{(b + 1) % bundles}v{j + 1}"]})
            variables.append({"id": f"{name}b{b}v{j}", "constraints": cons})
    return {"variables": variables}


class TestSessions:
    def test_http_flow_byte_identical_to_oneshot(self):
        doc = _catalog_doc("sv")
        with pair(replica="r0") as p:
            created = {side: json.loads(r.body)["session"]
                       for side, r in p.call("POST", "/v1/session",
                                             doc).items()}
            ids = {side: c.pop("id") for side, c in created.items()}
            assert created["port"] == created["reference"]
            ops = [{"op": "assume", "identifiers": ["svb1v0"]},
                   {"op": "resolve"}, {"op": "test"},
                   {"op": "assume", "identifiers": ["svb0v0"],
                    "installed": False},
                   {"op": "explain"}, {"op": "untest"}, {"op": "resolve"},
                   {"op": "zz"}]
            answers = []
            for op in ops:
                out = {side: request(srv.api_port, "POST",
                                     f"/v1/session/{ids[side]}/op", op)
                       for side, srv in p.srv.items()}
                assert out["port"][:4] == out["reference"][:4], op
                answers.append(out["port"])
            assert answers[-1].status == 400
            r = p.same("POST", "/v1/session/deadbeef/op", {"op": "resolve"})
            assert r.status == 404
            out = {side: request(srv.api_port, "POST",
                                 f"/v1/session/{ids[side]}/op",
                                 {"op": "resolve"},
                                 {"X-Deppy-Deadline-S": "nan"})
                   for side, srv in p.srv.items()}
            assert out["port"][:4] == out["reference"][:4]
            assert out["port"].status == 400
            # The oracle: one-shot /v1/resolve of the derived document.
            derived = json.loads(json.dumps(doc))
            for v in derived["variables"]:
                if v["id"] == "svb1v0":
                    v["constraints"].append({"type": "mandatory"})
            one = json.loads(p.same("POST", "/v1/resolve", derived).body)
            assert json.loads(answers[1].body)["result"] == \
                one["results"][0]
            text = p.same_metrics()
            for fam in ("deppy_session_active", "deppy_session_ops_total",
                        "deppy_session_expired_total",
                        "deppy_session_evictions_total"):
                assert fam in text

    @pytest.mark.parametrize("kw", [dict(sessions="off"), dict(sched="off")])
    def test_off_switch_404_byte_identical(self, kw):
        with pair(**kw) as p:
            assert p.port.sessions is None
            a = p.same("POST", "/v1/session", _catalog_doc("off"))
            b = p.same("POST", "/v1/no-such-path", _catalog_doc("off"))
            assert (a.status, a.body) == (b.status, b.body) == (
                404, b'{"error": "not found"}')
            assert "deppy_session" not in p.same_metrics()

    def test_env_switch(self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_SESSIONS", "off")
        monkeypatch.setenv("DEPPY_GPU_OPT", "no")
        srv = _server("port", start=False)
        try:
            assert srv.sessions is None and srv.optimizer is None
            assert srv.scheduler is not None
        finally:
            srv.shutdown()
        monkeypatch.setenv("DEPPY_GPU_SCHED", "0")
        srv = _server("port", start=False)
        try:
            assert srv.scheduler is None
        finally:
            srv.shutdown()


def _upgrade_doc(**fields) -> dict:
    variables = [
        tsat.variable("root", tsat.mandatory(),
                      tsat.dependency("app-v2", "app-v1"),
                      tsat.at_most(1, "app-v2", "app-v1")),
        tsat.variable("app-v1", tsat.dependency("lib-v1")),
        tsat.variable("app-v2", tsat.dependency("lib-v1", "lib-v2")),
        tsat.variable("lib-v1"), tsat.variable("lib-v2")]
    return {"variables": [tio.variable_to_dict(v) for v in variables],
            **fields}


class TestOptimize:
    def test_optimize_endpoint_serves_and_validates(self):
        with pair() as p:
            r = p.same("POST", "/v1/optimize", _upgrade_doc(
                query="upgrade", installed=["root", "app-v1", "lib-v1"],
                prefer=["app-v2"]), {"X-Deppy-Tenant": "t1"})
            out = json.loads(r.body)["optimize"]
            assert out["status"] == "optimal"
            assert out["selected"] == ["root", "app-v2", "lib-v1"]
            r = p.same("POST", "/v1/optimize", _upgrade_doc(
                query="soft", soft=[{"id": "app-v2", "installed": False,
                                     "weight": 3}]))
            assert json.loads(r.body)["optimize"]["status"] == "optimal"
            r = p.same("POST", "/v1/optimize", {"query": "nope"})
            assert r.status == 400 and "error" in json.loads(r.body)

    def test_off_404s_byte_identically_and_resolve_untouched(self):
        doc = _upgrade_doc(query="upgrade", installed=[], prefer=[])
        with pair(opt="off") as off, pair() as on:
            assert off.port.optimizer is None
            a = off.same("POST", "/v1/optimize", doc)
            b = off.same("POST", "/v1/no-such-endpoint", doc)
            assert a.status == b.status == 404 and a.body == b.body
            resolve = {"variables": doc["variables"]}
            assert on.same("POST", "/v1/resolve", resolve).body == \
                off.same("POST", "/v1/resolve", resolve).body


def _family(prefix: str, state: int = 0, bundles: int = 3,
            size: int = 5) -> list:
    """``tests/test_speculate.py:55-75``'s bundle-catalog family."""
    doc = []
    for b in range(bundles):
        for j in range(size):
            cons = []
            if j == 0:
                cons.append({"type": "mandatory"})
                cons.append({"type": "dependency",
                             "ids": [f"{prefix}b{b}v1"]})
            elif j < size - 2:
                tgt = j + 1
                if b == 1 and j == 1:
                    tgt = min(j + 1 + state, size - 1)
                cons.append({"type": "dependency",
                             "ids": [f"{prefix}b{b}v{tgt}",
                                     f"{prefix}b{b}v{min(j + 2, size - 1)}"]})
            doc.append({"id": f"{prefix}b{b}v{j}", "constraints": cons})
    return tio.problems_from_document({"variables": doc})[0]


def _doc_of(variables) -> dict:
    return {"variables": [tio.variable_to_dict(v) for v in variables]}


def _spec_drained(sched, timeout=20.0) -> bool:
    return _wait(lambda: sched.speculative_depth() == 0
                 and not sched._spec_keys, timeout)


class TestSpeculation:
    def test_publish_then_reask_matches_off_service_byte_for_byte(self):
        base = _doc_of(_family("t12."))
        pub = {"updates": [{"id": "t12.b1v1", "constraints": [
            {"type": "dependency", "ids": ["t12.b1v4", "t12.b1v3"]}]}]}
        with pair() as on, pair(speculate="off") as off:
            on.same("POST", "/v1/resolve", base)
            off.same("POST", "/v1/resolve", base)
            r = on.same("POST", "/v1/catalog/publish", pub)
            assert json.loads(r.body)["publish"]["affected"] >= 1
            for srv in on.srv.values():
                assert _spec_drained(srv.scheduler)
            new_doc = _doc_of(PublishDelta.from_doc(pub).apply(
                _family("t12.")))
            a = on.same("POST", "/v1/resolve", new_doc)
            b = off.same("POST", "/v1/resolve", new_doc)
            assert (a.status, a.body) == (b.status, b.body)
            # With the tier off the endpoints 404 like any unknown path.
            assert off.same("POST", "/v1/catalog/publish",
                            pub).body == b'{"error": "not found"}'

    def test_preview_endpoint_and_validation(self):
        pub = {"updates": [{"id": "t13.b1v1", "constraints": [
            {"type": "dependency", "ids": ["t13.b1v3", "t13.b1v2"]}]}],
            "limit": 4}
        with pair() as p:
            p.same("POST", "/v1/resolve", _doc_of(_family("t13.")))
            r = p.same("POST", "/v1/resolve/preview", pub)
            entries = json.loads(r.body)["preview"]
            assert entries and entries[0]["result"]["status"] == "sat"
            assert p.same("POST", "/v1/resolve/preview",
                          dict(pub, limit=-1)).status == 400
            assert p.same("POST", "/v1/catalog/publish",
                          {"updates": []}).status == 400


def _routes_quiet(srv) -> bool:
    """Every shadow probe the server's route plane picked has run and
    been folded into its ledger, and its idle queue is empty."""
    plane = srv.route_plane
    with plane.sampler._lock:
        picked = sum(plane.sampler._rotate.values())
    folded = sum(c["dispatches"]
                 for c in plane.ledger.shadow_counts().values())
    return srv.scheduler.speculative_depth() == 0 and folded >= picked


def settle_routes(p: Pair, limit_s: float = 30.0) -> None:
    """Wait, at most ``limit_s``, until both servers' route planes and
    idle queues are quiet.  The first cold flush of a class with no
    measured row queues one shadow probe on each side: the port's plain
    versions answer it in milliseconds, the reference's ``tpu`` backend
    compiles CPU XLA first (seconds, more under load), so a scrape taken
    at once can see only the port's ``deppy_route_shadow_dispatches_total``."""
    deadline = time.monotonic() + limit_s
    while not all(_routes_quiet(srv) for srv in p.srv.values()):
        if time.monotonic() > deadline:
            pytest.fail(f"route planes not quiet after {limit_s} s")
        time.sleep(0.02)


class TestRoutes:
    def test_learned_rows_endpoint(self):
        rows = {"rows": {"portfolio.xs": "host,device"}, "origin": "peer"}
        with pair(route_learn="on") as p:
            try:
                p.same("POST", "/v1/resolve", ONE)
                r = p.same("POST", "/v1/routes/learned", rows)
                assert r.status == 200
                assert p.same("POST", "/v1/routes/learned",
                              {"rows": []}).status == 400
                assert p.same("POST", "/v1/resolve", ONE).status == 200
                settle_routes(p)
                text = p.same_metrics()
                assert "deppy_route_" in text
            finally:
                for srv in p.srv.values():
                    srv.shutdown()
        from deppy_tpu_torch import routes

        assert routes.active_plane() is None

    def test_without_learning_404(self):
        with pair() as p, pair(route_learn="observe") as obs:
            for q in (p, obs):
                r = q.same("POST", "/v1/routes/learned",
                           {"rows": {"portfolio.xs": "host"}})
                assert r.status == 404


class TestWarmState:
    def test_reference_snapshot_imports_into_the_port(self):
        """A reference server's ``GET /debug/warmstate`` posted to a port
        server imports the same counts; the repeat is then a cache hit
        with the reference's bytes."""
        docs = [_doc_of(_family(f"w{i}.")) for i in range(3)]
        ref = _server("reference")
        port = _server("port")
        try:
            answers = [request(ref.api_port, "POST", "/v1/resolve", d).body
                       for d in docs]
            snap = request(ref.api_port, "GET", "/debug/warmstate").body
            other = _server("reference")
            try:
                want = request(other.api_port, "POST", "/debug/warmstate",
                               raw=snap)
            finally:
                other.shutdown()
            got = request(port.api_port, "POST", "/debug/warmstate",
                          raw=snap)
            assert (got.status, got.body) == (want.status, want.body) \
                and got.status == 200
            for d, body in zip(docs, answers):
                assert request(port.api_port, "POST", "/v1/resolve",
                               d).body == body
            text = request(port.api_port, "GET", "/metrics").body.decode()
            assert _metric(text, "deppy_cache_hits_total") == len(docs)
            assert _metric(text, "deppy_sched_dispatches_total") in (0, None)
            export = json.loads(request(port.api_port, "GET",
                                        "/debug/warmstate").body)
            assert export["version"] == json.loads(snap)["version"]
            assert request(port.api_port, "POST", "/debug/warmstate",
                           {"version": -1}).status == 400
        finally:
            ref.shutdown()
            port.shutdown()

    def test_schedless_warmstate_404(self):
        with pair(sched="off") as p:
            assert p.same("GET", "/debug/warmstate").status == 404
            assert p.same("POST", "/debug/warmstate", {}).status == 404


# ------------------------------------------- tests/test_profile.py's Server


def test_profile_families_ride_service_scrape():
    assert "deppy_profile_" not in tservice.Metrics().render()
    problems = [encode(tio.problems_from_document(_doc(i))[0])
                for i in range(4)]
    with tprofile.override("on", 1.0):
        tdriver.solve_problems(problems, device="cpu")
    text = tservice.Metrics().render()
    for fam in ("deppy_profile_dispatches_total",
                "deppy_profile_trips_total",
                "deppy_profile_useful_work_ratio_bucket",
                'deppy_profile_backend_lanes_total{backend="device"}'):
        assert fam in text, fam


def test_two_tenant_chaos_burn_rate():
    for side in SIDES.values():
        side["faults"].configure_plan(side["faults"].plan_from_spec(
            '[{"point": "sched.dispatch", "kind": "latency",'
            ' "latency_s": 0.05, "times": -1}]'))
    slo = json.dumps({"default": {"target_p99_s": 5.0, "error_budget": 0.01}})
    doc = {"variables": [
        {"id": "a", "constraints": [
            {"type": "mandatory"}, {"type": "dependency", "ids": ["b"]}]},
        {"id": "b"}]}
    with pair(slo=slo, cache_size=0) as p:
        for _ in range(3):
            assert p.same("POST", "/v1/resolve", doc,
                          {"X-Deppy-Tenant": "gold"}).status == 200
            assert p.same("POST", "/v1/resolve", doc,
                          {"X-Deppy-Tenant": "churny",
                           "X-Deppy-Deadline-S": "0.01"}).status == 200
        docs = {side: json.loads(request(srv.api_port, "GET",
                                         "/debug/slo").body)["slo"]
                for side, srv in p.srv.items()}
        assert sorted(docs["port"]) == sorted(docs["reference"]) == \
            ["churny", "gold"]
        slo_doc = docs["port"]
        assert slo_doc["churny"]["deadline_misses"] >= 1
        assert slo_doc["churny"]["burn_rate"] > 1.0
        assert slo_doc["gold"]["burn_rate"] == 0.0
        text = p.same_metrics()
        assert 'deppy_tenant_burn_rate{tenant="churny"}' in text
        assert 'deppy_tenant_deadline_miss_total{tenant="gold"} 0' in text


def test_unscheduled_path_counts_deadline_misses(monkeypatch):
    """With the scheduler off, a request that ran past its deadline with
    incomplete lanes counts as a miss; a fast Incomplete within a
    generous deadline does not."""
    for side in SIDES.values():
        def slow_incomplete(self, problems, _i=side["solver"].Incomplete):
            time.sleep(0.03)
            self.last_steps = 0
            self.last_report = None
            return [_i()]

        monkeypatch.setattr(side["facade"].BatchResolver, "solve",
                            slow_incomplete)
    got = {}
    for side in SIDES:
        srv = _server(side, start=False, sched="off")
        try:
            doc = {"variables": [{"id": "a"}]}
            rs1, rs2 = {}, {}
            s1, _ = srv.resolve_document(doc, deadline_s=0.01,
                                         request_stats=rs1)
            s2, _ = srv.resolve_document(doc, deadline_s=30.0,
                                         request_stats=rs2)
            got[side] = (s1, rs1, s2, rs2)
        finally:
            srv.shutdown()
    assert got["port"] == got["reference"] == (
        200, {"deadline_misses": 1}, 200, {"deadline_misses": 0})


# ---------------------------------------------- tests/test_obs.py's Server


def test_armed_streaming_is_byte_identical():
    doc = _doc_of(_family("ident."))
    with pair() as plain:
        assert "deppy_obs_" not in plain.same_metrics()
        before = plain.same("POST", "/v1/resolve", doc)
    with pair(replica="r1", obs_stream="127.0.0.1:9",
              obs_flush_ms=20) as armed:
        after = armed.same("POST", "/v1/resolve", doc)
        text = request(armed.port.api_port, "GET",
                       "/metrics").body.decode()
        assert "deppy_obs_stream_events_total" in text
    assert (before.status, before.body) == (after.status, after.body)
    assert tobs.render_metric_lines() == []


# ------------------------------------------------ fleet: the server's half


class StubRouter:
    """The router's half of membership: records ``POST /fleet/join`` and
    ``/fleet/drain`` bodies, and during a drain reads the leaving
    replica's ``GET /debug/warmstate`` back, as the router's handoff
    does."""

    def __init__(self):
        self.calls, self.drain_reads = [], []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):  # noqa: N802 — the stdlib's name
                n = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(n) or b"null")
                stub.calls.append((self.path, doc))
                if self.path == "/fleet/drain":
                    host, _, port = doc["replica"].rpartition(":")
                    stub.drain_reads.append(request(
                        int(port), "GET", "/debug/warmstate").status)
                body = json.dumps({"ok": True}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_fleet_join_and_drain_against_a_stub_router():
    seen = {}
    for side in SIDES:
        stub = StubRouter()
        try:
            srv = _server(side, fleet_router=stub.addr)
            try:
                assert _wait(lambda: srv._fleet_joined)
                me = f"127.0.0.1:{srv.api_port}"
            finally:
                srv.shutdown()
            assert not srv._fleet_joined
            seen[side] = ([(path, doc == {"replica": me})
                           for path, doc in stub.calls], stub.drain_reads)
        finally:
            stub.close()
    assert seen["port"] == seen["reference"] == (
        [("/fleet/join", True), ("/fleet/drain", True)], [200])


def test_fleet_router_unreachable_serves_standalone(capsys):
    srv = _server("port", fleet_router="127.0.0.1:9")
    try:
        srv._fleet_announce(deadline_s=0.0)
        assert not srv._fleet_joined
        assert request(srv.api_port, "POST", "/v1/resolve", ONE).status == 200
    finally:
        srv.shutdown()
    assert "serving standalone" in capsys.readouterr().err
