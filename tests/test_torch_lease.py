"""The port's HA lease election against the JAX package's.

``deppy_tpu.utils.lease`` beside ``deppy_tpu_torch.utils.lease``, each
case of ``tests/test_lease.py`` run on both packages against the same
stub coordination API (GET/POST/PUT with ``resourceVersion`` optimistic
concurrency), plus:

  * one scripted election driven on both packages in lockstep, whose
    lease documents must agree field for field (wall-clock stamps
    aside);
  * the env knobs: the port's ``DEPPY_GPU_HA_*`` read as the reference
    reads its ``DEPPY_HA_*``;
  * the service integration: under election only the lease holder's
    ``/readyz`` answers 200 and ``deppy_leader`` follows, on each
    package's ``Server``.

Every stub server, elector and service is closed in a ``finally``, and
every wait is bounded.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from deppy_tpu import service as jservice
from deppy_tpu.utils import lease as jlease
from deppy_tpu_torch import service as tservice
from deppy_tpu_torch.utils import lease as tlease

SIDES = {
    "reference": dict(lease=jlease, service=jservice, prefix="DEPPY_HA_",
                      server_kw=dict(backend="host")),
    "port": dict(lease=tlease, service=tservice, prefix="DEPPY_GPU_HA_",
                 server_kw=dict(backend="host", device="cpu")),
}


class FakeLeaseAPI:
    """In-memory coordination.k8s.io/v1 lease store behind real HTTP."""

    def __init__(self):
        self.store = {}          # name -> lease doc
        self.rv = 0
        self.lock = threading.Lock()
        self.fail = False        # simulate an unreachable/refusing API
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, status, doc=None):
                body = json.dumps(doc).encode() if doc is not None else b""
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _name(self):
                return self.path.rstrip("/").split("/")[-1]

            def do_GET(self):
                with api.lock:
                    if api.fail:
                        return self._send(500)
                    doc = api.store.get(self._name())
                    if doc is None:
                        return self._send(404)
                    return self._send(200, doc)

            def do_POST(self):
                body = json.loads(
                    self.rfile.read(int(self.headers["Content-Length"])))
                name = body["metadata"]["name"]
                with api.lock:
                    if api.fail:
                        return self._send(500)
                    if name in api.store:
                        return self._send(409)
                    api.rv += 1
                    body["metadata"]["resourceVersion"] = str(api.rv)
                    api.store[name] = body
                    return self._send(201, body)

            def do_PUT(self):
                body = json.loads(
                    self.rfile.read(int(self.headers["Content-Length"])))
                name = self._name()
                with api.lock:
                    if api.fail:
                        return self._send(500)
                    cur = api.store.get(name)
                    if cur is None:
                        return self._send(404)
                    sent_rv = body["metadata"].get("resourceVersion")
                    cur_rv = cur["metadata"]["resourceVersion"]
                    if sent_rv is not None and sent_rv != cur_rv:
                        return self._send(409)
                    api.rv += 1
                    body["metadata"]["resourceVersion"] = str(api.rv)
                    api.store[name] = body
                    return self._send(200, body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def base(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def holder(self, name):
        with self.lock:
            doc = self.store.get(name)
            return (doc or {}).get("spec", {}).get("holderIdentity")

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def api():
    srv = FakeLeaseAPI()
    yield srv
    srv.close()


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def _elector(side, api, ident, lease_seconds=15):
    lease = side["lease"]
    return lease.LeaseElector(lease.LeaseConfig(
        name="resolver", namespace="ns", identity=ident,
        api_base=api.base, lease_seconds=lease_seconds))


def _wait(cond, timeout=5.0):
    """Poll ``cond`` until true or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return bool(cond())


def test_first_elector_acquires_second_stays_standby(side, api):
    a = _elector(side, api, "pod-a")
    b = _elector(side, api, "pod-b")
    assert a.tick() is True
    assert a.is_leader
    assert b.tick() is False
    assert not b.is_leader
    assert api.holder("resolver") == "pod-a"
    assert a.tick() is True
    assert api.holder("resolver") == "pod-a"


def test_release_hands_over_without_waiting_for_expiry(side, api):
    a = _elector(side, api, "pod-a")
    b = _elector(side, api, "pod-b")
    a.tick()
    b.tick()
    a.stop(release=True)
    assert not a.is_leader
    assert api.holder("resolver") == ""
    assert b.tick() is True
    assert api.holder("resolver") == "pod-b"


def test_expired_lease_is_taken_over(side, api):
    a = _elector(side, api, "pod-a", lease_seconds=0)
    b = _elector(side, api, "pod-b", lease_seconds=0)
    assert a.tick() is True
    assert b.tick() is True
    assert api.holder("resolver") == "pod-b"
    assert api.store["resolver"]["spec"]["leaseTransitions"] == 1


def test_create_race_loses_cleanly(side, api):
    a = _elector(side, api, "pod-a")
    b = _elector(side, api, "pod-b")
    assert b.tick() is True
    assert a.tick() is False
    assert api.holder("resolver") == "pod-b"


def test_drain_after_transient_failure_still_hands_over(side, api):
    a = _elector(side, api, "pod-a")
    b = _elector(side, api, "pod-b")
    assert a.tick() is True
    api.fail = True
    assert a.tick() is False
    api.fail = False
    a.stop(release=True)
    assert api.holder("resolver") == ""
    assert b.tick() is True


def test_api_failure_fails_closed(side, api):
    a = _elector(side, api, "pod-a")
    assert a.tick() is True
    api.fail = True
    assert a.tick() is False
    assert not a.is_leader
    api.fail = False
    assert a.tick() is True


def test_on_change_fires_on_transitions_only(side, api):
    seen = []
    a = _elector(side, api, "pod-a")
    a.on_change = seen.append
    a.tick()
    a.tick()
    api.fail = True
    a.tick()
    api.fail = False
    a.tick()
    assert seen == [True, False, True]


def test_background_loop_and_failover(side, api):
    a = _elector(side, api, "pod-a")
    b = _elector(side, api, "pod-b")
    a.config.renew_seconds = b.config.renew_seconds = 0.05
    a.start()
    b.start()
    try:
        assert _wait(lambda: a.is_leader or b.is_leader)
        assert a.is_leader != b.is_leader
        leader, standby = (a, b) if a.is_leader else (b, a)
        leader.stop(release=True)
        assert _wait(lambda: standby.is_leader)
    finally:
        a.stop(release=False)
        b.stop(release=False)


def test_same_lease_documents_on_both_packages():
    """One scripted election (create, renew, lost create, expiry
    takeover, release) on each package against its own stub: the lease
    documents agree in every field but the wall-clock stamps."""
    docs = {}
    for name, side in SIDES.items():
        api = FakeLeaseAPI()
        try:
            a = _elector(side, api, "pod-a", lease_seconds=0)
            b = _elector(side, api, "pod-b", lease_seconds=0)
            trail = [a.tick(), a.tick(), b.tick()]
            b.stop(release=True)
            trail.append(a.tick())
            doc = json.loads(json.dumps(api.store["resolver"]))
            for k in ("acquireTime", "renewTime"):
                assert doc["spec"].pop(k)
            docs[name] = (trail, doc)
        finally:
            api.close()
    assert docs["port"] == docs["reference"]
    assert docs["port"][0] == [True, True, True, True]


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"LEASE": "  "}, None),
    ({"LEASE": "resolver", "API": "http://api", "LEASE_SECONDS": "7",
      "NAMESPACE": "team"}, ("resolver", "team", "http://api", 7)),
    ({"LEASE": "resolver", "API": "http://api", "LEASE_SECONDS": "x"},
     ("resolver", "deppy-tpu-system", "http://api", 15)),
    ({"LEASE": "resolver", "API": "http://api", "LEASE_SECONDS": "0"},
     ("resolver", "deppy-tpu-system", "http://api", 15)),
])
def test_elector_from_env_knobs(monkeypatch, env, want):
    """``DEPPY_GPU_HA_*`` parse as ``DEPPY_HA_*`` do: blank disables, a
    malformed or non-positive duration reads 15."""
    got = {}
    for name, side in SIDES.items():
        for other in SIDES.values():
            for k in ("LEASE", "API", "NAMESPACE", "LEASE_SECONDS"):
                monkeypatch.delenv(other["prefix"] + k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(side["prefix"] + k, v)
        e = side["lease"].elector_from_env()
        got[name] = None if e is None else (
            e.config.name, e.config.namespace, e.config.api_base,
            e.config.lease_seconds)
    assert got["port"] == got["reference"] == want


def test_port_reads_only_its_own_knobs(monkeypatch):
    monkeypatch.setenv("DEPPY_HA_LEASE", "resolver")
    monkeypatch.setenv("DEPPY_HA_API", "http://api")
    for k in ("LEASE", "API", "NAMESPACE", "LEASE_SECONDS"):
        monkeypatch.delenv("DEPPY_GPU_HA_" + k, raising=False)
    assert tlease.elector_from_env() is None
    assert jlease.elector_from_env() is not None


def test_in_cluster_config_needs_a_cluster(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for side in SIDES.values():
        with pytest.raises(RuntimeError, match="not running in a cluster"):
            side["lease"].in_cluster_config("resolver")


def test_readyz_gated_on_leadership(side, api):
    """Under election only the lease holder serves ``/readyz`` 200 and
    ``deppy_leader 1``; draining it hands the lease to the standby."""
    a = _elector(side, api, "pod-a")
    b = _elector(side, api, "pod-b")
    a.config.renew_seconds = b.config.renew_seconds = 0.05
    Server = side["service"].Server
    sa = Server(bind_address="127.0.0.1:0", probe_address="127.0.0.1:0",
                elector=a, **side["server_kw"])
    sb = Server(bind_address="127.0.0.1:0", probe_address="127.0.0.1:0",
                elector=b, **side["server_kw"])

    def readyz(srv):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.probe_port}/readyz",
                    timeout=5) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    def metrics_leader(srv):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.api_port}/metrics", timeout=5) as r:
            text = r.read().decode()
        for line in text.splitlines():
            if line.startswith("deppy_leader "):
                return int(line.split()[1])
        return None

    stopped = []
    try:
        sa.start()
        sb.start()
        assert _wait(lambda: a.is_leader or b.is_leader)
        leader_srv, standby_srv = (sa, sb) if a.is_leader else (sb, sa)
        assert readyz(leader_srv) == 200
        assert readyz(standby_srv) == 503
        assert metrics_leader(leader_srv) == 1
        assert metrics_leader(standby_srv) == 0
        leader_srv.shutdown()
        stopped.append(leader_srv)
        assert _wait(standby_srv.serving)
        assert readyz(standby_srv) == 200
    finally:
        for srv in (sa, sb):
            if srv not in stopped:
                srv.shutdown()


class TestRenewWaitJitter:
    """The jittered renew interval and its overrun clamp, on both."""

    def _elector(self, side, **kw):
        lease = side["lease"]
        return lease.LeaseElector(lease.LeaseConfig(
            name="r", namespace="ns", identity="a",
            api_base="http://127.0.0.1:1", lease_seconds=15, **kw))

    def test_wait_jittered_within_bounds(self, side):
        e = self._elector(side)
        base = e.config.renew_seconds
        assert e._renew_wait(elapsed=0.0, rng=lambda: 0.0) == \
            pytest.approx(base)
        assert e._renew_wait(elapsed=0.0, rng=lambda: 1.0) == \
            pytest.approx(base * (1 + e.config.renew_jitter))
        for _ in range(50):
            w = e._renew_wait(elapsed=0.0)
            assert base <= w <= base * (1 + e.config.renew_jitter) + 1e-9

    def test_tick_latency_subtracted_not_drifting(self, side):
        e = self._elector(side)
        base = e.config.renew_seconds
        assert e._renew_wait(elapsed=base / 2, rng=lambda: 0.0) == \
            pytest.approx(base / 2)

    def test_overrunning_tick_clamped_to_floor(self, side):
        e = self._elector(side)
        base = e.config.renew_seconds
        w = e._renew_wait(elapsed=base * 10, rng=lambda: 1.0)
        assert w == pytest.approx(base * 0.05) and w > 0

    def test_jitter_disabled_when_zero(self, side):
        e = self._elector(side, renew_jitter=0.0)
        assert e._renew_wait(elapsed=0.0, rng=lambda: 1.0) == \
            pytest.approx(e.config.renew_seconds)

    @pytest.mark.parametrize("given,want", [(5.0, 1.0), (-1.0, 0.0)])
    def test_jitter_config_clamped(self, side, given, want):
        cfg = side["lease"].LeaseConfig(
            name="r", namespace="ns", identity="a",
            api_base="http://127.0.0.1:1", renew_jitter=given)
        assert cfg.renew_jitter == want

    def test_renew_interval_defaults(self, side):
        cfg = side["lease"].LeaseConfig(name="r", lease_seconds=0)
        assert cfg.renew_seconds == 0.2
        cfg = side["lease"].LeaseConfig(name="r", lease_seconds=15)
        assert cfg.renew_seconds == 5.0
        assert cfg.url.endswith(
            "/apis/coordination.k8s.io/v1/namespaces/deppy-tpu-system/"
            "leases/r")
