"""The port's fleet against the JAX package's, over HTTP on the CPU.

A port fleet (``deppy_tpu_torch.fleet.Router`` over port
``Server(backend="host", device="cpu")`` replicas) is held against a
reference fleet (``deppy_tpu.fleet.Router`` over reference
``Server(backend="host")`` replicas) on the same documents.  The two
fleets run one after the other, the port's replicas listening on the
ports the reference's had, so both rings hold the same addresses and
route every family alike.  Each case compares response bodies byte for
byte, the routing and handoff counters, and ``/metrics`` family names
and every sample that does not measure time.

The cases mirror the reference's ``tests/test_fleet.py`` (``TestRing``,
``TestSnapshot``, ``TestFanOutFailure``, ``TestFleetEndToEnd``,
``TestElasticJoin``, ``TestPeerSync``, ``TestFleetAnnounce``,
``TestScalePolicy``), ``tests/test_sessions.py::TestFleetRouting``, the
router cases of ``tests/test_obs.py`` (``/fleet/metrics`` and
``/fleet/status``, the streamed merged sink, the fleet trace tree) and
the router's half of the route gossip with the fleet's route rollups
(``tests/test_routes.py::TestFleetRollups``).  Every server and router
is shut down in a ``finally``, and every wait is bounded.
"""

from __future__ import annotations

import errno
import json
import threading
import time
from http.client import HTTPConnection
from types import SimpleNamespace

import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import fleet as jfleet
from deppy_tpu import io as jio
from deppy_tpu import service as jservice
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.fleet import membership as jmembership
from deppy_tpu.fleet import policy as jpolicy
from deppy_tpu.fleet import ring as jring
from deppy_tpu.fleet import router as jrouter
from deppy_tpu.fleet import snapshot as jsnapshot
from deppy_tpu.obs import stream as jstream
from deppy_tpu.sat import solver as jsolver
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import fleet as tfleet
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import service as tservice
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import defaults as tstore
from deppy_tpu_torch.fleet import membership as tmembership
from deppy_tpu_torch.fleet import policy as tpolicy
from deppy_tpu_torch.fleet import ring as tring
from deppy_tpu_torch.fleet import router as trouter
from deppy_tpu_torch.fleet import snapshot as tsnapshot
from deppy_tpu_torch.obs import stream as tstream
from deppy_tpu_torch.sat import solver as tsolver
from deppy_tpu_torch.sched import Scheduler as TScheduler

SIDES = {
    "reference": SimpleNamespace(
        fleet=jfleet, router=jrouter, membership=jmembership,
        policy=jpolicy, ring=jring, snapshot=jsnapshot, service=jservice,
        faults=jfaults, telemetry=jtelemetry, stream=jstream, io=jio,
        scheduler=JScheduler, server_kw={"backend": "host"},
        sched_kw={}),
    "port": SimpleNamespace(
        fleet=tfleet, router=trouter, membership=tmembership,
        policy=tpolicy, ring=tring, snapshot=tsnapshot, service=tservice,
        faults=tfaults, telemetry=ttelemetry, stream=tstream, io=tio,
        scheduler=TScheduler,
        server_kw={"backend": "host", "device": "cpu"},
        sched_kw={"device": "cpu"}),
}

WAIT_S = 30.0
BURST = 32  # clients, past socketserver's five-deep listen queue


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    """Each package's breaker, fault plan, default registry and flight
    recorder per test; host lanes inline; no measured rows on either
    side; the reference's escalation off, as the port's is by default;
    no engine verdict on either side; each restored afterwards."""
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
        f, t = side.faults, side.telemetry
        prev.append((f.set_default_breaker(f.CircuitBreaker()),
                     f.configure_plan(None),
                     t.set_default_registry(t.Registry()),
                     t.trace.set_default_recorder(t.trace.FlightRecorder())))
    yield
    for side, (breaker, plan, reg, rec) in zip(SIDES.values(), prev):
        f, t = side.faults, side.telemetry
        t.trace.set_default_recorder(rec)
        t.set_default_registry(reg)
        f.configure_plan(plan)
        f.set_default_breaker(breaker)


# ---------------------------------------------------------------- helpers


def family_doc(name: str, state: int = 0, bundles: int = 5,
               size: int = 5) -> dict:
    """The reference suite's family: ``bundles`` disconnected dependency
    chains sharing one vocabulary; ``state`` rotates one mid-chain
    dependency inside bundle 0, so consecutive states are one-row deltas
    of the same family."""
    variables = []
    for b in range(bundles):
        for j in range(size):
            cons = []
            if j == 0:
                cons.append({"type": "mandatory"})
                cons.append({"type": "dependency",
                             "ids": [f"{name}b{b}v1"]})
            elif j == 1 and b == 0:
                tgt = 2 + state % (size - 2)
                cons.append({"type": "dependency",
                             "ids": [f"{name}b0v{tgt}"]})
            elif j < size - 1:
                cons.append({"type": "dependency",
                             "ids": [f"{name}b{b}v{j + 1}"]})
            variables.append({"id": f"{name}b{b}v{j}",
                              "constraints": cons})
    return {"variables": variables}


def catalog_doc(name: str, bundles: int = 3, size: int = 4) -> dict:
    """The session suite's catalog: bundle 0 mandatory with a preference
    chain, the rest optional chains."""
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
            variables.append({"id": f"{name}b{b}v{j}",
                              "constraints": cons})
    return {"variables": variables}


def request(port, method, path, body=None, headers=None):
    """One HTTP exchange: (status, body bytes, headers)."""
    conn = HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    h = dict(headers or {})
    payload = None
    if body is not None:
        payload = json.dumps(body)
        h.setdefault("Content-Type", "application/json")
    try:
        conn.request(method, path, body=payload, headers=h)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, dict(resp.getheaders())
    finally:
        conn.close()


def metric(text: str, name: str):
    total = None
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            total = (total or 0.0) + float(line.rsplit(" ", 1)[1])
    return total


def families(text: str) -> list:
    return [line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")]


def timeless(text: str) -> dict:
    """The samples that measure no time (a seconds family's counts
    stay), nor a latency percentile, its burn rate or the requests past
    the latency target."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        base = name.split("{")[0]
        if ("seconds" in base or "p99" in base or "burn_rate" in base
                or "slo_violations" in base) \
                and not base.endswith("_count"):
            continue
        out[name] = value
    return out


def scrape(port) -> dict:
    """A ``/metrics`` page as its family names and time-free samples."""
    status, body, _ = request(port, "GET", "/metrics")
    assert status == 200
    text = body.decode()
    return {"families": families(text), "samples": timeless(text)}


def wait_for(cond, what: str, limit_s: float = WAIT_S) -> None:
    deadline = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"{what} not seen within {limit_s} s")
        time.sleep(0.02)


class Fleet:
    """One side's fleet: ``n`` replicas behind a started ``Router``.
    ``ports`` pins the replicas' API ports and those of the servers a
    case adds (:meth:`server`); unpinned ones are ephemeral and recorded
    in :attr:`ports`."""

    def __init__(self, side: str, ports=None, n: int = 3, router=None,
                 replica=None, start_router: bool = True):
        self.side, self.s = side, SIDES[side]
        self._pinned = list(ports or [])
        self.ports: list = []
        self.replicas, self.extra = [], []
        self.router = None
        self._routers = []
        try:
            for i in range(n):
                self.replicas.append(self.server(f"rep{i}", **(replica or {})))
            kw = dict(probe_interval_s=60.0, probe_failures=2)
            kw.update(router or {})
            self.router = self.new_router(**kw)
            if start_router:
                self.router.start()
        except BaseException:
            self.close()
            raise

    def server(self, name: str, start: bool = True, **kw):
        """A replica-shaped server on the next pinned port (or an
        ephemeral one, recorded)."""
        i = len(self.ports)
        port = self._pinned[i] if i < len(self._pinned) else 0
        srv = self.s.service.Server(
            bind_address=f"127.0.0.1:{port}", probe_address="127.0.0.1:0",
            replica=name, **dict(self.s.server_kw, **kw))
        self.ports.append(srv.api_port)
        if self.router is not None:
            self.extra.append(srv)
        if start:
            srv.start()
        return srv

    def new_router(self, replicas=None, **kw):
        r = self.s.fleet.Router(bind_address="127.0.0.1:0",
                                replicas=replicas or self.addrs, **kw)
        self._routers.append(r)
        return r

    @property
    def addrs(self) -> list:
        return [addr(s) for s in self.replicas]

    def close(self) -> None:
        for r in self._routers:
            r.shutdown()
        for srv in self.replicas + self.extra:
            try:
                srv.shutdown()
            except Exception:  # noqa: BLE001 — a case killed it already
                pass


def addr(srv) -> str:
    return f"127.0.0.1:{srv.api_port}"


def both(case, **kw):
    """``case(fleet)`` on a reference fleet, then on a port fleet whose
    servers listen on the reference's ports: (reference's result,
    port's result).  Tries fresh ports when one was taken meanwhile."""
    for _ in range(3):
        ref = Fleet("reference", **kw)
        try:
            want = case(ref)
        finally:
            ref.close()
        try:
            port = Fleet("port", ports=ref.ports, **kw)
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
            continue
        try:
            return want, case(port)
        finally:
            port.close()
    pytest.fail("the reference fleet's ports were taken three times")


def same(case, **kw):
    want, got = both(case, **kw)
    assert got == want
    return got


def poison(fleet, point: str, times: int = -1) -> None:
    fleet.s.faults.configure_plan(fleet.s.faults.FaultPlan.from_doc(
        [{"point": point, "kind": "error", "times": times}]))


def moving_family(fleet, joiner: str, prefix: str = "mv"):
    """A family whose arc the joiner would steal (the reference suite's
    ``_moving_family``)."""
    ring = fleet.s.ring.HashRing(list(fleet.router.ring.replicas)
                                 + [joiner],
                                 vnodes=fleet.router.ring.vnodes)
    for i in range(4096):
        name = f"{prefix}{i}"
        key = fleet.s.ring.doc_affinity_keys(family_doc(name))[0]
        if ring.route(key) == joiner:
            return name, key
    raise AssertionError("no family arc moves to the joiner")


# ------------------------------------------------------------------ ring


DOCS = [family_doc("f", 0), family_doc("f", 2), family_doc("g"),
        {"problems": [family_doc("x"), family_doc("y")]}, {"nope": 1},
        {"problems": "x"}, {"problems": []}, [1, 2],
        {"problems": [{"variables": [{"no": "id"}]}, family_doc("z")]}]


class TestRing:
    @pytest.mark.parametrize("doc", DOCS, ids=range(len(DOCS)))
    def test_doc_affinity_keys(self, doc):
        assert tring.doc_affinity_keys(doc) == jring.doc_affinity_keys(doc)

    def test_affinity_key_family_stable_and_order_sensitive(self):
        assert tring.doc_affinity_keys(family_doc("f", 0)) == \
            tring.doc_affinity_keys(family_doc("f", 2))
        for ids in (["a", "b"], ["b", "a"], ["ab", "c"], ["a", "bc"]):
            assert tring.affinity_key(ids) == jring.affinity_key(ids)
        assert tring.affinity_key(["ab", "c"]) != \
            tring.affinity_key(["a", "bc"])
        assert tring._point("r#3") == jring._point("r#3")

    @pytest.mark.parametrize("vnodes", [1, 7, 64])
    def test_routes_exclusion_and_successor(self, vnodes):
        members = ["a:1", "b:1", "c:1"]
        t = tring.HashRing(members, vnodes=vnodes)
        j = jring.HashRing(members, vnodes=vnodes)
        keys = [tring.affinity_key([f"k{i}"]) for i in range(200)] + [None]
        for ex in ((), ("b:1",), ("a:1", "c:1"), tuple(members)):
            assert [t.route(k, exclude=ex) for k in keys] == \
                [j.route(k, exclude=ex) for k in keys]
        assert [t.successor(k, "a:1") for k in keys] == \
            [j.successor(k, "a:1") for k in keys]
        owners = {t.route(k) for k in keys}
        assert owners == set(members) or vnodes == 1
        assert t.route(keys[0], exclude=members) is None

    def test_requires_replicas(self):
        for ring in (tring, jring):
            with pytest.raises(ValueError):
                ring.HashRing([])
        assert tring.DEFAULT_VNODES == jring.DEFAULT_VNODES == 64


# -------------------------------------------------------------- snapshot


def _warm_snapshot(side: str) -> dict:
    """The reference suite's warm scheduler (two states of one family
    and one of another), exported."""
    s = SIDES[side]
    sched = s.scheduler(backend="host", speculate="off", portfolio="off",
                        **s.sched_kw)
    try:
        for doc in (family_doc("s"), family_doc("s", state=1),
                    family_doc("u")):
            sched.submit([s.io.problems_from_document(doc)[0]])
        return json.loads(json.dumps(s.fleet.export_warm_state(sched)))
    finally:
        sched.stop()


class TestSnapshot:
    def test_export_and_split_by_owner(self):
        snaps = {side: _warm_snapshot(side) for side in SIDES}
        assert snaps["port"] == snaps["reference"]
        snap = snaps["reference"]
        assert len(snap["index"]) >= 1 and len(snap["cache"]) >= 1
        ring = jring.HashRing(["a:1", "b:1", "c:1"])
        for assign in (ring.route, lambda aff: "r1", lambda aff: None,
                       lambda aff: ring.route(aff, exclude={"a:1"})):
            shards = tsnapshot.split_snapshot(snap, assign)
            assert shards == jsnapshot.split_snapshot(snap, assign)
            for shard in shards.values():
                tsnapshot.verify_snapshot(shard)
        assert tsnapshot.split_snapshot(snap, lambda aff: None) == {}

    def test_split_keeps_sessions_and_rejects_tampering(self):
        snap = _warm_snapshot("reference")
        snap = jsnapshot._seal(snap["index"], snap["cache"], sessions=[
            {"affinity": e["affinity"], "id": f"s{i}"}
            for i, e in enumerate(snap["index"])])
        ring = jring.HashRing(["a:1", "b:1"])
        assert tsnapshot.split_snapshot(snap, ring.route) == \
            jsnapshot.split_snapshot(snap, ring.route)
        bad = dict(snap, cache=[])
        for mod in (tsnapshot, jsnapshot):
            with pytest.raises(mod.SnapshotFormatError):
                mod.split_snapshot(bad, ring.route)

    @pytest.mark.parametrize("chunk", [1, 2, 64])
    def test_join_chunks(self, chunk):
        snap = _warm_snapshot("reference")
        shard = jsnapshot.split_snapshot(snap, lambda aff: "j:1")["j:1"]
        assert list(tmembership.iter_chunks(shard, chunk)) == \
            list(jmembership.iter_chunks(shard, chunk))


# ------------------------------------------------------- fan-out failure


class TestFanOutFailure:
    def test_all_transport_failures_answer_503(self):
        out = {}
        for side, s in SIDES.items():
            router = s.fleet.Router(bind_address="127.0.0.1:0",
                                    replicas="127.0.0.1:9",
                                    probe_interval_s=0, probe_failures=100)
            router.start()
            try:
                out[side] = [request(router.api_port, "POST", path,
                                     {"updates": []})[:2]
                             for path in ("/v1/catalog/publish",
                                          "/v1/resolve/preview")]
            finally:
                router.shutdown()
        assert out["port"] == out["reference"]
        assert all(s == 503 and b"no replica reachable" in b
                   for s, b in out["port"])


# ------------------------------------------------------------- fleet e2e


def _stream():
    stream = [family_doc(f"fam{i}", state) for i in range(5)
              for state in range(3)]
    stream.append({"problems": [family_doc(f"fam{i}") for i in range(5)]})
    stream.append({"variables": "malformed"})
    stream.append({"variables": [
        {"id": "u1", "constraints": [{"type": "mandatory"},
                                     {"type": "prohibited"}]}]})
    return stream


class TestFleetEndToEnd:
    def test_stream_bodies_counters_and_scrapes(self):
        def case(f):
            bodies = [request(f.router.api_port, "POST", "/v1/resolve",
                              doc)[:2] for doc in _stream()]
            return dict(bodies=bodies, router=scrape(f.router.api_port),
                        replicas=[scrape(s.api_port) for s in f.replicas])

        got = same(case)
        routed = [k for k in got["router"]["samples"]
                  if k.startswith("deppy_fleet_routed_total{")]
        assert len(routed) >= 2
        assert got["bodies"][-2][0] == 400 and got["bodies"][0][0] == 200

    def test_single_replica_bodies(self):
        """A port fleet serves what one port server serves."""
        fleet = Fleet("port")
        single = fleet.server("single")
        try:
            for doc in _stream()[::4]:
                assert request(fleet.router.api_port, "POST",
                               "/v1/resolve", doc)[:2] == \
                    request(single.api_port, "POST", "/v1/resolve",
                            doc)[:2]
        finally:
            fleet.close()

    @pytest.mark.parametrize("listener", ["router", "replica"])
    def test_burst_sent_before_the_accept_loop_is_answered(self, listener):
        """More clients than ``socketserver``'s five-deep listen queue,
        each with its request sent before the listener's accept loop
        runs, all get their answer: an accept thread stalled behind the
        interpreter lock must cost no client a reset."""
        fleet = Fleet("port", start_router=False)
        try:
            single = fleet.server("single", start=listener == "router")
            target = fleet.router if listener == "router" else single
            plain = single if listener == "router" else fleet.replicas[0]
            docs = [family_doc(f"burst{i}") for i in range(BURST)]
            out: list = [None] * BURST
            sent = threading.Semaphore(0)

            def client(i):
                conn = HTTPConnection("127.0.0.1", target.api_port,
                                      timeout=WAIT_S)
                try:
                    conn.request("POST", "/v1/resolve",
                                 body=json.dumps(docs[i]),
                                 headers={"Content-Type": "application/json"})
                    sent.release()
                    resp = conn.getresponse()
                    out[i] = (resp.status, resp.read())
                except OSError as e:
                    out[i] = e
                finally:
                    conn.close()

            threads = [threading.Thread(target=client, args=(i,), daemon=True)
                       for i in range(BURST)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + WAIT_S
            for _ in range(BURST):
                if not sent.acquire(
                        timeout=max(deadline - time.monotonic(), 0.0)):
                    pytest.fail("a client's request was not sent within "
                                f"{WAIT_S} s of its connect")
            target.start()
            for t in threads:
                t.join(WAIT_S)
            assert out == [request(plain.api_port, "POST", "/v1/resolve",
                                   doc)[:2] for doc in docs]
        finally:
            fleet.close()

    def test_family_affinity_concentrates_churn(self):
        def case(f):
            for state in range(4):
                request(f.router.api_port, "POST", "/v1/resolve",
                        family_doc("churny", state))
            looked = []
            for srv in f.replicas:
                text = request(srv.api_port, "GET", "/metrics")[1].decode()
                looked.append((metric(text, "deppy_cache_misses_total") or 0)
                              + (metric(text, "deppy_cache_hits_total") or 0))
            return looked

        looked = same(case)
        assert sum(1 for n in looked if n) == 1

    def test_replica_kill_retries_on_successor(self):
        def case(f):
            doc = family_doc("killfam")
            key = f.s.ring.doc_affinity_keys(doc)[0]
            owner = f.router.target_for(key)
            f.replicas[f.addrs.index(owner)].shutdown()
            first = request(f.router.api_port, "POST", "/v1/resolve", doc)
            retried = metric(request(f.router.api_port, "GET",
                                     "/metrics")[1].decode(),
                             "deppy_fleet_retries_total")
            request(f.router.api_port, "POST", "/v1/resolve", doc)
            states = f.router.replica_states()
            return dict(first=first[:2], retried=retried, states=states,
                        owner=owner, after=f.router.target_for(key),
                        router=scrape(f.router.api_port))

        got = same(case)
        assert got["first"][0] == 200 and got["retried"] >= 1
        assert {s["replica"]: s for s in got["states"]}[got["owner"]][
            "dead"] is True
        assert got["after"] != got["owner"]

    def test_drain_hands_off_warm_state(self):
        def case(f):
            docs = [family_doc(f"drainfam{i}") for i in range(4)]
            for doc in docs:
                request(f.router.api_port, "POST", "/v1/resolve", doc)
            key = f.s.ring.doc_affinity_keys(docs[0])[0]
            victim = f.router.target_for(key)
            drained = request(f.router.api_port, "POST", "/fleet/drain",
                              {"replica": victim})[:2]
            owner = f.router.target_for(key)
            nxt = request(f.router.api_port, "POST", "/v1/resolve",
                          family_doc("drainfam0", state=1))[:2]
            text = request(f.replicas[f.addrs.index(owner)].api_port,
                           "GET", "/metrics")[1].decode()
            return dict(drained=drained, victim=victim, owner=owner,
                        next=nxt,
                        hits=metric(text, "deppy_incremental_hits_total"),
                        replicas=f.router.replica_states(),
                        router=scrape(f.router.api_port))

        got = same(case)
        out = json.loads(got["drained"][1])["drain"]
        assert got["drained"][0] == 200 and out["handed_off"] >= 1
        assert got["owner"] != got["victim"] and got["next"][0] == 200
        assert (got["hits"] or 0) >= 1

    def test_trace_identity_survives_the_hop(self):
        headers = {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
                   "X-Deppy-Request-Id": "fleet-req-1",
                   "X-Deppy-Tenant": "fleet-tenant"}

        def case(f):
            doc = family_doc("traced")
            status, body, hdrs = request(f.router.api_port, "POST",
                                         "/v1/resolve", doc, headers)
            owner = f.replicas[f.addrs.index(f.router.target_for(
                f.s.ring.doc_affinity_keys(doc)[0]))]
            slo = json.loads(request(owner.api_port, "GET",
                                     "/debug/slo")[1])["slo"]
            return dict(status=status, body=body,
                        rid=hdrs.get("X-Deppy-Request-Id"),
                        trace=hdrs.get("traceparent", "")[:35],
                        tenants=sorted(slo))

        got = same(case)
        assert got["rid"] == "fleet-req-1" and "fleet-tenant" in got["tenants"]
        assert got["trace"] == "00-" + "ab" * 16

    def test_publish_and_preview_fan_out(self):
        delta = {"updates": [{"id": "pub0b0v1", "constraints": [
            {"type": "dependency", "ids": ["pub0b0v3"]}]}]}

        def case(f):
            for i in range(3):
                request(f.router.api_port, "POST", "/v1/resolve",
                        family_doc(f"pub{i}"))
            pub = request(f.router.api_port, "POST", "/v1/catalog/publish",
                          delta)[:2]
            pre = request(f.router.api_port, "POST", "/v1/resolve/preview",
                          delta)[:2]
            bad = request(f.router.api_port, "POST", "/v1/catalog/publish",
                          {"updates": "no"})[:2]
            return dict(pub=pub, pre=pre, bad=bad,
                        router=scrape(f.router.api_port))

        got = same(case)
        merged = json.loads(got["pub"][1])["publish"]
        assert merged["replicas"] == 3 and merged["errors"] == 0
        assert got["bad"][0] == 400
        assert got["router"]["samples"][
            "deppy_fleet_publish_fanout_total"] == "9"

    def test_dump_fans_out_to_every_replica(self):
        def case(f):
            out = request(f.router.api_port, "POST", "/debug/dump",
                          {"reason": "unit"})
            doc = json.loads(out[1])
            return out[0], sorted(doc["dumped"]), doc["errors"]

        status, dumped, errors = same(case, n=2)
        assert status == 200 and len(dumped) == 2 and errors == []

    def test_roundrobin_policy_and_detection_window(self):
        def case(f):
            order = [f.router.target_for(None) for _ in range(6)]
            body = request(f.router.api_port, "GET", "/fleet/replicas")[:2]
            return [f.addrs.index(a) for a in order], body, \
                f.s.router.detection_window_s(f.router)

        order, body, window = same(case, router={"policy": "roundrobin"})
        assert order == [0, 1, 2, 0, 1, 2] and window == 120.0
        with pytest.raises(ValueError):
            trouter.Router(bind_address="127.0.0.1:0", replicas="a:1",
                           policy="random")


# --------------------------------------------------- elastic membership


class TestElasticJoin:
    def test_join_streams_warm_state_then_flips_arcs(self):
        def case(f):
            joiner = f.server("joiner")
            j = addr(joiner)
            name, key = moving_family(f, j)
            for other in ("stay0", "stay1", name):
                request(f.router.api_port, "POST", "/v1/resolve",
                        family_doc(other))
            old = f.router.target_for(key)
            joined = request(f.router.api_port, "POST", "/fleet/join",
                             {"replica": j})[:2]
            now = f.router.target_for(key)
            members = request(f.router.api_port, "GET",
                              "/fleet/replicas")[:2]
            nxt = request(f.router.api_port, "POST", "/v1/resolve",
                          family_doc(name, state=1))[:2]
            text = request(joiner.api_port, "GET", "/metrics")[1].decode()
            return dict(old=old != j, now=now == j, joined=joined,
                        members=members, next=nxt,
                        hits=metric(text, "deppy_incremental_hits_total"),
                        router=scrape(f.router.api_port))

        got = same(case)
        out = json.loads(got["joined"][1])["join"]
        assert got["old"] and got["now"] and out["epoch"] == 2
        assert out["chunks"] >= 1 and out["warm_entries"] >= 1
        assert (got["hits"] or 0) >= 1

    def test_join_under_churn(self):
        def case(f):
            answers = {}
            stop = threading.Event()

            def churn():
                for state in range(40):
                    for fam in ("cfam0", "cfam1", "cfam2"):
                        doc = family_doc(fam, state)
                        s, b, _ = request(f.router.api_port, "POST",
                                          "/v1/resolve", doc)
                        answers[(fam, state)] = (s, b)
                    if stop.is_set() and state >= 5:
                        return

            t = threading.Thread(target=churn)
            t.start()
            joiner = f.server("churnjoiner")
            try:
                time.sleep(0.05)
                joined = request(f.router.api_port, "POST", "/fleet/join",
                                 {"replica": addr(joiner)})[0]
            finally:
                stop.set()
                t.join(WAIT_S * 2)
            assert not t.is_alive()
            return joined, answers

        (wj, want), (gj, got) = both(case)
        assert wj == gj == 200
        common = set(want) & set(got)
        assert len(common) >= 18
        assert all(got[k][0] == 200 for k in got)
        assert {k: got[k] for k in common} == {k: want[k] for k in common}

    def test_join_rejects_duplicate_and_malformed(self):
        def case(f):
            return [request(f.router.api_port, "POST", "/fleet/join",
                            body)[:2]
                    for body in ({"replica": f.addrs[0]}, {"replica": 42},
                                 {"replica": "noport"}, {"x": 1}, [1])] + [
                request(f.router.api_port, "POST", "/fleet/drain",
                        body)[:2]
                for body in ({"replica": "nobody:1"}, {"x": 1})] + [
                f.router.epoch]

        out = same(case)
        assert [s for s, _ in out[:-1]] == [400] * 7 and out[-1] == 1
        assert b"already a fleet member" in out[0][1]

    def test_join_stream_fault_aborts_without_flip(self):
        def case(f):
            joiner = f.server("badjoin")
            j = addr(joiner)
            name, key = moving_family(f, j)
            request(f.router.api_port, "POST", "/v1/resolve",
                    family_doc(name))
            owner = f.router.target_for(key)
            poison(f, "fleet.join_stream")
            try:
                out = request(f.router.api_port, "POST", "/fleet/join",
                              {"replica": j})[:2]
            finally:
                f.s.faults.configure_plan(None)
            return dict(out=out, epoch=f.router.epoch,
                        member=j in f.router.ring.replicas,
                        kept=f.router.target_for(key) == owner)

        got = same(case)
        assert got["out"][0] == 502 and b"join failed" in got["out"][1]
        assert (got["epoch"], got["member"], got["kept"]) == (1, False, True)

    def test_join_stream_resumes_after_one_fault(self):
        def case(f):
            joiner = f.server("resumejoin")
            name, _ = moving_family(f, addr(joiner))
            request(f.router.api_port, "POST", "/v1/resolve",
                    family_doc(name))
            poison(f, "fleet.join_stream", times=1)
            try:
                return request(f.router.api_port, "POST", "/fleet/join",
                               {"replica": addr(joiner)})[:2]
            finally:
                f.s.faults.configure_plan(None)

        status, body = same(case)
        assert status == 200 and json.loads(body)["join"]["epoch"] == 2

    def test_arc_flip_fault_aborts_without_flip(self):
        def case(f):
            joiner = f.server("flipfault")
            poison(f, "fleet.arc_flip")
            try:
                out = request(f.router.api_port, "POST", "/fleet/join",
                              {"replica": addr(joiner)})[:2]
            finally:
                f.s.faults.configure_plan(None)
            return out, f.router.epoch, addr(joiner) in f.router.ring.replicas

        out, epoch, member = same(case)
        assert out[0] == 502 and epoch == 1 and not member

    def test_elastic_drain_leaves_ring_and_bumps_epoch(self):
        def case(f):
            request(f.router.api_port, "POST", "/v1/resolve",
                    family_doc("dfam"))
            out = request(f.router.api_port, "POST", "/fleet/drain",
                          {"replica": f.addrs[1]})[:2]
            return out, f.s.membership.membership_view(f.router)

        out, view = same(case)
        assert out[0] == 200 and view["epoch"] == 2
        assert view["drained"] and view["drained"][0] not in view["members"]

    def test_drain_chaos_replica_stays_routable(self):
        def case(f):
            doc = family_doc("drainchaos")
            request(f.router.api_port, "POST", "/v1/resolve", doc)
            victim = f.router.target_for(f.s.ring.doc_affinity_keys(doc)[0])
            poison(f, "fleet.forward")
            try:
                out = request(f.router.api_port, "POST", "/fleet/drain",
                              {"replica": victim})[:2]
            finally:
                f.s.faults.configure_plan(None)
            again = request(f.router.api_port, "POST", "/v1/resolve",
                            doc)[:2]
            return dict(out=out, states=f.router.replica_states(),
                        epoch=f.router.epoch, again=again,
                        kept=f.router.target_for(
                            f.s.ring.doc_affinity_keys(doc)[0]) == victim)

        got = same(case)
        assert got["out"][0] == 502 and b"drain failed" in got["out"][1]
        assert got["epoch"] == 1 and got["kept"] and got["again"][0] == 200
        assert not any(s["drained"] for s in got["states"])

    def test_static_mode_surface(self):
        def case(f):
            static = f.new_router(membership="static", probe_interval_s=60.0)
            static.start()
            view = f.s.membership.membership_view(f.router)
            out = [request(static.api_port, method, path, body)[:2]
                   for path, method, body in (
                       ("/fleet/join", "POST", {"replica": f.addrs[0]}),
                       ("/fleet/sync", "POST", {"view": view}),
                       ("/fleet/policy", "GET", None),
                       ("/fleet/replicas", "GET", None),
                       ("/v1/resolve", "POST", family_doc("staticfam")))]
            return out, scrape(static.api_port), scrape(f.router.api_port)

        out, static_page, elastic_page = same(case)
        assert [s for s, _ in out] == [404, 404, 404, 200, 200]
        assert sorted(json.loads(out[3][1])) == ["policy", "replicas",
                                                 "vnodes"]
        assert "deppy_fleet_epoch" not in static_page["families"]
        assert elastic_page["samples"]["deppy_fleet_epoch"] == "1"
        with pytest.raises(ValueError):
            tmembership.membership_mode("sometimes")
        assert tmembership.membership_mode("OFF") == "static"


class TestPeerSync:
    @staticmethod
    def _peer(f):
        return f.new_router(peers=[f"127.0.0.1:{f.router.api_port}"],
                            probe_interval_s=60.0, sync_interval_s=0.0)

    def test_peer_adopts_join_and_drain_by_epoch(self):
        def case(f):
            peer = self._peer(f)
            joiner = f.server("syncjoiner")
            j = addr(joiner)
            request(f.router.api_port, "POST", "/fleet/join", {"replica": j})
            first = peer.sync_peers()
            after_join = f.s.membership.membership_view(peer)
            request(f.router.api_port, "POST", "/fleet/drain", {"replica": j})
            peer.sync_peers()
            return first, after_join, f.s.membership.membership_view(peer), \
                scrape(f.router.api_port)

        first, joined, drained, _ = same(case)
        assert first == {"peers": 1, "ok": 1, "errors": 0}
        assert joined["epoch"] == 2 and drained["epoch"] == 3
        assert drained["drained"] and drained["drained"][0] not in \
            drained["members"]

    def test_sync_converges_the_authoritative_router_too(self):
        def case(f):
            peer = self._peer(f)
            peer.epoch = 7
            peer.sync_peers()
            return f.router.epoch

        assert same(case) == 7

    def test_peer_sync_fault_counted_not_raised(self):
        def case(f):
            peer = self._peer(f)
            poison(f, "router.peer_sync")
            try:
                out = peer.sync_peers()
            finally:
                f.s.faults.configure_plan(None)
            return out, peer.epoch, timeless(peer.render_metrics())

        out, epoch, samples = same(case)
        assert out == {"peers": 1, "ok": 0, "errors": 1} and epoch == 1
        assert samples['deppy_fleet_peer_syncs_total{outcome="error"}'] == "1"

    def test_dead_verdicts_merge_only_at_current_epoch(self):
        def case(f):
            peer = self._peer(f)
            m = f.s.membership
            stale = m.membership_view(f.router)
            stale["dead"] = [f.addrs[2]]
            stale["epoch"] = 0
            a = m.reconcile(peer, stale)
            b = m.reconcile(peer, dict(stale, epoch=peer.epoch))
            return a, b, peer.replica_states()

        a, b, states = same(case)
        assert a["dead"] == [] and len(b["dead"]) == 1
        assert [s["dead"] for s in states] == [False, False, True]

    def test_same_epoch_tiebreak_converges_without_flapping(self):
        out = {}
        for side, s in SIDES.items():
            a = s.fleet.Router(bind_address="127.0.0.1:0",
                               replicas=["127.0.0.1:11", "127.0.0.1:12"],
                               probe_interval_s=60.0)
            b = s.fleet.Router(bind_address="127.0.0.1:0",
                               replicas=["127.0.0.1:11", "127.0.0.1:13"],
                               probe_interval_s=60.0)
            try:
                va = s.membership.membership_view(a)
                vb = s.membership.membership_view(b)
                s.membership.reconcile(a, vb)
                s.membership.reconcile(b, va)
                winner = list(a.ring.replicas)
                assert winner == list(b.ring.replicas)
                s.membership.reconcile(a, vb)
                s.membership.reconcile(a, va)
                assert list(a.ring.replicas) == winner
                out[side] = (winner, s.membership._tiebreak(winner))
            finally:
                a.shutdown()
                b.shutdown()
        assert out["port"] == out["reference"]

    def test_malformed_sync_view_answers_400(self):
        def case(f):
            return [request(f.router.api_port, "POST", "/fleet/sync",
                            {"view": view})[:2]
                    for view in (None, {}, {"epoch": "x", "members": ["a:1"]},
                                 {"epoch": 2, "members": []})]

        assert [s for s, _ in same(case)] == [400] * 4

    def test_probe_jitter_bounds(self):
        for s in SIDES.values():
            kw = dict(bind_address="127.0.0.1:0", replicas=["127.0.0.1:11"],
                      probe_interval_s=60.0)
            routers = [s.fleet.Router(probe_jitter=j, **kw)
                       for j in (0.5, 7.0, -1.0)]
            try:
                r, clamped, off = routers
                assert r._jittered(2.0, rng=lambda: 0.0) == 2.0
                assert r._jittered(2.0, rng=lambda: 1.0) == 3.0
                assert clamped.probe_jitter == 1.0
                assert off._jittered(2.0, rng=lambda: 1.0) == 2.0
            finally:
                for x in routers:
                    x.shutdown()

    def test_probe_loop_marks_dead_and_revives(self):
        """The background prober: a replica that stops answering goes
        dead after ``probe_failures`` probes, its arcs move; nothing else
        changes."""
        def case(f):
            victim = f.replicas[0]
            victim.shutdown()
            wait_for(lambda: f.router.replica_states()[0]["dead"],
                     "the prober's dead verdict")
            f.router.shutdown()
            return f.router.replica_states(), \
                timeless(f.router.render_metrics())

        states, samples = same(case, router={"probe_interval_s": 0.05,
                                             "probe_jitter": 0.0})
        assert [s["dead"] for s in states] == [True, False, False]
        assert samples['deppy_fleet_replica_transitions_total'
                       '{transition="down"}'] == "1"


class TestFleetAnnounce:
    def test_server_announces_on_start_and_leaves_on_shutdown(self):
        def case(f):
            srv = f.server("announcer", start=False,
                           fleet_router=f"127.0.0.1:{f.router.api_port}")
            a = addr(srv)
            srv.start()
            try:
                wait_for(lambda: a in f.router.ring.replicas,
                         "the announced join", limit_s=15.0)
                joined = f.router.epoch
            finally:
                srv.shutdown()
            return joined, f.s.membership.membership_view(f.router)

        joined, view = same(case)
        assert joined == 2 and view["epoch"] == 3
        assert view["drained"] and view["drained"][0] not in view["members"]


class TestScalePolicy:
    CASES = [({}, 0.0), ({"a:1": {"gold": 2.0}, "b:1": {"bulk": 1.5}}, 0.0),
             ({"a:1": {"gold": 2.0}, "b:1": {"bulk": 0.1}}, 0.0),
             ({"a:1": {"gold": 0.2}, "b:1": {"bulk": 0.1}}, 0.0),
             ({"a:1": {"gold": 0.2}, "b:1": {"bulk": 0.1}}, 3.0),
             ({"b:1": {"t": 2.0}, "a:1": {"t": 2.0}, "c:1": {"t": 0.1}}, 0.0),
             ({"a:1": {"t": 0.5}, "b:1": {}}, 0.0)]

    @pytest.mark.parametrize("burns,depth", CASES, ids=range(len(CASES)))
    def test_decide(self, burns, depth):
        assert tpolicy.decide(burns, depth, 1.0, 0.25) == \
            jpolicy.decide(burns, depth, 1.0, 0.25)
        assert tfleet.policy_decide is tpolicy.decide

    def test_policy_endpoint_reports_live_fleet(self, monkeypatch):
        monkeypatch.setenv("DEPPY_GPU_FLEET_BURN_UP", "junk")
        monkeypatch.setenv("DEPPY_TPU_FLEET_BURN_UP", "junk")

        def case(f):
            request(f.router.api_port, "POST", "/v1/resolve",
                    family_doc("polfam"))
            status, body, _ = request(f.router.api_port, "GET",
                                      "/fleet/policy")
            out = json.loads(body)["policy"]
            return status, {k: out[k] for k in (
                "decision", "target", "epoch", "replicas", "burn_up",
                "burn_down", "queue_depth", "warm_hit_ratio")}, \
                sorted(out["per_replica_burn"]), \
                timeless(f.router.render_metrics())

        status, out, burned, samples = same(case)
        assert status == 200 and out["epoch"] == 1 and out["replicas"] == 3
        assert out["burn_up"] == 1.0 and len(burned) == 3
        assert samples[
            f'deppy_fleet_policy_evals_total{{decision="{out["decision"]}"}}'
        ] == "1"


# ------------------------------------------------ sessions across a fleet


class TestFleetRouting:
    @staticmethod
    def _holder(f, sid):
        return next(s for s in f.replicas
                    if s.sessions is not None and sid in s.sessions._sessions)

    def test_ops_route_by_session_key_and_survive_drain(self):
        def case(f):
            s, body, _ = request(f.router.api_port, "POST", "/v1/session",
                                 catalog_doc("fl"))
            created = json.loads(body)["session"]
            sid, key = created.pop("id"), created["key"]
            op = f"/v1/session/{sid}/op"
            hdr = {"X-Deppy-Session": key}
            ops = [request(f.router.api_port, "POST", op, body, hdr)[:2]
                   for body in ({"op": "assume", "identifiers": ["flb1v0"]},
                                {"op": "resolve"})]
            holder = self._holder(f, sid)
            survivor = next(r for r in f.replicas if r is not holder)
            drained = request(f.router.api_port, "POST", "/fleet/drain",
                              {"replica": addr(holder)})[:2]
            active = survivor.sessions.active()
            again = request(f.router.api_port, "POST", op,
                            {"op": "resolve"}, hdr)[:2]
            return dict(created=(s, created), ops=ops, drained=drained,
                        active=active, again=again,
                        router=scrape(f.router.api_port))

        got = same(case, n=2, router={"probe_interval_s": 3600.0})
        assert got["created"][0] == 200 and got["drained"][0] == 200
        assert json.loads(got["drained"][1])["drain"]["sessions"] == 1
        assert got["active"] == 1 and got["again"][0] == 200
        assert json.loads(got["again"][1])["result"] == \
            json.loads(got["ops"][1][1])["result"]

    def test_dead_replica_surfaces_409_session_lost(self):
        def case(f):
            _, body, _ = request(f.router.api_port, "POST", "/v1/session",
                                 catalog_doc("dd"))
            created = json.loads(body)["session"]
            self._holder(f, created["id"]).shutdown()
            return request(f.router.api_port, "POST",
                           f"/v1/session/{created['id']}/op",
                           {"op": "resolve"},
                           {"X-Deppy-Session": created["key"]})[:2]

        status, body = same(case, n=2, router={"probe_interval_s": 3600.0})
        assert status == 409 and json.loads(body) == {"error": "session lost"}


# ------------------------------------------------------------------- obs


class TestFleetObs:
    def test_fleet_metrics_and_status(self):
        def case(f):
            for i in range(4):
                request(f.router.api_port, "POST", "/v1/resolve",
                        family_doc(f"fed{i}."))
            status, body, _ = request(f.router.api_port, "GET",
                                      "/fleet/metrics")
            text = body.decode()
            st = request(f.router.api_port, "GET", "/fleet/status")[:2]
            return status, families(text), timeless(text), st

        status, fams, samples, st = same(case, n=2)
        assert status == 200 and samples["deppy_fleet_queue_depth"] == "0"
        assert json.loads(st[1])["telemetry"]["ingested"] == {}

    def test_stream_to_router_builds_merged_sink(self, tmp_path):
        def case(f):
            sink = tmp_path / f"{f.side}.jsonl"
            router = f.new_router(probe_interval_s=60.0, obs_sink=str(sink))
            router.start()
            streamer = f.s.stream.TelemetryStreamer(
                f"127.0.0.1:{router.api_port}", replica="repA", flush_ms=20)
            streamer.start()
            try:
                s = request(router.api_port, "POST", "/v1/resolve",
                            family_doc("merged."))[0]

                def stamps():
                    if not sink.exists():
                        return set()
                    return {json.loads(line).get("replica")
                            for line in sink.read_text().splitlines()}

                wait_for(lambda: {"repA", "router"} <= stamps(),
                         "both stamps in the merged sink")
                ingested = json.loads(request(
                    router.api_port, "GET",
                    "/fleet/status")[1])["telemetry"]["ingested"]
            finally:
                streamer.close()
            return s, sorted(stamps()), ingested.get("repA", 0) >= 1

        assert same(case, n=1) == (200, ["repA", "router"], True)

    def test_routed_trace_tree_is_the_single_server_tree_plus_hop(
            self, tmp_path, capsys):
        """The reference's ``deppy trace --fleet`` rebuilds a routed
        request from each fleet's merged sink: one ``router.forward``
        root over the replica's tree, the same names on both."""
        from deppy_tpu import cli

        def case(f):
            sink = tmp_path / f"{f.side}-trace.jsonl"
            router = f.new_router(probe_interval_s=60.0, obs_sink=str(sink))
            router.start()
            s = request(router.api_port, "POST", "/v1/resolve",
                        family_doc("pin2."),
                        {"X-Deppy-Request-Id": "pin-routed"})[0]
            router.shutdown()
            return s, str(sink)

        (ws, wsink), (gs, gsink) = both(case, n=1)
        trees = []
        for path in (wsink, gsink):
            rc = cli.main(["trace", "--fleet", "pin-routed", "--file", path,
                           "--output", "json"])
            out = capsys.readouterr().out
            assert rc == 0, out
            trees.append(_skeleton(json.loads(out)))
        assert ws == gs == 200 and trees[1] == trees[0]
        assert len(trees[1]) == 1 and trees[1][0][0] == "router.forward"
        assert trees[1][0][1][0][0] == "service.request"

    def test_telemetry_without_aggregator_404(self):
        def case(f):
            return [request(f.router.api_port, "POST", "/fleet/telemetry",
                            {"replica": "x", "events": []})[:2],
                    request(f.router.api_port, "GET", "/nowhere")[:2],
                    request(f.router.api_port, "POST", "/nowhere", {})[:2]]

        assert [s for s, _ in same(case, n=1)] == [404] * 3


def _skeleton(doc: dict):
    """The span-name tree of a ``deppy trace --output json`` document
    (the reference suite's ``_trace_skeleton``)."""
    spans = doc["spans"]
    by_id = {sp["span_id"]: sp for sp in spans}
    children: dict = {}
    roots = []
    for sp in sorted(spans, key=lambda s: (s.get("ts", 0.0),
                                           s.get("name", ""))):
        parent = sp.get("parent_id")
        if parent not in by_id and sp.get("links"):
            parent = sp["links"][0].get("span_id")
        if parent in by_id:
            children.setdefault(parent, []).append(sp)
        else:
            roots.append(sp)

    def tree(sp):
        kids = tuple(tree(c) for c in sorted(
            children.get(sp["span_id"], []),
            key=lambda s: (s.get("ts", 0.0), s.get("name", ""))))
        return (sp["name"], kids)

    return [tree(sp) for sp in roots]


# ------------------------------------------------------------ route gossip


class TestRouteGossip:
    def test_live_rows_fan_out_and_roll_up(self, tmp_path):
        """A streamed ``route_learned`` row (first-hand) re-broadcasts to
        every replica's ``POST /v1/routes/learned``; a gossip-sourced
        one does not; ``/fleet/metrics`` rolls the route families up."""
        batch = {"replica": "rep0", "events": [
            {"kind": "route_learned", "source": "live",
             "key": "portfolio.xs", "row": "host,device"},
            {"kind": "route_learned", "source": "gossip",
             "key": "portfolio.s", "row": "host"}]}

        def case(f):
            sink = tmp_path / f"{f.side}-gossip.jsonl"
            router = f.new_router(probe_interval_s=60.0, obs_sink=str(sink))
            router.start()
            out = request(router.api_port, "POST", "/fleet/telemetry",
                          batch)[:2]
            wait_for(lambda: "deppy_fleet_route_gossip_total" in
                     router.render_metrics(), "the gossip counter")
            echo = router.gossip_routes(dict(batch, events=batch["events"][1:]))
            text = request(router.api_port, "GET",
                           "/fleet/metrics")[1].decode()
            return out, echo, timeless(router.render_metrics()), \
                families(text), timeless(text)

        out, echo, own, fams, samples = same(
            case, replica={"route_learn": "on"})
        assert out == (200, b'{"accepted": 2}') and echo == 0
        assert own["deppy_fleet_route_gossip_total"] == "3"
        assert samples["deppy_fleet_route_learned_rows"] == "3"
        assert "deppy_fleet_route_learned_rows" in fams
