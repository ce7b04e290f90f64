"""The affinity router front-end (copy of ``deppy_tpu/fleet/router.py:1-1293``).

A host process speaking the service's HTTP surface — clients point at
the router instead of a replica and change nothing else:

  * ``POST /v1/resolve`` routes per problem over the consistent-hash
    ring (:mod:`.ring`), so a family's churn stream always lands on the
    replica holding its warm seeds.  A request whose problems map to
    one replica forwards byte-for-byte; a mixed batch splits into
    per-replica sub-batches and the results merge back in input order
    — either way the body equals what a single replica would serve.
  * ``POST /v1/catalog/publish`` fans out to EVERY live replica (each
    replica's speculative tier must see the delta;
    ``deppy_fleet_publish_fanout_total``), and ``POST
    /v1/resolve/preview`` fans out and concatenates the previews.
  * ``POST /v1/session`` routes by the catalog's family key, and
    ``/v1/session/<id>/op`` by the ``X-Deppy-Session`` key; an op whose
    holder died answers 409 "session lost".
  * ``GET /metrics``, ``/fleet/replicas``, ``/fleet/status``,
    ``/fleet/metrics`` (every replica's scrape merged under a
    ``replica`` label, fleet rollups on top) and ``/fleet/policy``
    (:mod:`.policy`); ``/debug/traces`` and ``/debug/dump`` fan out.
  * ``POST /fleet/drain`` runs the warm-state handoff (split by family
    affinity across the arc inheritors), ``/fleet/join`` a runtime join
    (:mod:`.membership`), ``/fleet/sync`` the peer gossip, and
    ``/fleet/telemetry`` ingests replica-streamed events into the
    router's :class:`deppy_tpu_torch.obs.Aggregator` (its own hop spans
    stamped ``router``), whose ``route_learned`` rows re-broadcast to
    every replica's ``POST /v1/routes/learned``.

**Health.**  A background prober hits every replica on an interval
(with jitter); ``probe_failures`` consecutive transport failures open
that replica's breaker (its arcs reassign), a later successful probe
closes it.  A transport failure on a live forward charges the same
breaker and the request retries ONCE on the key's ring successor.

The router runs on the host and has no device: its replicas are port
``Server`` instances, which default to the card.  Fault points
``fleet.forward`` and ``router.peer_sync``.  The knobs are
``DEPPY_GPU_FLEET_REPLICAS``, ``_VNODES`` (64), ``_PROBE_INTERVAL_S``
(2.0), ``_PROBE_FAILURES`` (3), ``_PROBE_JITTER`` (0.2), ``_PEERS``,
``_SYNC_INTERVAL_S`` (2.0) and ``DEPPY_GPU_OBS_SINK``, each parsed as
the reference parses its ``DEPPY_TPU_*`` (``config.env_str``,
``config.env_int(strict=False)``, ``faults.env_float(warn=True)``).  The
lock is a plain :class:`threading.Lock` (lockdep is ROADMAP A7.2), as are
the port's other locks; ``deppy route`` as a CLI verb and its flags are
A7.2 too.
"""

from __future__ import annotations

import json
import random
import threading
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Tuple

from .. import config, faults, telemetry
from .ring import DEFAULT_VNODES, HashRing, doc_affinity_keys
from .snapshot import SnapshotFormatError, split_snapshot, verify_snapshot

DEFAULT_PROBE_INTERVAL_S = 2.0
DEFAULT_PROBE_FAILURES = 3
DEFAULT_PROBE_JITTER = 0.2
DEFAULT_SYNC_INTERVAL_S = 2.0
# Forwarded solves can legitimately take minutes (budget escalation on
# a cold device path); transport-level hangs are the prober's job.
FORWARD_TIMEOUT_S = 600.0
PROBE_TIMEOUT_S = 2.0

# Request headers forwarded to replicas (trace identity must survive
# the hop, so a fleet-routed request reconstructs as ONE tree from the
# merged sink), and response headers echoed back.
FORWARD_HEADERS = ("Content-Type", "traceparent", "X-Deppy-Request-Id",
                   "X-Deppy-Tenant", "X-Deppy-Deadline-S",
                   "X-Deppy-Timings", "X-Deppy-Session")
ECHO_HEADERS = ("X-Deppy-Request-Id", "traceparent", "Retry-After")


class _Replica:
    """One replica's health/breaker state (guarded by Router._lock)."""

    __slots__ = ("address", "failures", "dead", "drained")

    def __init__(self, address: str):
        self.address = address
        self.failures = 0
        self.dead = False
        self.drained = False


def _parse_replicas(spec) -> List[str]:
    if isinstance(spec, str):
        spec = [s for s in (t.strip() for t in spec.split(",")) if s]
    out = list(dict.fromkeys(spec or []))
    if not out:
        raise ValueError(
            "fleet router requires at least one replica address "
            "(replicas=host:port[,host:port...] / "
            "DEPPY_GPU_FLEET_REPLICAS)")
    return out


def _split_host_port(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host or "127.0.0.1", int(port)


def _peer_exchange(peer: str, payload: bytes,
                   timeout: float = PROBE_TIMEOUT_S * 2
                   ) -> Tuple[int, bytes]:
    """One ``POST /fleet/sync`` exchange with a peer router."""
    host, port = _split_host_port(peer)
    conn = HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/fleet/sync", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Router:
    """The replica-fleet affinity router."""

    def __init__(
        self,
        bind_address: str = ":8079",
        replicas=None,
        vnodes: Optional[int] = None,
        probe_interval_s: Optional[float] = None,
        probe_failures: Optional[int] = None,
        policy: str = "affinity",
        max_body_bytes: int = 8 * 1024 * 1024,
        obs_sink: Optional[str] = None,
        membership: Optional[str] = None,
        peers=None,
        probe_jitter: Optional[float] = None,
        sync_interval_s: Optional[float] = None,
    ):
        if replicas is None:
            replicas = config.env_str("DEPPY_GPU_FLEET_REPLICAS")
        addresses = _parse_replicas(replicas)
        if vnodes is None:
            vnodes = config.env_int("DEPPY_GPU_FLEET_VNODES",
                                    DEFAULT_VNODES, strict=False)
        if probe_interval_s is None:
            probe_interval_s = faults.env_float(
                "DEPPY_GPU_FLEET_PROBE_INTERVAL_S",
                DEFAULT_PROBE_INTERVAL_S, warn=True)
        if probe_failures is None:
            probe_failures = config.env_int(
                "DEPPY_GPU_FLEET_PROBE_FAILURES", DEFAULT_PROBE_FAILURES,
                strict=False)
        if policy not in ("affinity", "roundrobin"):
            raise ValueError(
                f"unknown routing policy {policy!r} "
                "(want 'affinity' or 'roundrobin')")
        # ``roundrobin`` exists for the fleet bench only: it is the
        # warm-state-destroying baseline the affinity ring is measured
        # against.
        self.policy = policy
        self.ring = HashRing(addresses, vnodes=vnodes)
        self.probe_interval_s = max(float(probe_interval_s or 0.0), 0.0)
        self.probe_failures = max(int(probe_failures), 1)
        self.max_body_bytes = max_body_bytes
        # Elastic membership: 'elastic' arms runtime joins
        # (POST /fleet/join), drain-as-leave ring removal, peer gossip
        # (POST /fleet/sync) and GET /fleet/policy; 'static'
        # (DEPPY_GPU_FLEET=static) keeps the static-ring surface byte
        # for byte — those endpoints 404 and the epoch
        # never surfaces.
        from .membership import membership_mode

        self.membership = membership_mode(membership)
        self.epoch = 1
        if peers is None:
            peers = config.env_str("DEPPY_GPU_FLEET_PEERS")
        if isinstance(peers, str):
            peers = [p for p in (t.strip() for t in peers.split(","))
                     if p]
        self.peers: List[str] = list(dict.fromkeys(peers or []))
        if probe_jitter is None:
            probe_jitter = faults.env_float(
                "DEPPY_GPU_FLEET_PROBE_JITTER", DEFAULT_PROBE_JITTER,
                warn=True)
        self.probe_jitter = min(max(float(probe_jitter or 0.0), 0.0),
                                1.0)
        if sync_interval_s is None:
            sync_interval_s = faults.env_float(
                "DEPPY_GPU_FLEET_SYNC_INTERVAL_S",
                DEFAULT_SYNC_INTERVAL_S, warn=True)
        self.sync_interval_s = max(float(sync_interval_s or 0.0), 0.0)
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {
            a: _Replica(a) for a in addresses}
        self._rr_next = 0
        self.registry = telemetry.Registry()
        r = self.registry
        self._c_routed = r.counter(
            "deppy_fleet_routed_total",
            "Problems routed, by replica.", labelname="replica")
        self._c_requests = r.counter(
            "deppy_fleet_requests_total",
            "Requests handled by the router, by endpoint.",
            labelname="endpoint")
        self._c_retries = r.counter(
            "deppy_fleet_retries_total",
            "Forwards retried on the ring successor after a replica "
            "transport failure.")
        self._c_probe_failures = r.counter(
            "deppy_fleet_probe_failures_total",
            "Health-probe transport failures, by replica.",
            labelname="replica")
        self._c_transitions = r.counter(
            "deppy_fleet_replica_transitions_total",
            "Replica breaker transitions (up->down and down->up).",
            labelname="transition").preset("down", "up")
        self._c_fanout = r.counter(
            "deppy_fleet_publish_fanout_total",
            "Per-replica publish/preview fan-out forwards.")
        self._c_drains = r.counter(
            "deppy_fleet_drains_total",
            "Drain handoffs orchestrated (POST /fleet/drain).")
        self._c_handoff = r.counter(
            "deppy_fleet_handoff_entries_total",
            "Warm-state entries (index entries + cache seeds) handed "
            "off to arc inheritors during drains.")
        # Elastic-only families register only in elastic mode so the
        # static /metrics page carries none of them.
        self._c_joins = self._c_join_chunks = None
        self._c_peer_syncs = self._c_policy_evals = None
        if self.elastic:
            self._c_joins = r.counter(
                "deppy_fleet_joins_total",
                "Runtime replica joins committed (atomic arc flips "
                "after a complete warm-state stream).")
            self._c_join_chunks = r.counter(
                "deppy_fleet_join_chunks_total",
                "Checksummed warm-state chunks streamed to joining "
                "replicas.")
            self._c_peer_syncs = r.counter(
                "deppy_fleet_peer_syncs_total",
                "Membership gossip exchanges with peer routers, by "
                "outcome.", labelname="outcome").preset("ok", "error")
            self._c_policy_evals = r.counter(
                "deppy_fleet_policy_evals_total",
                "Autoscale policy evaluations (GET /fleet/policy), by "
                "decision.", labelname="decision")
        # Fleet observability plane: ``obs_sink`` /
        # DEPPY_GPU_OBS_SINK names the merged fleet JSONL sink.
        # Replicas batch-push their sink events to POST /fleet/telemetry
        # and each lands replica-stamped; the router's OWN events
        # (replica up/down faults on the default registry,
        # router.forward spans on this registry) join the same sink via
        # forwarders stamped "router", so a fleet trace query rebuilds
        # a routed request as one tree from this single file.
        if obs_sink is None:
            obs_sink = config.env_str("DEPPY_GPU_OBS_SINK")
        self.aggregator = None
        self._obs_forwarders: list = []
        if obs_sink:
            from ..obs.aggregate import ROUTER_REPLICA, Aggregator

            self.aggregator = Aggregator(obs_sink, registry=self.registry)

            def _to_sink(ev, _agg=self.aggregator):
                _agg.ingest_event(ROUTER_REPLICA, ev)

            for reg in (self.registry, telemetry.default_registry()):
                reg.add_forwarder(_to_sink)
                self._obs_forwarders.append((reg, _to_sink))
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._sync_thread: Optional[threading.Thread] = None
        from ..service import _make_http_server, _parse_addr

        self._api = _make_http_server(_parse_addr(bind_address),
                                      _router_handler(self))
        self._threads: list = []

    # ------------------------------------------------------------ state

    @property
    def api_port(self) -> int:
        return self._api.server_address[1]

    @property
    def elastic(self) -> bool:
        return self.membership == "elastic"

    def _unroutable_locked(self) -> frozenset:
        return frozenset(a for a, st in self._replicas.items()
                         if st.dead or st.drained)

    def live_replicas(self) -> List[str]:
        with self._lock:
            dead = self._unroutable_locked()
            ring = self.ring
        return [a for a in ring.replicas if a not in dead]

    def target_for(self, key: Optional[str],
                   exclude=()) -> Optional[str]:
        """The replica serving ``key`` right now (health- and
        drain-aware).  Round-robin mode ignores the key — that is the
        point of the baseline."""
        with self._lock:
            dead = self._unroutable_locked() | frozenset(exclude)
            # Capture the ring inside the critical section: an elastic
            # arc flip swaps ``self.ring`` wholesale, and routing must
            # see one consistent (ring, health) pair.
            ring = self.ring
            if self.policy == "roundrobin":
                live = [a for a in ring.replicas if a not in dead]
                if not live:
                    return None
                target = live[self._rr_next % len(live)]
                self._rr_next += 1
                return target
        return ring.route(key, exclude=dead)

    def note_transport_failure(self, address: str) -> None:
        """A probe or live forward could not reach ``address``: charge
        its breaker; at the threshold the replica goes dead and its
        arcs reassign."""
        self._c_probe_failures.inc(label=address)
        with self._lock:
            st = self._replicas.get(address)
            if st is None or st.drained:
                return
            st.failures += 1
            if st.failures < self.probe_failures or st.dead:
                return
            st.dead = True
        self._c_transitions.inc(label="down")
        telemetry.default_registry().event(
            "fault", fault="fleet_replica_down", replica=address)

    def note_transport_success(self, address: str) -> None:
        with self._lock:
            st = self._replicas.get(address)
            if st is None:
                return
            st.failures = 0
            was_dead, st.dead = st.dead, False
        if was_dead:
            self._c_transitions.inc(label="up")
            telemetry.default_registry().event(
                "fault", fault="fleet_replica_up", replica=address)

    def replica_states(self) -> List[dict]:
        with self._lock:
            return [{"replica": st.address,
                     "dead": st.dead,
                     "drained": st.drained,
                     "consecutive_failures": st.failures}
                    for st in self._replicas.values()]

    # --------------------------------------------------------- transport

    def forward(self, address: str, method: str, path: str,
                body: Optional[bytes], headers: Optional[dict] = None,
                timeout: float = FORWARD_TIMEOUT_S):
        """One HTTP exchange with a replica; returns ``(status, body,
        headers)``.  Transport errors raise ``OSError`` AFTER charging
        the replica's breaker; HTTP error statuses are the replica's
        answer and pass through untouched."""
        faults.inject("fleet.forward")
        host, port = _split_host_port(address)
        try:
            conn = HTTPConnection(host, port, timeout=timeout)
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            hdrs = {k: v for k, v in resp.getheaders()}
            status = resp.status
            conn.close()
        except OSError:
            self.note_transport_failure(address)
            raise
        self.note_transport_success(address)
        return status, data, hdrs

    # ----------------------------------------------------------- probing

    def _jittered(self, base: float, rng=random.random) -> float:
        """One cycle's sleep with jitter (the lease's ``renew_jitter``
        pattern): ``base`` plus a random
        fraction of it, so a fleet of routers booted together does not
        thunder every replica (or peer) in lockstep phase."""
        return base + base * self.probe_jitter * rng()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self._jittered(self.probe_interval_s)):
            with self._lock:
                targets = [st.address for st in self._replicas.values()
                           if not st.drained]
            for address in targets:
                if self._stop.is_set():
                    return
                host, port = _split_host_port(address)
                try:
                    conn = HTTPConnection(host, port,
                                          timeout=PROBE_TIMEOUT_S)
                    # Any HTTP response — the path 404s on the API port
                    # — proves the process serves; readiness semantics
                    # stay with the replica's own probe listener.
                    conn.request("GET", "/healthz")
                    conn.getresponse().read()
                    conn.close()
                except OSError:
                    self.note_transport_failure(address)
                else:
                    self.note_transport_success(address)

    # ---------------------------------------------------- peer gossip

    def _sync_loop(self) -> None:
        while not self._stop.wait(self._jittered(self.sync_interval_s)):
            self.sync_peers()

    def sync_peers(self) -> dict:
        """One gossip round: push our membership view to
        every peer router and reconcile each answering view, so a
        join/leave committed on either side converges on both.
        Deliberately NOT :meth:`forward`: peers are not replicas — a
        down peer must not charge any replica breaker or trip the
        ``fleet.forward`` fault point."""
        from .membership import membership_view, reconcile

        payload = json.dumps({"view": membership_view(self)}).encode()
        out = {"peers": len(self.peers), "ok": 0, "errors": 0}
        for peer in self.peers:
            if self._stop.is_set():
                break
            try:
                faults.inject("router.peer_sync")
                status, body = _peer_exchange(peer, payload)
            except (OSError, faults.InjectedFault):
                if self._c_peer_syncs is not None:
                    self._c_peer_syncs.inc(label="error")
                out["errors"] += 1
                continue
            ok = False
            if status == 200:
                try:
                    remote = json.loads(body).get("view")
                    reconcile(self, remote)
                    ok = True
                except (ValueError, json.JSONDecodeError):
                    pass  # malformed peer answer: counted, next round
            if self._c_peer_syncs is not None:
                self._c_peer_syncs.inc(label="ok" if ok else "error")
            out["ok" if ok else "errors"] += 1
        return out

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        t = threading.Thread(target=self._api.serve_forever,
                             kwargs={"poll_interval": 0.05},
                             name="deppy-route", daemon=True)
        t.start()
        self._threads.append(t)
        if self.probe_interval_s > 0:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="deppy-route-probe",
                daemon=True)
            self._probe_thread.start()
        if self.elastic and self.peers and self.sync_interval_s > 0:
            self._sync_thread = threading.Thread(
                target=self._sync_loop, name="deppy-route-sync",
                daemon=True)
            self._sync_thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._threads:
            self._api.shutdown()
        self._api.server_close()
        self._threads = []
        t = self._probe_thread
        if t is not None:
            t.join(PROBE_TIMEOUT_S + self.probe_interval_s + 1.0)
            self._probe_thread = None
        t = self._sync_thread
        if t is not None:
            t.join(PROBE_TIMEOUT_S * 2 + self.sync_interval_s + 1.0)
            self._sync_thread = None
        for reg, fn in self._obs_forwarders:
            reg.remove_forwarder(fn)
        self._obs_forwarders = []
        if self.aggregator is not None:
            self.aggregator.close()
            self.aggregator = None

    def dump_fanout(self, body: Optional[bytes] = None) -> dict:
        """POST /debug/dump to every live replica: one
        operator signal — SIGUSR2 on the router, or its /debug/dump
        endpoint — flushes every replica's flight recorder into its
        sink/stream.  Returns the per-replica dump counts."""
        dumped: Dict[str, int] = {}
        errors: List[str] = []
        for address in self.live_replicas():
            try:
                status, data, _ = self.forward(
                    address, "POST", "/debug/dump", body or b"{}",
                    {"Content-Type": "application/json"},
                    timeout=PROBE_TIMEOUT_S * 5)
            except OSError:
                errors.append(address)
                continue
            if status != 200:
                errors.append(address)
                continue
            try:
                dumped[address] = int(json.loads(data).get("dumped", 0))
            except (ValueError, json.JSONDecodeError):
                dumped[address] = 0
        return {"dumped": dumped, "errors": errors}

    def gossip_routes(self, doc) -> int:
        """Fleet-wide route gossip: scan one ingested
        telemetry batch for live-learned routing rows and fan them out
        to every live replica's ``POST /v1/routes/learned``.  Only
        first-hand (``source == "live"``) adoptions re-broadcast —
        gossip-sourced ones stay put, and the learner's idempotent
        adopt terminates the echo at the origin — so a row crosses the
        fleet exactly once per discovery.  Returns replicas that
        accepted."""
        if not isinstance(doc, dict):
            return 0
        rows: Dict[str, str] = {}
        origin = doc.get("replica")
        for ev in doc.get("events") or []:
            if not isinstance(ev, dict) \
                    or ev.get("kind") != "route_learned" \
                    or ev.get("source") != "live":
                continue
            key, row = ev.get("key"), ev.get("row")
            if isinstance(key, str) and isinstance(row, str):
                rows[key] = row
        if not rows:
            return 0
        body = json.dumps({
            "rows": rows,
            "origin": origin if isinstance(origin, str) else None,
        }).encode("utf-8")
        accepted = 0
        for address in self.live_replicas():
            try:
                status, _, _ = self.forward(
                    address, "POST", "/v1/routes/learned", body,
                    {"Content-Type": "application/json"},
                    timeout=PROBE_TIMEOUT_S * 5)
            except OSError:
                continue
            if status == 200:
                accepted += 1
        if accepted:
            self.registry.counter(
                "deppy_fleet_route_gossip_total",
                "Learned routing-row broadcasts accepted by fleet "
                "replicas.").inc(accepted)
        return accepted

    # ------------------------------------------------------------- drain

    def drain(self, address: str) -> dict:
        """The warm-state handoff: snapshot the draining replica, split
        by family affinity across the surviving ring, deliver each
        shard, retire the replica from routing.  Raises ``ValueError``
        on an unknown replica, ``OSError``/:class:`SnapshotFormatError`
        when the snapshot cannot be fetched or verified (the replica
        stays routable — a failed drain must not silently blackhole an
        arc)."""
        with self._lock:
            st = self._replicas.get(address)
            if st is None:
                raise ValueError(f"unknown replica {address!r}")
            exclude = self._unroutable_locked() | {address}
        status, body, _ = self.forward(address, "GET", "/debug/warmstate",
                                       None)
        if status != 200:
            raise OSError(
                f"replica {address} warm-state export failed "
                f"(HTTP {status})")
        snapshot = verify_snapshot(json.loads(body))
        shards = split_snapshot(
            snapshot,
            lambda aff: self.ring.route(aff, exclude=exclude))
        delivered: Dict[str, dict] = {}
        entries = 0
        for owner, shard in shards.items():
            payload = json.dumps(shard).encode()
            s2, b2, _ = self.forward(
                owner, "POST", "/debug/warmstate", payload,
                {"Content-Type": "application/json"})
            if s2 != 200:
                raise OSError(
                    f"inheritor {owner} rejected warm-state shard "
                    f"(HTTP {s2}): {b2[:200]!r}")
            delivered[owner] = json.loads(b2).get("imported", {})
            entries += len(shard["index"]) + len(shard["cache"]) \
                + len(shard.get("sessions") or [])
        with self._lock:
            st.drained = True
            if self.elastic:
                survivors = [a for a in self.ring.replicas
                             if a != address]
                if survivors:
                    # Leave = drain: in elastic mode the
                    # drained replica leaves the ring itself — not just
                    # route-time exclusion — and the membership epoch
                    # advances so peer routers gossip the removal.
                    # Routing outcomes are unchanged (a drained member
                    # was already excluded on every walk).
                    self.ring = HashRing(survivors,
                                         vnodes=self.ring.vnodes)
                    self.epoch += 1
        self._c_drains.inc()
        self._c_handoff.inc(entries)
        telemetry.default_registry().event(
            "fault", fault="fleet_drain_handoff", replica=address,
            entries=entries, recipients=sorted(delivered))
        out = {"replica": address,
               "index_entries": len(snapshot["index"]),
               "cache_seeds": len(snapshot["cache"]),
               "handed_off": entries,
               "recipients": delivered}
        if "sessions" in snapshot:
            # Conditional like the snapshot section itself: drains of
            # session-free replicas keep the session-free body.
            out["sessions"] = len(snapshot["sessions"])
        return out

    # ------------------------------------------------------------ metrics

    def render_metrics(self) -> str:
        lines = self.registry.render_lines()
        states = self.replica_states()
        lines.append("# HELP deppy_fleet_replica_up Replica breaker "
                     "verdict: 1 = routable, 0 = dead or drained.")
        lines.append("# TYPE deppy_fleet_replica_up gauge")
        for st in states:
            up = 0 if (st["dead"] or st["drained"]) else 1
            lines.append(
                f'deppy_fleet_replica_up{{replica="{st["replica"]}"}} '
                f"{up}")
        if self.elastic:
            # Gated so the static-mode page carries no epoch (the
            # off-switch pin).
            lines.append("# HELP deppy_fleet_epoch Monotonic membership"
                         " epoch — increments on every committed "
                         "join/leave arc flip (and on gossip adoption "
                         "of a newer peer view).")
            lines.append("# TYPE deppy_fleet_epoch gauge")
            with self._lock:
                lines.append(f"deppy_fleet_epoch {self.epoch}")
        return "\n".join(lines) + "\n"


def _router_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        # ------------------------------------------------------ plumbing

        def _send(self, status: int, body: bytes,
                  ctype: str = "application/json",
                  extra: Optional[dict] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, status: int, doc: dict) -> None:
            self._send(status, json.dumps(doc).encode())

        def _read_body(self) -> Optional[bytes]:
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = -1
            if length < 0 or length > router.max_body_bytes:
                self._send_json(413 if length > 0 else 400,
                                {"error": "invalid or oversized body"})
                return None
            return self.rfile.read(length)

        # traceparent naming the router hop span as parent;
        # set only while an aggregator is armed, so disarmed forwards
        # stay byte-identical.
        _hop_traceparent = None

        def _fwd_headers(self) -> dict:
            h = {k: self.headers[k] for k in FORWARD_HEADERS
                 if self.headers.get(k) is not None}
            if self._hop_traceparent:
                h["traceparent"] = self._hop_traceparent
            return h

        def _relay(self, status: int, body: bytes, hdrs: dict) -> None:
            self._send(status, body,
                       hdrs.get("Content-Type", "application/json"),
                       {k: hdrs[k] for k in ECHO_HEADERS if k in hdrs})

        def _forward_with_retry(self, key, path: str, body: bytes):
            """Route ``key``, forward, and on a TRANSPORT failure retry
            once on the ring successor (the replica that inherits the
            key's arc).  Returns the relayed (status, body, headers)
            plus the serving replica, or None after sending the
            no-replica 503."""
            headers = self._fwd_headers()
            target = router.target_for(key)
            tried: List[str] = []
            while target is not None:
                try:
                    out = router.forward(target, "POST", path, body,
                                         headers)
                except OSError:
                    tried.append(target)
                    if len(tried) > 1:
                        break
                    router._c_retries.inc()
                    target = router.target_for(key, exclude=tried)
                    continue
                return out + (target,)
            self._send_json(503, {
                "error": "fleet: no replica reachable",
                "retry_after_s": max(router.probe_interval_s, 1.0)})
            return None

        # ------------------------------------------------------ endpoints

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._send(200, router.render_metrics().encode(),
                           "text/plain; version=0.0.4")
            elif path == "/fleet/replicas":
                doc = {
                    "policy": router.policy,
                    "vnodes": router.ring.vnodes,
                    "replicas": router.replica_states()}
                if router.elastic:
                    # Appended after the static keys so the static-mode
                    # body stays byte-identical (the off-switch pin).
                    from .membership import membership_view

                    view = membership_view(router)
                    doc["membership"] = router.membership
                    doc["epoch"] = view["epoch"]
                    doc["members"] = view["members"]
                    doc["peers"] = router.peers
                self._send_json(200, doc)
            elif path == "/fleet/policy":
                self._policy()
            elif path == "/fleet/metrics":
                # Metrics federation: every live replica
                # scraped concurrently, families merged under the
                # `replica` label, fleet rollups on top.
                router._c_requests.inc(label="fleet_metrics")
                from ..obs import federate

                self._send(200,
                           federate.render_fleet_metrics(router).encode(),
                           "text/plain; version=0.0.4")
            elif path == "/fleet/status":
                router._c_requests.inc(label="fleet_status")
                agg = router.aggregator
                self._send_json(200, {
                    "policy": router.policy,
                    "vnodes": router.ring.vnodes,
                    "replicas": router.replica_states(),
                    "telemetry": {
                        "ingested": agg.counts() if agg else {}}})
            elif path == "/debug/traces":
                self._traces()
            else:
                self._send_json(404, {"error": "not found"})

        def _policy(self):
            """SLO-burn autoscale recommendation: scrape the
            fleet, run the policy, recommend.  Execution stays
            operator-driven — this endpoint never mutates membership."""
            if not router.elastic:
                self._send_json(404, {"error": "not found"})
                return
            router._c_requests.inc(label="policy")
            from .policy import evaluate

            self._send_json(200, {"policy": evaluate(router)})

        def _traces(self):
            """Cross-replica trace lookup: only the replica
            that served a request retains it in its flight recorder, so
            the query fans out and the first hit is relayed."""
            router._c_requests.inc(label="traces")
            last = None
            for address in router.live_replicas():
                try:
                    out = router.forward(address, "GET", self.path, None,
                                         timeout=PROBE_TIMEOUT_S * 5)
                except OSError:
                    continue
                if out[0] == 200:
                    self._relay(*out)
                    return
                last = out
            if last is not None:
                self._relay(*last)
            else:
                self._send_json(503, {
                    "error": "fleet: no replica reachable",
                    "retry_after_s": max(router.probe_interval_s, 1.0)})

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            if path == "/v1/resolve":
                self._resolve()
            elif path in ("/v1/catalog/publish", "/v1/resolve/preview"):
                self._fan_out(path)
            elif path == "/v1/session" or path.startswith("/v1/session/"):
                self._session(path)
            elif path == "/fleet/drain":
                self._drain()
            elif path == "/fleet/join":
                self._join()
            elif path == "/fleet/sync":
                self._sync()
            elif path == "/fleet/telemetry":
                self._telemetry()
            elif path == "/debug/dump":
                router._c_requests.inc(label="dump")
                raw = self._read_body()
                if raw is None:
                    return
                self._send_json(200, router.dump_fanout(raw))
            else:
                self._send_json(404, {"error": "not found"})

        def _telemetry(self):
            """Replica-pushed telemetry batches.  404 with no
            aggregator armed — the streamer counts the rejection and
            drops the batch; serving is never in the loop."""
            if router.aggregator is None:
                self._send_json(404, {"error": "not found"})
                return
            router._c_requests.inc(label="telemetry")
            raw = self._read_body()
            if raw is None:
                return
            try:
                doc = json.loads(raw or b"null")
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(400,
                                {"error": f"invalid JSON body: {e}"})
                return
            accepted, err = router.aggregator.ingest(doc)
            if err is not None:
                self._send_json(400, {"error": err})
                return
            if accepted:
                # Route gossip rides the same push: any
                # live-learned routing rows in this batch fan out to
                # the fleet off-thread — a replica's streamer flush
                # must never block on N peer round-trips.
                threading.Thread(
                    target=router.gossip_routes, args=(doc,),
                    name="route-gossip", daemon=True).start()
            self._send_json(200, {"accepted": accepted})

        def _resolve(self):
            router._c_requests.inc(label="resolve")
            raw = self._read_body()
            if raw is None:
                return
            if router.aggregator is not None:
                # Router hop span: adopt (or mint) the
                # request's trace, open router.forward on the router's
                # registry, and forward a traceparent naming the hop as
                # parent — each replica's service.request root nests
                # under it, so the merged sink reconstructs the routed
                # request as ONE span tree.
                ctx = telemetry.trace.context_from_headers(
                    self.headers.get("traceparent"),
                    self.headers.get("X-Deppy-Request-Id"))
                with telemetry.trace.activate(ctx), \
                        router.registry.span(
                            "router.forward", path="/v1/resolve",
                            request_id=ctx.request_id) as sp:
                    if sp.span_id:
                        self._hop_traceparent = (
                            f"00-{ctx.trace_id}-{sp.span_id}-01")
                    try:
                        self._resolve_routed(raw, sp)
                    finally:
                        self._hop_traceparent = None
                return
            self._resolve_routed(raw, None)

        def _resolve_routed(self, raw: bytes, sp) -> None:
            try:
                doc = json.loads(raw or b"null")
                keys = doc_affinity_keys(doc)
            except (ValueError, json.JSONDecodeError):
                # Unparseable bodies forward untouched: the replica
                # renders the same 400 a single server would, so the
                # router adds no second validation surface.
                keys = [None]
            by_target: Dict[Optional[str], List[int]] = {}
            for i, key in enumerate(keys):
                by_target.setdefault(
                    router.target_for(key), []).append(i)
            if sp is not None:
                sp.set(problems=len(keys), targets=len(by_target))
            if len(by_target) == 1:
                # One owner: forward the ORIGINAL bytes — byte-identity
                # with a single replica is structural, not re-rendered.
                out = self._forward_with_retry(keys[0], "/v1/resolve",
                                               raw)
                if out is None:
                    return
                status, body, hdrs, target = out
                if status == 200:
                    router._c_routed.inc(len(keys), label=target)
                if sp is not None:
                    sp.set(replica=target, status=status)
                self._relay(status, body, hdrs)
                return
            self._resolve_split(doc, keys, by_target)

        def _resolve_split(self, doc, keys, groups) -> None:
            """A batch spanning replicas: per-replica sub-batches
            (``groups``: the routing pass _resolve already computed —
            recomputing would double the ring walks, and in roundrobin
            mode re-advance the rotation off the assignment actually
            measured) forwarded concurrently, results merged back in
            input order.  Any non-200 sub-response wins (lowest
            problem index first — deterministic), mirroring the
            all-or-nothing semantics of a single server's
            request-level errors."""
            problems = doc["problems"]
            results: List[Optional[dict]] = [None] * len(problems)
            failures: List[tuple] = []
            lock = threading.Lock()

            def one(target: Optional[str], idxs: List[int]) -> None:
                sub = json.dumps(
                    {"problems": [problems[i] for i in idxs]}).encode()
                out = None
                if target is not None:
                    first = self._fwd_headers()
                    tried = [target]
                    while True:
                        try:
                            out = router.forward(target, "POST",
                                                 "/v1/resolve", sub,
                                                 first)
                            break
                        except OSError:
                            if len(tried) > 1:
                                out = None
                                break
                            router._c_retries.inc()
                            target = router.target_for(
                                keys[idxs[0]], exclude=tried)
                            if target is None:
                                break
                            tried.append(target)
                with lock:
                    if out is None:
                        failures.append((idxs[0], 503, json.dumps({
                            "error": "fleet: no replica reachable",
                            "retry_after_s": max(
                                router.probe_interval_s, 1.0),
                        }).encode(), {}))
                        return
                    status, body, hdrs = out
                    if status != 200:
                        failures.append((idxs[0], status, body, hdrs))
                        return
                    router._c_routed.inc(len(idxs), label=target)
                    for i, res in zip(idxs,
                                      json.loads(body)["results"]):
                        results[i] = res

            threads = [threading.Thread(target=one, args=(t, idxs),
                                        daemon=True)
                       for t, idxs in groups.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if failures:
                _, status, body, hdrs = min(failures)
                self._relay(status, body, hdrs)
                return
            self._send(200, json.dumps({"results": results}).encode())

        def _session(self, path: str) -> None:
            """Session tier routing.  ``POST /v1/session``
            routes by the catalog's family key — the same affinity walk
            as a one-problem ``/v1/resolve``, so the session lands on
            the replica already warm for that family.  Ops route by the
            session's family key from the ``X-Deppy-Session`` header
            (minted at create time, echoed by the client), so the hot
            path never re-encodes the catalog.  Transport failures
            retry once on the ring successor; an op whose retry lands
            on a replica that does not hold the session surfaces a
            clean 409 "session lost" — never a transport 502."""
            is_create = path == "/v1/session"
            router._c_requests.inc(
                label="session" if is_create else "session_op")
            raw = self._read_body()
            if raw is None:
                return
            if is_create:
                try:
                    keys = doc_affinity_keys(json.loads(raw or b"null"))
                except (ValueError, json.JSONDecodeError, KeyError,
                        TypeError):
                    # Unparseable/odd bodies forward untouched: the
                    # replica renders the same 400 a single server
                    # would.
                    keys = [None]
                key = keys[0] if keys else None
            else:
                key = self.headers.get("X-Deppy-Session") or None
            headers = self._fwd_headers()
            target = router.target_for(key)
            tried: List[str] = []
            out = None
            while target is not None:
                try:
                    out = router.forward(target, "POST", path, raw,
                                         headers)
                except OSError:
                    tried.append(target)
                    if len(tried) > 1:
                        out = None
                        break
                    router._c_retries.inc()
                    target = router.target_for(key, exclude=tried)
                    continue
                break
            if out is None:
                self._send_json(503, {
                    "error": "fleet: no replica reachable",
                    "retry_after_s": max(router.probe_interval_s, 1.0)})
                return
            status, body, hdrs = out
            if status == 404 and not is_create and tried:
                # The holding replica died mid-session and the ring
                # successor (which answered) has no such session: the
                # retained state is gone, not the transport.  Clients
                # see one unambiguous signal to re-create and replay.
                self._send_json(409, {"error": "session lost"})
                return
            if status == 200:
                router._c_routed.inc(label=target)
            self._relay(status, body, hdrs)

        def _fan_out(self, path: str) -> None:
            """Publish / preview fan-out to every live replica."""
            endpoint = ("publish" if path.endswith("publish")
                        else "preview")
            router._c_requests.inc(label=endpoint)
            raw = self._read_body()
            if raw is None:
                return
            headers = self._fwd_headers()
            live = router.live_replicas()
            if not live:
                self._send_json(503, {
                    "error": "fleet: no replica reachable",
                    "retry_after_s": max(router.probe_interval_s, 1.0)})
                return
            merged: Dict[str, float] = {}
            previews: List = []
            errors = 0
            first_error = None
            for address in live:
                try:
                    status, body, _ = router.forward(
                        address, "POST", path, raw, headers)
                except OSError:
                    errors += 1
                    continue
                router._c_fanout.inc()
                if status != 200:
                    errors += 1
                    if first_error is None:
                        first_error = (status, body)
                    continue
                payload = json.loads(body)
                if endpoint == "publish":
                    for k, v in (payload.get("publish") or {}).items():
                        if isinstance(v, (int, float)):
                            merged[k] = merged.get(k, 0) + v
                else:
                    previews.extend(payload.get("preview") or [])
            if errors == len(live):
                if first_error is not None:
                    # Every replica answered the same rejection (e.g. a
                    # malformed publish, or the tier off fleet-wide):
                    # relay it rather than masking as a router error.
                    self._send(first_error[0], first_error[1])
                else:
                    # Every forward failed at the TRANSPORT level (all
                    # replicas died between probe cycles): a 200 with
                    # zero recipients would read as "delta propagated"
                    # / "preview empty" when nothing was reached.
                    self._send_json(503, {
                        "error": "fleet: no replica reachable",
                        "retry_after_s": max(
                            router.probe_interval_s, 1.0)})
                return
            if endpoint == "publish":
                merged["replicas"] = len(live) - errors
                merged["errors"] = errors
                self._send_json(200, {"publish": merged})
            else:
                self._send_json(200, {"preview": previews})

        def _drain(self):
            router._c_requests.inc(label="drain")
            raw = self._read_body()
            if raw is None:
                return
            try:
                doc = json.loads(raw or b"null")
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(400,
                                {"error": f"invalid JSON body: {e}"})
                return
            if not isinstance(doc, dict) \
                    or not isinstance(doc.get("replica"), str):
                self._send_json(
                    400, {"error": 'drain requires {"replica": '
                          '"host:port"}'})
                return
            try:
                out = router.drain(doc["replica"])
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except (OSError, SnapshotFormatError, json.JSONDecodeError,
                    faults.InjectedFault) as e:
                # InjectedFault included: a
                # fault-plan-poisoned fleet.forward during the handoff
                # must surface as the same 502 a real transport failure
                # does — and the replica stays routable either way.
                self._send_json(502, {"error": f"drain failed: {e}"})
                return
            self._send_json(200, {"drain": out})

        def _join(self):
            """Runtime membership join: stream the
            joiner its inherited warm state, then atomically flip its
            arcs live.  Any failure before the flip leaves membership
            exactly as it was — 502, joiner not admitted."""
            if not router.elastic:
                self._send_json(404, {"error": "not found"})
                return
            router._c_requests.inc(label="join")
            raw = self._read_body()
            if raw is None:
                return
            try:
                doc = json.loads(raw or b"null")
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(400,
                                {"error": f"invalid JSON body: {e}"})
                return
            if not isinstance(doc, dict) \
                    or not isinstance(doc.get("replica"), str):
                self._send_json(
                    400, {"error": 'join requires {"replica": '
                          '"host:port"}'})
                return
            from .membership import join_replica

            try:
                out = join_replica(router, doc["replica"])
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except (OSError, SnapshotFormatError, json.JSONDecodeError,
                    faults.InjectedFault) as e:
                self._send_json(502, {"error": f"join failed: {e}"})
                return
            self._send_json(200, {"join": out})

        def _sync(self):
            """Peer-router membership gossip: reconcile the
            sender's epoch-versioned view, answer with ours — one
            exchange converges both directions."""
            if not router.elastic:
                self._send_json(404, {"error": "not found"})
                return
            router._c_requests.inc(label="sync")
            raw = self._read_body()
            if raw is None:
                return
            from .membership import reconcile

            try:
                doc = json.loads(raw or b"null")
                view = doc.get("view") if isinstance(doc, dict) \
                    else None
                out = reconcile(router, view)
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(400,
                                {"error": f"invalid sync view: {e}"})
                return
            self._send_json(200, {"view": out})

    return Handler


def serve_router(bind_address: str = ":8079", replicas=None,
                 vnodes: Optional[int] = None,
                 probe_interval_s: Optional[float] = None,
                 probe_failures: Optional[int] = None,
                 policy: str = "affinity",
                 obs_sink: Optional[str] = None,
                 membership: Optional[str] = None,
                 peers=None) -> None:
    """The blocking router process — the router analog of
    :func:`deppy_tpu_torch.service.serve` (SIGTERM or Ctrl-C stop it
    cleanly; SIGUSR2 dumps every live replica's flight recorder)."""
    import signal
    import sys

    router = Router(bind_address=bind_address, replicas=replicas,
                    vnodes=vnodes, probe_interval_s=probe_interval_s,
                    probe_failures=probe_failures, policy=policy,
                    obs_sink=obs_sink, membership=membership,
                    peers=peers)
    router.start()
    stop = threading.Event()

    def _on_sigterm(signum, frame):
        stop.set()

    def _on_sigusr2(signum, frame):
        # Fleet-wide flight-recorder dump: the replica-local
        # SIGUSR2 semantics, fanned out — one signal on the router
        # flushes every live replica's recorder into its sink/stream.
        out = router.dump_fanout()
        total = sum(out["dumped"].values())
        print(f"[route] SIGUSR2: dumped {total} flight-recorder "
              f"trace(s) across {len(out['dumped'])} replica(s)"
              + (f"; unreachable: {','.join(out['errors'])}"
                 if out["errors"] else ""),
              file=sys.stderr, flush=True)

    prev = signal.signal(signal.SIGTERM, _on_sigterm)
    prev_usr2 = None
    if hasattr(signal, "SIGUSR2"):  # absent on Windows
        prev_usr2 = signal.signal(signal.SIGUSR2, _on_sigusr2)
    extra = ""
    if router.elastic:
        extra = ", membership elastic" + (
            f", {len(router.peers)} peer(s)" if router.peers else "")
    print(f"deppy fleet router listening on :{router.api_port} "
          f"({len(router.ring.replicas)} replicas, policy "
          f"{router.policy}{extra})", flush=True)
    try:
        while not stop.is_set():
            stop.wait(3600)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        if prev_usr2 is not None:
            signal.signal(signal.SIGUSR2, prev_usr2)
        router.shutdown()


# For smoke and bench harnesses: how long a router takes to notice a
# dead replica (probe interval x failure threshold) — chaos assertions
# derive their settle windows from this instead of hardcoding sleeps.
def detection_window_s(router: Router) -> float:
    return router.probe_interval_s * router.probe_failures
