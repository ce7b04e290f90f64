"""The resolution service on the card (copy of ``deppy_tpu/service.py:1-1682``).

The deployable process: the only way users reach the resolver.  On the
stdlib HTTP server, as in the reference:

  * ``POST /v1/resolve`` on the main address — a problem document (the
    :mod:`deppy_tpu_torch.io` format: one problem or a batch) through
    the request scheduler onto the card, per-problem solutions or
    conflict sets back; with trace context (``traceparent`` /
    ``X-Deppy-Request-Id``), ``X-Deppy-Timings``, ``X-Deppy-Tenant`` and
    ``X-Deppy-Deadline-S``;
  * every tier's endpoint: ``/v1/optimize``, ``/v1/session`` and
    ``/v1/session/<id>/op``, ``/v1/catalog/publish`` and
    ``/v1/resolve/preview``, ``/v1/routes/learned``, the warm-state
    handoff ``/debug/warmstate`` (GET and POST), ``/debug/traces``,
    ``/debug/slo`` and ``/debug/dump``;
  * ``GET /metrics`` — Prometheus text: the server's own registry, then
    the fault, host-pool, profiler, SLO, obs and route families;
  * ``GET /healthz`` and ``GET /readyz`` on the probe address, with the
    degraded readiness text while the card's breaker is open;
  * graceful drain (``shutdown``, SIGTERM in :func:`serve`), the HA
    lease (:mod:`deppy_tpu_torch.utils.lease`) and the server's half of
    fleet membership (``POST /fleet/join`` and ``/fleet/drain`` to a
    :class:`deppy_tpu_torch.fleet.Router`).

Deliberate differences from the reference:

  * ``Server(device="cuda", backend="device")`` by default: everything
    the server builds (the scheduler, the planner, the session store,
    the route plane and the unscheduled ``BatchResolver``) gets both.
    So with the breaker open the default server sheds 503s as the
    reference's ``backend="tpu"`` server does; ``backend="auto"`` is the
    reference's default behaviour, ``backend="host"`` the host engine,
    ``device="cpu"`` the kernels' plain versions.
  * The knobs are ``DEPPY_GPU_*``: ``SCHED``, ``OPT``, ``SESSIONS``,
    ``REPLICA``, ``REQUEST_DEADLINE_S``, ``DRAIN_S``, ``REPROBE``,
    ``OBS_STREAM``, ``OBS_BASELINE``, ``FLEET_ROUTER`` and
    ``FLEET_ADVERTISE``, each with the reference's parse, read through
    the typed registry (:mod:`deppy_tpu_torch.config`).
  * ``mesh_devices`` sizes the scheduler's serving mesh over the visible
    cards, as the reference's does.
  * Locks are plain :class:`threading.Lock` (lockdep is A7.2).
  * The engine verdict behind ``deppy_auto_engine_usable`` is the one of
    the server's own device type (the port keeps one per type).

Imports neither torch at module level nor anything of JAX: the
card is reached only through the scheduler and the driver.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from . import config, faults
from . import io as problem_io
from . import profile as profiling
from . import telemetry
from .sat.errors import (BackendCapabilityError, DuplicateIdentifier,
                         InternalSolverError)

_OFF = ("off", "0", "false", "no")


class _HTTPServer(ThreadingHTTPServer):
    """The listen backlog is the system's ``somaxconn``, as the reference's
    Go listeners take it, not ``socketserver``'s 5.  In-process replicas
    and routers share one interpreter lock, so the accept thread can stall
    behind it; a burst of clients then overflows a five-deep queue, and
    the kernel answers the overflow with SYN cookies whose failed checks
    reset connections that already sent their request."""

    request_queue_size = socket.SOMAXCONN


class _V6HTTPServer(_HTTPServer):
    address_family = socket.AF_INET6


class _DualStackHTTPServer(_V6HTTPServer):
    """Wildcard '::' bind accepting both IPv6 and IPv4-mapped connections —
    what the reference's Go ':8080' listeners do.  Keeps the shipped
    Deployment's probes working on IPv6-only clusters."""

    def server_bind(self):
        try:
            self.socket.setsockopt(
                socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0
            )
        except OSError:  # pragma: no cover - platform without the option
            pass
        super().server_bind()


def _make_http_server(addr: Tuple[str, int], handler) -> ThreadingHTTPServer:
    """Bind a threading HTTP server: explicit IPv4/IPv6 hosts get their
    family; an empty host (the ':8080' form) binds dual-stack, falling back
    to IPv4 wildcard where IPv6 is unavailable."""
    host, port = addr
    if host == "":
        try:
            return _DualStackHTTPServer(("::", port), handler)
        except OSError:
            return _HTTPServer(("0.0.0.0", port), handler)
    if ":" in host:  # IPv6 literal (brackets already stripped by _parse_addr)
        return _V6HTTPServer(addr, handler)
    return _HTTPServer(addr, handler)


def _default_engine_probe(device="cuda") -> Optional[bool]:
    """Auto-routing verdict for the scrape-time gauge: 1 the card's
    kernels, 0 host fallback (card unusable), None while no verdict
    exists yet for ``device``'s type.  The port keeps one verdict per
    device type (``sat.solver._ENGINE_USABLE``); a server reads its own.
    Lives behind an injectable callback so ``Metrics.render`` is pure
    and testable without the solver module."""
    from .sat import solver as _solver

    return _solver._ENGINE_USABLE.get(_solver._device_type(device))


class Metrics:
    """The service's metric surface, rendered in Prometheus text
    exposition format.

    On :class:`deppy_tpu_torch.telemetry.Registry`: the historical
    counters keep their exact names and rendering, and the registry
    adds histogram families — ``deppy_solve_seconds`` (per-batch
    wall clock), ``deppy_batch_fill_ratio`` (live problems per dispatched
    lane) and ``deppy_escalation_stage`` (budget-escalation stage
    reached), fed from each batch's :class:`telemetry.SolveReport`.

    Each ``Metrics`` owns a private registry, so concurrent servers (and
    tests) never share counts; the pipeline-global driver telemetry
    lives separately on ``telemetry.default_registry()``.
    """

    def __init__(self, registry: Optional[telemetry.Registry] = None,
                 engine_usable_probe=_default_engine_probe) -> None:
        self.registry = registry if registry is not None \
            else telemetry.Registry()
        self._engine_probe = engine_usable_probe
        self.leader: Optional[bool] = None  # None = election disabled
        # Per-tenant SLO accountant: set by the owning
        # Server; its deppy_tenant_* families append to every scrape.
        self.slo: Optional[profiling.SLOAccountant] = None
        r = self.registry
        self._resolutions = r.counter(
            "deppy_resolutions_total", "Problems resolved by outcome.",
            labelname="outcome",
        ).preset("sat", "unsat", "incomplete")
        self._batches = r.counter(
            "deppy_batches_total", "Resolution batches dispatched.")
        self._errors = r.counter(
            "deppy_request_errors_total", "Malformed or failed requests.")
        self._solve_seconds = r.counter(
            "deppy_solve_seconds_total",
            "Wall-clock seconds spent solving.", initial=0.0)
        self._engine_steps = r.counter(
            "deppy_engine_steps_total",
            "Engine iterations (tests, decisions, backtracks).")
        self._solve_hist = r.histogram(
            "deppy_solve_seconds",
            "Resolution batch wall-clock seconds.",
            buckets=telemetry.SECONDS_BUCKETS)
        self._fill_hist = r.histogram(
            "deppy_batch_fill_ratio",
            "Live problems per dispatched batch lane (1.0 = no padding).",
            buckets=telemetry.RATIO_BUCKETS)
        self._esc_hist = r.histogram(
            "deppy_escalation_stage",
            "Budget-escalation stage reached per batch (0 = single "
            "stage, 1 = stage-1 budget sufficed, 2 = stage-2 redo).",
            buckets=telemetry.STAGE_BUCKETS)
        # Per-request latency attribution: end-to-end request
        # wall clock, and the slice of it spent queued in the scheduler
        # before a coalesced dispatch picked the request up.
        self._request_hist = r.histogram(
            "deppy_request_total_seconds",
            "End-to-end /v1/resolve wall clock, admission through "
            "response render.",
            buckets=telemetry.SECONDS_BUCKETS)
        self._queue_wait_hist = r.histogram(
            "deppy_request_queue_wait_seconds",
            "Seconds a request's problems waited in the scheduler "
            "queue before their coalesced dispatch started.",
            buckets=telemetry.SECONDS_BUCKETS)

    def observe_batch(self, outcomes: Dict[str, int], seconds: float,
                      steps: int = 0,
                      report: Optional[telemetry.SolveReport] = None) -> None:
        self._batches.inc()
        for k, v in outcomes.items():
            self._resolutions.inc(v, label=k)
        self._solve_seconds.inc(seconds)
        self._engine_steps.inc(steps)
        self._solve_hist.observe(seconds)
        if report is not None:
            self._fill_hist.observe(report.batch_fill_ratio)
            self._esc_hist.observe(report.escalation_stage)

    def observe_error(self) -> None:
        self._errors.inc()

    def observe_request(self, total_s: float,
                        queue_wait_s: Optional[float] = None) -> None:
        """One /v1/resolve request's latency breakdown."""
        self._request_hist.observe(total_s)
        if queue_wait_s is not None:
            self._queue_wait_hist.observe(queue_wait_s)

    def render(self) -> str:
        # The probe runs OUTSIDE any metric lock (it may import the
        # solver module on first call); rendering itself is pure.
        usable = None
        if self._engine_probe is not None:
            try:
                usable = self._engine_probe()
            except Exception:  # noqa: BLE001
                usable = None  # a broken probe must not break scrapes
        lines = self.registry.render_lines()
        if usable is not None:
            lines += [
                "# HELP deppy_auto_engine_usable Auto routing verdict:"
                " 1 = tensor engine, 0 = host fallback.",
                "# TYPE deppy_auto_engine_usable gauge",
                f"deppy_auto_engine_usable {int(usable)}",
            ]
        if self.leader is not None:
            lines += [
                "# HELP deppy_leader HA election verdict: 1 = holding"
                " the lease (serving), 0 = standby.",
                "# TYPE deppy_leader gauge",
                f"deppy_leader {int(self.leader)}",
            ]
        # Fault-domain families: breaker state + retry/deadline
        # counters are pipeline-global (one accelerator, one breaker),
        # appended here so every scrape sees them.
        lines += faults.render_metric_lines()
        # Hostpool families: the breaker-open worker pool is
        # process-global too (one host, one pool) — same injection
        # pattern, so queue depth / busy workers / crash-recycle
        # counters ride every scrape.
        from . import hostpool

        lines += hostpool.render_metric_lines()
        # Profiler families: the trip ledger records on the
        # pipeline-global default registry (where the driver runs);
        # mirror them into the scrape like the fault/hostpool families.
        # Absent until a sampled dispatch, so disarmed scrapes are
        # unchanged.
        lines += profiling.render_metric_lines()
        # Per-tenant SLO families: request / deadline-miss /
        # violation counters plus p99 and burn-rate gauges, one line
        # per observed tenant — absent until the first request lands,
        # so a tenant-free deployment's scrape is unchanged.
        if self.slo is not None:
            lines += self.slo.render_metric_lines()
        # Fleet observability families: telemetry-streamer
        # counters + cost-model drift gauges, process-global like the
        # profiler's.  Disarmed (no --obs-stream / --obs-baseline) this
        # appends nothing — scrapes stay byte-identical.
        from . import obs, routes

        lines += obs.render_metric_lines()
        lines += routes.render_metric_lines()
        return "\n".join(lines) + "\n"


class Server:
    """The service: one HTTP server for API+metrics, one for health probes
    (mirroring the reference's two bind addresses, main.go:48-50)."""

    def __init__(
        self,
        bind_address: str = ":8080",
        probe_address: str = ":8081",
        backend: str = "device",
        max_steps: Optional[int] = None,
        max_body_bytes: int = 8 * 1024 * 1024,
        elector=None,
        request_deadline_s: Optional[float] = None,
        drain_s: Optional[float] = None,
        sched: Optional[str] = None,
        sched_max_wait_ms: Optional[float] = None,
        sched_max_fill: Optional[int] = None,
        cache_size: Optional[int] = None,
        mesh_devices: Optional[int] = None,
        incremental: Optional[str] = None,
        incremental_max_delta: Optional[float] = None,
        incremental_index_size: Optional[int] = None,
        slo: Optional[str] = None,
        portfolio: Optional[str] = None,
        speculate: Optional[str] = None,
        speculate_max_backlog: Optional[int] = None,
        replica: Optional[str] = None,
        fair: Optional[str] = None,
        tenant_weights: Optional[str] = None,
        obs_stream: Optional[str] = None,
        obs_flush_ms: Optional[float] = None,
        obs_baseline: Optional[str] = None,
        fleet_router: Optional[str] = None,
        fleet_advertise: Optional[str] = None,
        opt: Optional[str] = None,
        opt_max_iterations: Optional[int] = None,
        opt_iter_budget: Optional[int] = None,
        opt_max_weight: Optional[int] = None,
        route_learn: Optional[str] = None,
        route_shadow_rate: Optional[float] = None,
        route_registry: Optional[str] = None,
        sessions: Optional[str] = None,
        session_lease_s: Optional[float] = None,
        session_max: Optional[int] = None,
        session_max_per_tenant: Optional[int] = None,
        device="cuda",
    ):
        from .sat.solver import check_backend

        self.backend = check_backend(backend)
        self.device = device
        self.max_steps = max_steps
        self.max_body_bytes = max_body_bytes
        self.metrics = Metrics(engine_usable_probe=lambda: (
            _default_engine_probe(device)))
        # Replica serving identity: --replica /
        # DEPPY_GPU_REPLICA / `replica` config key.  Fleet deployments
        # set one per process so the SLO families, /debug/slo, and
        # every request's root span attribute burn rate per tenant PER
        # REPLICA; unset (single-process) keeps every surface byte-
        # identical to pre-fleet.
        if replica is None:
            replica = config.env_str("DEPPY_GPU_REPLICA")
        self.replica = profiling.sanitize_replica(replica)
        # Per-tenant SLO accounting: tenant identity from
        # X-Deppy-Tenant, targets from the declarative SLO spec
        # (--slo / DEPPY_GPU_SLO: inline JSON, @FILE, or a path).
        # Profiler arming is NOT a Server concern: like the host worker
        # pool, the profiler is process-global state, owned by the
        # process entry point (``profile.configure``, or
        # ``DEPPY_GPU_PROFILE``, or ``deppy serve --profile``)
        # — a Server installing it would leak arming across embedded
        # servers that come and go.
        self.slo = profiling.SLOAccountant(
            profiling.slo_config_from_env() if slo is None
            else profiling.SLOConfig.from_spec(slo),
            replica=self.replica)
        self.metrics.slo = self.slo
        # Fleet observability plane.  --obs-stream arms the
        # telemetry streamer (sink events batch-pushed to the router's
        # POST /fleet/telemetry); --obs-baseline arms the cost-model
        # drift watchdog.  Both install process-global forwarders on
        # the default registry — replica-scoped state like the
        # profiler's, except a fleet replica runs exactly one Server, so
        # this Server owns their lifecycle and detaches them on
        # shutdown().  Unset (the default) arms nothing: the event
        # pipeline and /metrics stay byte-identical to pre-obs.
        if obs_stream is None:
            obs_stream = config.env_str("DEPPY_GPU_OBS_STREAM")
        if obs_baseline is None:
            obs_baseline = config.env_str("DEPPY_GPU_OBS_BASELINE")
        self._obs_armed = False
        if obs_stream or obs_baseline:
            from . import obs

            if obs_stream:
                obs.start_streamer(obs_stream, replica=self.replica,
                                   flush_ms=obs_flush_ms)
                self._obs_armed = True
            if obs_baseline:
                if obs.start_watchdog(obs_baseline,
                                      replica=self.replica) is not None:
                    self._obs_armed = True
        # Elastic fleet membership: --fleet-router names the
        # affinity router this replica announces itself to (POST
        # /fleet/join — the router streams it the warm state its arcs
        # inherit, then flips the ring atomically) once its listeners
        # are up, and leaves (the router's drain handoff) on graceful
        # shutdown.  Unset keeps the standalone lifecycle byte for
        # byte.  --fleet-advertise overrides the advertised host:port
        # (default 127.0.0.1:<api-port> — single-host fleets only).
        if fleet_router is None:
            fleet_router = config.env_str("DEPPY_GPU_FLEET_ROUTER")
        if fleet_advertise is None:
            fleet_advertise = config.env_str("DEPPY_GPU_FLEET_ADVERTISE")
        self.fleet_router = fleet_router
        self.fleet_advertise = fleet_advertise
        self._fleet_joined = False
        self._fleet_advertised: Optional[str] = None
        self.ready = threading.Event()
        self._stop = threading.Event()
        # Cross-request continuous batching + result cache:
        # concurrent /v1/resolve requests coalesce into shared device
        # dispatches through one Scheduler instead of each paying a
        # private pad/pack + device_put + launch.  Default on;
        # DEPPY_GPU_SCHED=off (or sched="off") restores the historical
        # per-request dispatch path — responses are byte-identical
        # either way.  The scheduler and everything below get the
        # server's backend and device.  The scheduler registers its
        # queue/cache metric families on this server's registry, so they
        # ride /metrics.
        if sched is None:
            sched = config.env_raw("DEPPY_GPU_SCHED", "on")
        self.scheduler = None
        if str(sched).strip().lower() not in _OFF:
            from .sched import Scheduler

            self.scheduler = Scheduler(
                backend=backend, device=device, max_steps=max_steps,
                max_wait_ms=sched_max_wait_ms, max_fill=sched_max_fill,
                cache_size=cache_size,
                registry=self.metrics.registry,
                mesh_devices=mesh_devices,
                incremental=incremental,
                incremental_max_delta=incremental_max_delta,
                incremental_index_size=incremental_index_size,
                portfolio=portfolio,
                speculate=speculate,
                speculate_max_backlog=speculate_max_backlog,
                fair=fair,
                tenant_weights=tenant_weights)
        # Optimization tier: POST /v1/optimize serves
        # upgrade planning / soft constraints / explain-why-not through
        # the bound-tightening loop.  The tier rides the scheduler's
        # idle-priority queue, so it exists only when the scheduler
        # does; "off" (or sched off) constructs nothing — the endpoint
        # 404s like any unknown path and every other surface is
        # byte-identical to pre-tier.  The planner's counters register
        # on this server's registry so they ride /metrics.
        if opt is None:
            opt = config.env_raw("DEPPY_GPU_OPT", "on")
        self.optimizer = None
        if self.scheduler is not None and str(opt).strip().lower() \
                not in _OFF:
            from .optimize import Planner

            self.optimizer = Planner(
                self.scheduler, metrics=self.metrics.registry,
                max_iterations=opt_max_iterations,
                iter_budget=opt_iter_budget,
                max_weight=opt_max_weight)
        # Route-health plane: regret ledger + staleness
        # watcher + shadow sampler (+ online route registry when
        # --route-learn=on).  Exists only when the scheduler does —
        # every event it folds comes off the scheduler's racer.  "off"
        # (the default) constructs nothing: no forwarder, no route_*
        # metric families, POST /v1/routes/learned 404s, and responses
        # stay byte-identical to pre-plane.
        self.route_plane = None
        if self.scheduler is not None:
            from . import routes

            self.route_plane = routes.start_plane(
                self.scheduler, mode=route_learn,
                shadow_rate=route_shadow_rate,
                registry_path=route_registry,
                replica=self.replica)
        # Stateful resolution sessions: POST /v1/session +
        # /v1/session/{id}/op serve interactive assume/test/untest
        # exploration against a retained catalog epoch, with every
        # incremental solve routed through the scheduler's dedicated
        # session class (warm-started from the session's last model,
        # raced across registry backends, deadline/breaker/fair
        # semantics unchanged).  The tier exists only when the
        # scheduler does; "off" constructs NONE of it — the endpoints
        # 404 byte-identically to unknown paths, no session metric
        # family registers, and /v1/resolve is untouched.
        if sessions is None:
            sessions = config.env_raw("DEPPY_GPU_SESSIONS", "on")
        self.sessions = None
        if self.scheduler is not None and str(sessions).strip().lower() \
                not in _OFF:
            from .sessions import SessionStore

            self.sessions = SessionStore(
                self.scheduler, metrics=self.metrics.registry,
                lease_s=session_lease_s, max_sessions=session_max,
                max_per_tenant=session_max_per_tenant,
                replica=self.replica)
        # Fault-domain knobs.  request_deadline_s: default
        # wall-clock budget per /v1/resolve (clients override per request
        # via the X-Deppy-Deadline-S header; None = unbounded).  drain_s
        # bounds the graceful-shutdown wait for in-flight requests —
        # defaulting to the request deadline, since no request should
        # legitimately outlive one.
        if request_deadline_s is None:
            request_deadline_s = faults.env_float(
                "DEPPY_GPU_REQUEST_DEADLINE_S", None, warn=True)
        self.request_deadline_s = request_deadline_s
        if drain_s is None:
            drain_s = faults.env_float("DEPPY_GPU_DRAIN_S", None, warn=True)
        if drain_s is None:
            drain_s = request_deadline_s if request_deadline_s else 10.0
        self._drain_s = max(float(drain_s), 0.0)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        # Optional active-passive HA (the reference manager's leader
        # election, main.go:51,62-69): when DEPPY_GPU_HA_LEASE names a
        # Lease,
        # only the holder reports ready, so a hot-standby pair exposes
        # exactly one pod through the Service.  Default off — the
        # stateless resolve API scales active-active without election.
        if elector is None:
            from .utils.lease import elector_from_env

            elector = elector_from_env()
        self.elector = elector
        if self.elector is not None:
            self.metrics.leader = False
            self.elector.on_change = self._on_leader_change
        try:
            self._reprobe_s = float(
                config.env_raw("DEPPY_GPU_REPROBE", "600")
            )
        except ValueError:
            # A typo'd env var must degrade to the default, not kill the
            # server at startup (matches DEPPY_BENCH_SELF_DESTRUCT's
            # defensive parsing).
            print("[service] ignoring non-numeric DEPPY_GPU_REPROBE="
                  f"{config.env_raw('DEPPY_GPU_REPROBE')!r}; using 600",
                  file=sys.stderr, flush=True)
            self._reprobe_s = 600.0
        self._api = _make_http_server(
            _parse_addr(bind_address), _api_handler(self)
        )
        try:
            self._probe = _make_http_server(
                _parse_addr(probe_address), _probe_handler(self)
            )
        except OSError:
            self._api.server_close()  # don't leak the already-bound socket
            raise
        self._threads: list = []

    @property
    def api_port(self) -> int:
        return self._api.server_address[1]

    @property
    def probe_port(self) -> int:
        return self._probe.server_address[1]

    def admission_retry_after(
            self, deadline_s: Optional[float],
            tenant: str = "default",
    ) -> Optional[Tuple[float, str]]:
        """Degraded-mode gate for one request: (seconds the client
        should wait before retrying, error text), or None to admit.
        Three unmeetable cases: the request's deadline is already spent
        (a proxy-propagated budget of <= 0), the caller insists on the
        device backend while the accelerator breaker is open, or the
        scheduler queue is over its depth limit — per TENANT under the
        weighted-fair gate (the noisy tenant sheds at its
        share while victims under theirs keep admitting), globally with
        ``DEPPY_GPU_SCHED_FAIR=off``.  An open breaker alone does NOT
        shed auto/host traffic — the scheduler's queue drains on the
        host engine in that mode."""
        breaker = faults.default_breaker()
        if deadline_s is not None and deadline_s <= 0:
            faults.note_deadline_exceeded("service.resolve",
                                          tenant=tenant)
            return (max(breaker.remaining_s(), 1.0),
                    "degraded: request deadline cannot be met")
        if self.backend == "device" and breaker.blocks_device():
            return (max(breaker.remaining_s(), 1.0),
                    "degraded: accelerator breaker open")
        if self.scheduler is not None:
            retry = self.scheduler.admission_retry_after(tenant=tenant)
            if retry is not None:
                return retry, "overloaded: scheduler queue full"
        return None

    def resolve_document(self, doc,
                         deadline_s: Optional[float] = None,
                         timings: Optional[dict] = None,
                         tenant: str = "default",
                         request_stats: Optional[dict] = None,
                         ) -> Tuple[int, dict]:
        """Resolve one request body; returns (http_status, response_doc).
        A 503 response carries ``retry_after_s`` (the handler mirrors it
        into a ``Retry-After`` header).  ``timings``, when given,
        receives this request's stage breakdown:
        ``queue_wait_s`` / ``dispatch_s`` / ``solve_s`` / ``decode_s``
        from the scheduler (or ``solve_s`` alone on the unscheduled
        path) — the handler feeds it to the latency histograms and, on
        ``X-Deppy-Timings: 1``, into the response body.  ``tenant``
        rides the scheduler's lanes for deadline-miss
        attribution; ``request_stats``, when given, receives
        ``{"deadline_misses": N}`` for the SLO accountant — kept apart
        from ``timings`` so the opt-in response body stays exactly the
        documented stage breakdown."""
        faults.inject("service.resolve")
        if deadline_s is None:
            deadline_s = self.request_deadline_s
        gate = self.admission_retry_after(deadline_s, tenant=tenant)
        if gate is not None:
            retry_after, msg = gate
            self.metrics.observe_error()
            return 503, {
                "error": msg,
                "retry_after_s": round(retry_after, 3),
            }
        try:
            problems = problem_io.problems_from_document(doc)
        except problem_io.ProblemFormatError as e:
            self.metrics.observe_error()
            return 400, {"error": str(e)}

        t0 = time.perf_counter()
        try:
            if self.scheduler is not None:
                # Scheduled path: this request's problems join
                # the shared queue (coalescing with concurrent requests)
                # or are served straight from the result cache.
                stats: dict = {}
                results = self.scheduler.submit(
                    problems, deadline_s=deadline_s, stats=stats,
                    tenant=tenant)
                steps = stats.get("steps", 0)
                report = stats.get("report")
                if timings is not None:
                    timings.update(stats.get("timings") or {})
                if request_stats is not None:
                    request_stats["deadline_misses"] = \
                        stats.get("deadline_misses", 0)
            else:
                from .resolution.facade import BatchResolver

                resolver = BatchResolver(backend=self.backend,
                                         device=self.device,
                                         max_steps=self.max_steps,
                                         deadline_s=deadline_s)
                results = resolver.solve(problems)
                steps = resolver.last_steps
                report = resolver.last_report
                if timings is not None:
                    timings["solve_s"] = time.perf_counter() - t0
        except (DuplicateIdentifier, InternalSolverError) as e:
            self.metrics.observe_error()
            return 400, {"error": str(e)}
        except BackendCapabilityError as e:
            # The selected backend/impl cannot serve this solve path: a
            # clean capability verdict, not an internal 500.
            self.metrics.observe_error()
            return 400, {"error": str(e)}

        outcomes = {"sat": 0, "unsat": 0, "incomplete": 0}
        rendered = []
        for res in results:
            r = problem_io.result_to_dict(res)
            outcomes[r["status"]] += 1
            rendered.append(r)
        if (request_stats is not None
                and "deadline_misses" not in request_stats
                and deadline_s is not None):
            # Unscheduled path (no per-lane triage verdicts): a request
            # that ran past its configured deadline AND reports
            # incomplete lanes was deadline-degraded — degradation
            # implies wall >= deadline, and within-deadline budget
            # exhaustion must not count as a miss.
            elapsed = time.perf_counter() - t0
            request_stats["deadline_misses"] = (
                outcomes["incomplete"] if elapsed >= deadline_s else 0)
        self.metrics.observe_batch(outcomes, time.perf_counter() - t0,
                                   steps=steps, report=report)
        return 200, {"results": rendered}

    def optimize_document(self, doc,
                          deadline_s: Optional[float] = None,
                          tenant: str = "default") -> Tuple[int, dict]:
        """Serve one optimize request body; returns
        (http_status, response_doc) with :meth:`resolve_document`'s
        error contract: malformed documents and unresolvable references
        are 400s, admission pressure is a 503 with ``retry_after_s``,
        runtime failures surface as the handler's 500."""
        from .optimize import OptimizeFormatError

        if deadline_s is None:
            deadline_s = self.request_deadline_s
        gate = self.admission_retry_after(deadline_s, tenant=tenant)
        if gate is not None:
            retry_after, msg = gate
            self.metrics.observe_error()
            return 503, {
                "error": msg,
                "retry_after_s": round(retry_after, 3),
            }
        try:
            out = self.optimizer.handle(doc, deadline_s=deadline_s,
                                        tenant=tenant)
        except OptimizeFormatError as e:
            self.metrics.observe_error()
            return 400, {"error": str(e)}
        except (DuplicateIdentifier, InternalSolverError) as e:
            self.metrics.observe_error()
            return 400, {"error": str(e)}
        return 200, {"optimize": out}

    def session_document(self, path: str, doc,
                         deadline_s: Optional[float] = None,
                         tenant: str = "default") -> Tuple[int, dict]:
        """Serve one session-tier request; returns
        (http_status, response_doc) with :meth:`resolve_document`'s
        error contract.  ``POST /v1/session`` creates a session from a
        single-problem document; ``POST /v1/session/{id}/op`` drives
        one assume/test/untest/resolve/explain op against the retained
        state.  Solve-carrying ops pass the same fair-admission gate as
        ``/v1/resolve`` (they join the scheduler queue like any other
        request); creation sheds a counted 503 at the session caps."""
        from .sessions.store import SessionError, SessionLost, SessionShed

        if deadline_s is None:
            deadline_s = self.request_deadline_s
        if path == "/v1/session":
            try:
                out = self.sessions.create(doc, tenant=tenant)
            except problem_io.ProblemFormatError as e:
                self.metrics.observe_error()
                return 400, {"error": str(e)}
            except (DuplicateIdentifier, InternalSolverError) as e:
                self.metrics.observe_error()
                return 400, {"error": str(e)}
            except SessionShed as e:
                self.metrics.observe_error()
                return 503, {
                    "error": str(e),
                    "retry_after_s": round(
                        min(self.sessions.lease_s, 5.0), 3),
                }
            return 200, {"session": out}
        rest = path[len("/v1/session/"):]
        sid, _, tail = rest.partition("/")
        if not sid or tail != "op":
            return 404, {"error": "not found"}
        op = doc.get("op") if isinstance(doc, dict) else None
        if op in ("resolve", "explain"):
            gate = self.admission_retry_after(deadline_s, tenant=tenant)
            if gate is not None:
                retry_after, msg = gate
                self.metrics.observe_error()
                return 503, {
                    "error": msg,
                    "retry_after_s": round(retry_after, 3),
                }
        try:
            out = self.sessions.op(sid, doc, deadline_s=deadline_s)
        except SessionLost:
            # A clean miss, not an error burst: the router retries the
            # ring successor once and renders a retried miss as the
            # 409 "session lost" contract.
            self.metrics.observe_error()
            return 404, {"error": "unknown session"}
        except SessionError as e:
            self.metrics.observe_error()
            return 400, {"error": str(e)}
        except (DuplicateIdentifier, InternalSolverError) as e:
            self.metrics.observe_error()
            return 400, {"error": str(e)}
        return 200, out

    def _on_leader_change(self, leading: bool) -> None:
        self.metrics.leader = leading
        print(f"[service] HA election: "
              f"{'acquired lease, serving' if leading else 'standby'}",
              file=sys.stderr, flush=True)

    def serving(self) -> bool:
        """Readiness verdict for /readyz: started, and — under HA
        election — currently holding the lease."""
        if not self.ready.is_set():
            return False
        return self.elector is None or self.elector.is_leader

    def degraded(self) -> bool:
        """True while the accelerator breaker is open: the service still
        serves (host engine), but /readyz says so and operators should
        expect host-engine latency."""
        return faults.default_breaker().blocks_device()

    def _enter_request(self) -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()

    def _exit_request(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.set()

    def start(self) -> None:
        """Start both listeners on daemon threads (non-blocking)."""
        if self.scheduler is not None:
            self.scheduler.start()
        if self.elector is not None:
            self.elector.start()
        for srv in (self._api, self._probe):
            # Tight poll so shutdown() returns promptly instead of
            # waiting out BaseServer's default 0.5s select timeout.
            t = threading.Thread(target=srv.serve_forever,
                                 kwargs={"poll_interval": 0.05},
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if self.backend == "auto":
            # Pre-warm the auto-backend usability verdict: against a
            # wedged card the probe takes its full timeout (75s)
            # before falling back to host.  The verdict is process-cached
            # and probing is serialized (solver._ENGINE_USABLE_LOCK), so a
            # request landing mid-probe waits on the SHARED probe — worst
            # case the remaining probe window, never a duplicate one —
            # and every request after the verdict routes instantly.
            #
            # If the verdict comes back negative, keep re-probing on an
            # interval (DEPPY_GPU_REPROBE seconds, 0 disables): a service
            # that boots during a card outage upgrades auto routing to
            # the card's kernels when the card recovers, instead of
            # serving from the host engine for the rest of its life.
            def _prewarm():
                from .sat import solver as sat_solver

                try:
                    if sat_solver.resolve_backend(
                            "auto", device=self.device) == "device":
                        return
                except Exception:  # noqa: BLE001
                    pass  # request-path resolution will surface errors
                while self._reprobe_s > 0 and not self._stop.wait(
                        self._reprobe_s):
                    try:
                        if sat_solver.reprobe_engine(device=self.device):
                            return
                    except Exception:  # noqa: BLE001
                        continue  # transient; keep trying next tick

            threading.Thread(target=_prewarm, daemon=True).start()
        if self.fleet_router:
            threading.Thread(target=self._fleet_announce,
                             name="deppy-fleet-join",
                             daemon=True).start()
        self.ready.set()

    # -------------------------------------------- fleet membership

    def _fleet_post(self, path: str, doc: dict,
                    timeout: float) -> Tuple[int, bytes]:
        from http.client import HTTPConnection

        host, _, port = str(self.fleet_router).rpartition(":")
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]
        conn = HTTPConnection(host or "127.0.0.1", int(port),
                              timeout=timeout)
        try:
            conn.request("POST", path, body=json.dumps(doc).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _fleet_announce(self, deadline_s: float = 15.0) -> None:
        """Announce this replica to its fleet router: POST
        /fleet/join until the router answers or the deadline passes.
        Best-effort by design — a replica that cannot join still
        serves standalone, and the join's warm-state stream + arc flip
        happen entirely router-side."""
        advertise = self.fleet_advertise \
            or f"127.0.0.1:{self.api_port}"
        self._fleet_advertised = advertise
        deadline = time.monotonic() + deadline_s
        while not self._stop.is_set():
            try:
                # Generous timeout: the router streams warm state to
                # this replica before answering.
                status, body = self._fleet_post(
                    "/fleet/join", {"replica": advertise}, timeout=60.0)
            except OSError:
                if time.monotonic() >= deadline:
                    print(f"[service] fleet join: router "
                          f"{self.fleet_router} unreachable; serving "
                          "standalone", file=sys.stderr, flush=True)
                    return
                self._stop.wait(0.5)
                continue
            if status == 200 or (status == 400
                                 and b"already a fleet member" in body):
                self._fleet_joined = True
            else:
                print(f"[service] fleet join rejected (HTTP {status}): "
                      f"{body[:200]!r}; serving standalone",
                      file=sys.stderr, flush=True)
            return

    def _fleet_leave(self) -> None:
        """Leave = drain: ask the router to run the
        warm-state drain handoff for this replica before the listeners
        close — the router calls back ``GET /debug/warmstate``, so
        this must run while the API listener still serves."""
        try:
            self._fleet_post("/fleet/drain",
                             {"replica": self._fleet_advertised},
                             timeout=60.0)
        except OSError:
            # Router gone (or never reachable): this death looks like
            # a crash to the fleet and the probe loop cleans up.
            pass
        self._fleet_joined = False

    def shutdown(self, drain_s: Optional[float] = None) -> None:
        """Graceful stop: flip /readyz, wait (bounded by the drain
        budget — itself derived from the request-deadline machinery) for
        in-flight /v1/resolve requests to finish, then close the
        listeners.  A request slower than the drain budget is abandoned
        — by construction it has also blown its deadline."""
        self.ready.clear()
        if self._fleet_joined:
            # Leave the fleet FIRST: the router's drain
            # handoff re-homes this replica's warm tier onto its arc
            # inheritors, and needs our /debug/warmstate answered —
            # so it must precede _stop and the listener close.
            self._fleet_leave()
        self._stop.set()
        if drain_s is None:
            drain_s = self._drain_s
        if drain_s > 0:
            self._idle.wait(drain_s)
        if self.sessions is not None:
            # Stop the lease sweeper before the scheduler: a sweep
            # racing scheduler teardown buys nothing, and embedded
            # servers in tests must not leak sweeper threads.
            self.sessions.stop()
        if self.scheduler is not None:
            # After the drain: in-flight requests are parked on their
            # queue groups, and stopping first would orphan them.  A
            # request that outlived the drain budget dispatches inline
            # on its own handler thread instead (the scheduler's
            # fallback), so nothing hangs.
            self.scheduler.stop()
        if self.elector is not None:
            # Release the lease BEFORE closing the listeners: the standby
            # flips to ready on its next tick, shrinking the failover
            # window from lease-expiry to renew-interval.
            self.elector.stop(release=True)
        if self.route_plane is not None:
            # Detach the route plane's forwarder and clear its learned
            # overlay so embedded servers in tests don't leak adopted
            # rows across instances.
            from . import routes

            routes.stop_plane()
            self.route_plane = None
        if self._obs_armed:
            # Detach the streamer/watchdog forwarders this Server armed
            # (final flush included) so embedded servers in tests don't
            # leak obs state across instances.
            from . import obs

            obs.stop_all()
            self._obs_armed = False
        for srv in (self._api, self._probe):
            if self._threads:
                # BaseServer.shutdown blocks forever unless serve_forever is
                # running — only call it on a started server.
                srv.shutdown()
            srv.server_close()
        self._threads = []


def _parse_addr(addr: str) -> Tuple[str, int]:
    """':8080', 'host:8080', '[::1]:8080', or a bare port → (host, port).
    Raises ``ValueError`` with a usable message on anything else (callers
    surface it as a usage error)."""
    host, sep, port = addr.rpartition(":")
    if not sep:
        host, port = "", addr
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]  # IPv6 literal
    elif ":" in host:
        # An unbracketed IPv6 literal would silently misparse at the last
        # colon ('::1' -> host '::', port 1) — require brackets instead.
        raise ValueError(
            f"invalid listen address {addr!r}: bracket IPv6 literals, "
            "e.g. '[::1]:8080'"
        )
    try:
        port_n = int(port)
    except ValueError:
        raise ValueError(
            f"invalid listen address {addr!r}: want ':PORT', 'HOST:PORT', "
            "or a bare port number"
        ) from None
    # Empty host stays empty: _make_http_server turns it into a dual-stack
    # wildcard bind (the Go ':8080' behavior).
    return host, port_n


def _api_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        # Trace context of the in-flight /v1/resolve; echoed
        # into response headers by _send when the client sent a tracing
        # header (strict byte-identity for clients that sent none).
        _trace_ctx = None
        _echo_ids = False
        _echo_traceparent = False

        def log_message(self, fmt, *args):  # keep the library print-free
            pass

        def _send(self, status: int, body: str, ctype: str,
                  extra_headers: Optional[dict] = None) -> int:
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            if self._trace_ctx is not None and self._echo_ids:
                # Echo the honored id back so the caller can quote it
                # against /debug/traces and `deppy trace`; the W3C
                # header is echoed only to callers speaking it.  Header-
                # free requests get byte-identical pre-trace responses
                # (their traces are still in the flight recorder).
                self.send_header("X-Deppy-Request-Id",
                                 self._trace_ctx.request_id)
                if self._echo_traceparent:
                    self.send_header(
                        "traceparent",
                        telemetry.trace.traceparent_of(self._trace_ctx))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
            return status

        def _send_json(self, status: int, doc: dict) -> int:
            headers = None
            if status == 503 and "retry_after_s" in doc:
                # Degraded mode: tell well-behaved clients when
                # the breaker's half-open probe is due.
                headers = {"Retry-After":
                           str(max(int(doc["retry_after_s"] + 0.5), 1))}
            return self._send(status, json.dumps(doc), "application/json",
                              headers)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, server.metrics.render(),
                           "text/plain; version=0.0.4")
            elif self.path.split("?", 1)[0] == "/debug/traces":
                self._debug_traces()
            elif self.path.split("?", 1)[0] == "/debug/slo":
                # Per-tenant SLO accounting: every observed
                # tenant's counters, window p99 vs target, and
                # error-budget burn rate.  Fleet deployments
                # also see the replica's serving identity, so N
                # replicas' documents aggregate attributably; without
                # one the body is byte-identical to pre-fleet.
                doc = {"slo": server.slo.snapshot()}
                if server.replica is not None:
                    doc["replica"] = server.replica
                self._send(200, json.dumps(doc, sort_keys=True),
                           "application/json")
            elif self.path.split("?", 1)[0] == "/debug/warmstate":
                # Warm-state snapshot export: the drain
                # handoff's read side.  404 with the scheduler off —
                # there is no warm tier to export.
                if server.scheduler is None:
                    self._send_json(404, {"error": "not found"})
                    return
                from .fleet import export_warm_state

                self._send(200, json.dumps(
                    export_warm_state(server.scheduler,
                                      sessions=server.sessions)),
                    "application/json")
            else:
                self._send_json(404, {"error": "not found"})

        def _debug_traces(self):
            """Flight-recorder lookup: the full span tree of
            one request (``?id=`` trace or request id) or the index of
            every retained trace."""
            from urllib.parse import parse_qs, urlsplit

            recorder = telemetry.trace.default_recorder()
            query = parse_qs(urlsplit(self.path).query)
            wanted = (query.get("id") or [None])[0]
            if wanted:
                trace = recorder.get(wanted)
                if trace is None:
                    self._send_json(404,
                                    {"error": f"unknown trace id {wanted!r}"})
                else:
                    self._send(200, json.dumps({"trace": trace},
                                               default=str),
                               "application/json")
            else:
                self._send(200, json.dumps(
                    {"traces": recorder.summaries()}, default=str),
                    "application/json")

        def do_POST(self):
            if self.path == "/v1/resolve":
                server._enter_request()
                try:
                    self._resolve_request()
                finally:
                    server._exit_request()
                return
            if self.path == "/debug/warmstate":
                # Warm-state snapshot import: the drain
                # handoff's write side — a draining replica's shard,
                # delivered by the router, merges into this replica's
                # clause-set index and exact cache (live state wins).
                if server.scheduler is None:
                    self._send_json(404, {"error": "not found"})
                    return
                doc, err = self._read_json_body()
                if err is not None:
                    return
                from .fleet import SnapshotFormatError, import_warm_state

                server._enter_request()
                try:
                    out = import_warm_state(server.scheduler, doc,
                                            sessions=server.sessions)
                except SnapshotFormatError as e:
                    server.metrics.observe_error()
                    self._send_json(400, {"error": str(e)})
                    return
                finally:
                    server._exit_request()
                self._send_json(200, {"imported": out})
                return
            if self.path in ("/v1/catalog/publish", "/v1/resolve/preview"):
                # Speculative pre-resolution: the publish
                # watch endpoint and the read-only what-if preview.
                # With the tier off these paths 404 exactly like any
                # unknown path — pre-change behavior byte for byte.
                sched = server.scheduler
                spec = sched.speculate if sched is not None else None
                if spec is None:
                    self._send_json(404, {"error": "not found"})
                    return
                server._enter_request()
                try:
                    if self.path == "/v1/catalog/publish":
                        self._publish_request(spec)
                    else:
                        self._preview_request(spec)
                finally:
                    server._exit_request()
                return
            if self.path == "/v1/routes/learned":
                # Route-gossip ingress: a peer replica's
                # live-learned routing rows, fanned out by the router.
                # Adoption changes which backends race, never answers;
                # without an armed learning plane this 404s exactly
                # like any unknown path.
                plane = server.route_plane
                if plane is None or plane.learner is None:
                    self._send_json(404, {"error": "not found"})
                    return
                doc, err = self._read_json_body()
                if err is not None:
                    return
                rows = doc.get("rows") if isinstance(doc, dict) else None
                if not isinstance(rows, dict):
                    server.metrics.observe_error()
                    self._send_json(
                        400, {"error": "body must be "
                              '{"rows": {"portfolio.<class>": "a,b"}}'})
                    return
                origin = doc.get("origin")
                applied = plane.learner.adopt(
                    {str(k): v for k, v in rows.items()},
                    source="gossip",
                    origin=origin if isinstance(origin, str) else None)
                self._send_json(200, {"applied": applied})
                return
            if self.path == "/v1/optimize":
                # Optimization tier.  With the tier off this
                # path 404s exactly like any unknown path — pre-change
                # behavior byte for byte.
                if server.optimizer is None:
                    self._send_json(404, {"error": "not found"})
                    return
                server._enter_request()
                try:
                    self._optimize_request()
                finally:
                    server._exit_request()
                return
            if self.path == "/debug/dump":
                # Flight-recorder dump on demand: the HTTP
                # twin of SIGUSR2, so the router can fan one operator
                # signal out to every live replica.  The optional JSON
                # body names a reason for the dumped trace events.
                doc, err = self._read_json_body()
                if err is not None:
                    return
                reason = "http"
                if isinstance(doc, dict) and isinstance(
                        doc.get("reason"), str) and doc["reason"]:
                    reason = doc["reason"]
                n = telemetry.trace.default_recorder().dump(reason=reason)
                out = {"dumped": n}
                if server.replica is not None:
                    out["replica"] = server.replica
                self._send_json(200, out)
                return
            if self.path == "/v1/session" \
                    or self.path.startswith("/v1/session/"):
                # Stateful resolution sessions.  With the
                # tier off these paths 404 exactly like any unknown
                # path — pre-change behavior byte for byte.
                if server.sessions is None:
                    self._send_json(404, {"error": "not found"})
                    return
                server._enter_request()
                try:
                    self._session_request()
                finally:
                    server._exit_request()
                return
            self._send_json(404, {"error": "not found"})

        def _read_json_body(self):
            """``(doc, None)`` — the length-checked parsed JSON body —
            or ``(None, status)`` after the error response has been
            sent.  The /v1/resolve validation rules, shared so the
            publish/preview endpoints cannot drift (a parsed ``null``
            body is a valid doc, hence the explicit error channel)."""
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                server.metrics.observe_error()
                return None, self._send_json(
                    400, {"error": "invalid Content-Length"})
            if length < 0:
                server.metrics.observe_error()
                return None, self._send_json(
                    400, {"error": "invalid Content-Length"})
            if length > server.max_body_bytes:
                server.metrics.observe_error()
                return None, self._send_json(
                    413,
                    {"error": f"body exceeds {server.max_body_bytes} bytes"},
                )
            try:
                return json.loads(self.rfile.read(length) or b"null"), None
            except (ValueError, json.JSONDecodeError) as e:
                server.metrics.observe_error()
                return None, self._send_json(
                    400, {"error": f"invalid JSON body: {e}"})

        def _parse_delta(self, doc):
            from .speculate import PublishDelta, PublishFormatError

            try:
                return PublishDelta.from_doc(doc)
            except PublishFormatError as e:
                server.metrics.observe_error()
                self._send_json(400, {"error": str(e)})
                return None

        def _publish_request(self, spec):
            """POST /v1/catalog/publish — subscribe-side entry of the
            speculative tier: invalidates retracted cache entries and
            queues idle-priority pre-solves for every affected retained
            family.  Returns the enumeration/queueing accounting; the
            pre-solves themselves run in the background."""
            doc, err = self._read_json_body()
            if err is not None:
                return
            delta = self._parse_delta(doc)
            if delta is None:
                return
            try:
                out = spec.publish(delta, max_steps=server.max_steps)
            except Exception as e:  # noqa: BLE001 — same contract as
                # /v1/resolve: a runtime failure is a visible 500, not a
                # dropped connection.
                server.metrics.observe_error()
                self._send_json(500, {"error": f"internal error: {e}"})
                return
            self._send_json(200, {"publish": out})

        def _preview_request(self, spec):
            """POST /v1/resolve/preview — the what-if tier: resolve a
            PROPOSED catalog change against the live index without
            serving or caching it.  Body is a publish document plus an
            optional ``limit`` (affected families previewed, most
            recently served first)."""
            doc, err = self._read_json_body()
            if err is not None:
                return
            limit = None
            if isinstance(doc, dict) and "limit" in doc:
                if not isinstance(doc["limit"], int) \
                        or isinstance(doc["limit"], bool) \
                        or doc["limit"] < 0:
                    server.metrics.observe_error()
                    self._send_json(
                        400, {"error": '"limit" must be a non-negative '
                              'integer'})
                    return
                limit = doc["limit"]
            delta = self._parse_delta(doc)
            if delta is None:
                return
            try:
                entries = spec.preview(delta, max_steps=server.max_steps,
                                       limit=limit)
            except Exception as e:  # noqa: BLE001
                server.metrics.observe_error()
                self._send_json(500, {"error": f"internal error: {e}"})
                return
            rendered = []
            for entry in entries:
                out = dict(entry)
                if "result" in out:
                    out["result"] = problem_io.result_to_dict(
                        out["result"])
                rendered.append(out)
            self._send_json(200, {"preview": rendered})

        def _optimize_request(self):
            """POST /v1/optimize — the /v1/resolve request
            envelope (trace context, tenant identity, deadline header,
            SLO accounting) around the planner's bound-tightening loop,
            so optimization cost is attributable per tenant exactly
            like resolution cost."""
            inbound_tp = self.headers.get("traceparent")
            inbound_rid = self.headers.get("X-Deppy-Request-Id")
            ctx = telemetry.trace.context_from_headers(inbound_tp,
                                                       inbound_rid)
            self._trace_ctx = ctx
            self._echo_ids = inbound_tp is not None \
                or inbound_rid is not None
            self._echo_traceparent = inbound_tp is not None
            tenant = profiling.sanitize_tenant(
                self.headers.get("X-Deppy-Tenant"))
            timings: dict = {}
            t0 = time.perf_counter()
            reg = telemetry.default_registry()
            status = None
            try:
                span_attrs = {"path": "/v1/optimize",
                              "request_id": ctx.request_id,
                              "tenant": tenant}
                if server.replica is not None:
                    span_attrs["replica"] = server.replica
                with telemetry.trace.activate(ctx), \
                        reg.span("service.request", **span_attrs) as sp:
                    status = self._optimize_request_inner(tenant)
                    sp["status"] = status
            finally:
                timings["total_s"] = time.perf_counter() - t0
                server.metrics.observe_request(timings["total_s"], None)
                server.slo.observe(
                    tenant, timings["total_s"],
                    deadline_miss=False,
                    error=status is None or status >= 500)
                telemetry.trace.default_recorder().record(
                    ctx, status=status, timings=timings)

        def _optimize_request_inner(self, tenant) -> int:
            deadline_s = None
            raw_deadline = self.headers.get("X-Deppy-Deadline-S")
            if raw_deadline is not None:
                import math

                try:
                    deadline_s = float(raw_deadline)
                except ValueError:
                    deadline_s = None
                if deadline_s is None or not math.isfinite(deadline_s):
                    server.metrics.observe_error()
                    return self._send_json(
                        400, {"error": "invalid X-Deppy-Deadline-S header"})
            doc, err = self._read_json_body()
            if err is not None:
                return err
            try:
                status, resp = server.optimize_document(
                    doc, deadline_s=deadline_s, tenant=tenant)
            except Exception as e:  # noqa: BLE001 — same contract as
                # /v1/resolve: a runtime failure is a visible 500, not a
                # dropped connection.
                server.metrics.observe_error()
                status, resp = 500, {"error": f"internal error: {e}"}
            return self._send_json(status, resp)

        def _session_request(self):
            """POST /v1/session and /v1/session/{id}/op —
            the /v1/resolve request envelope (trace context, tenant
            identity, deadline header, SLO accounting) around the
            session store, so interactive exploration cost is
            attributable per tenant exactly like one-shot resolution
            cost."""
            inbound_tp = self.headers.get("traceparent")
            inbound_rid = self.headers.get("X-Deppy-Request-Id")
            ctx = telemetry.trace.context_from_headers(inbound_tp,
                                                       inbound_rid)
            self._trace_ctx = ctx
            self._echo_ids = inbound_tp is not None \
                or inbound_rid is not None
            self._echo_traceparent = inbound_tp is not None
            tenant = profiling.sanitize_tenant(
                self.headers.get("X-Deppy-Tenant"))
            timings: dict = {}
            t0 = time.perf_counter()
            reg = telemetry.default_registry()
            status = None
            try:
                span_attrs = {"path": self.path,
                              "request_id": ctx.request_id,
                              "tenant": tenant}
                if server.replica is not None:
                    span_attrs["replica"] = server.replica
                with telemetry.trace.activate(ctx), \
                        reg.span("service.request", **span_attrs) as sp:
                    status = self._session_request_inner(tenant)
                    sp["status"] = status
            finally:
                timings["total_s"] = time.perf_counter() - t0
                server.metrics.observe_request(timings["total_s"], None)
                server.slo.observe(
                    tenant, timings["total_s"],
                    deadline_miss=False,
                    error=status is None or status >= 500)
                telemetry.trace.default_recorder().record(
                    ctx, status=status, timings=timings)

        def _session_request_inner(self, tenant) -> int:
            deadline_s = None
            raw_deadline = self.headers.get("X-Deppy-Deadline-S")
            if raw_deadline is not None:
                import math

                try:
                    deadline_s = float(raw_deadline)
                except ValueError:
                    deadline_s = None
                if deadline_s is None or not math.isfinite(deadline_s):
                    server.metrics.observe_error()
                    return self._send_json(
                        400, {"error": "invalid X-Deppy-Deadline-S header"})
            doc, err = self._read_json_body()
            if err is not None:
                return err
            try:
                status, resp = server.session_document(
                    self.path, doc, deadline_s=deadline_s, tenant=tenant)
            except Exception as e:  # noqa: BLE001 — same contract as
                # /v1/resolve: a runtime failure (including an injected
                # sessions.op fault) is a visible 500, not a dropped
                # connection.
                server.metrics.observe_error()
                status, resp = 500, {"error": f"internal error: {e}"}
            return self._send_json(status, resp)

        def _resolve_request(self):
            # Per-request trace context: honor an inbound W3C
            # traceparent or X-Deppy-Request-Id, mint ids otherwise.
            # Every request is traced into the flight recorder; header
            # echo and the timings body key are the only response
            # changes, and the body changes only on explicit opt-in
            # (X-Deppy-Timings) — tracing-header-free responses stay
            # byte-identical.
            inbound_tp = self.headers.get("traceparent")
            inbound_rid = self.headers.get("X-Deppy-Request-Id")
            ctx = telemetry.trace.context_from_headers(inbound_tp,
                                                       inbound_rid)
            self._trace_ctx = ctx
            self._echo_ids = inbound_tp is not None or inbound_rid is not None
            self._echo_traceparent = inbound_tp is not None
            want_timings = (self.headers.get("X-Deppy-Timings") or "") \
                .strip().lower() in ("1", "true", "yes")
            # Tenant identity: X-Deppy-Tenant, sanitized to
            # a metric-label-safe id; absent/empty = the default
            # tenant.  Rides the root span's attrs (so `deppy stats
            # --tenant` filters from sink lines alone), the scheduler's
            # lanes, and the SLO accountant below.
            tenant = profiling.sanitize_tenant(
                self.headers.get("X-Deppy-Tenant"))
            timings: dict = {}
            request_stats: dict = {}
            t0 = time.perf_counter()
            reg = telemetry.default_registry()
            status = None
            try:
                # request_id rides the root span's attrs so `deppy
                # trace CLIENT-ID` resolves from live sink lines alone
                # (no flight-recorder dump required).
                # Replica identity rides the root span only when set
                #: replica-free deployments keep their
                # pre-fleet span attrs byte for byte.
                span_attrs = {"path": "/v1/resolve",
                              "request_id": ctx.request_id,
                              "tenant": tenant}
                if server.replica is not None:
                    span_attrs["replica"] = server.replica
                with telemetry.trace.activate(ctx), \
                        reg.span("service.request", **span_attrs) as sp:
                    status = self._resolve_request_inner(
                        t0, timings, want_timings, tenant, request_stats)
                    sp["status"] = status
            finally:
                # Runs even when the handler dies mid-response (client
                # disconnect → BrokenPipeError): the errored trace is
                # exactly the one the flight recorder's error ring
                # promises to retain, and the latency histogram must
                # count the request either way.  total_s is OVERWRITTEN
                # here — the opt-in body carries its own pre-send
                # snapshot, but the histogram/recorder interval must
                # not depend on whether the client sent X-Deppy-Timings.
                timings["total_s"] = time.perf_counter() - t0
                server.metrics.observe_request(timings["total_s"],
                                               timings.get("queue_wait_s"))
                # SLO accounting: every request lands on its
                # tenant's window — deadline misses from the
                # scheduler's triage, errors from the final status.
                server.slo.observe(
                    tenant, timings["total_s"],
                    deadline_miss=bool(
                        request_stats.get("deadline_misses")),
                    error=status is None or status >= 500)
                telemetry.trace.default_recorder().record(
                    ctx, status=status, timings=timings)

        def _resolve_request_inner(self, t0, timings, want_timings,
                                   tenant="default",
                                   request_stats=None) -> int:
            # Per-request deadline override: seconds of wall-clock budget
            # the client grants this resolve (proxy chains decrement it).
            deadline_s = None
            raw_deadline = self.headers.get("X-Deppy-Deadline-S")
            if raw_deadline is not None:
                import math

                try:
                    deadline_s = float(raw_deadline)
                except ValueError:
                    deadline_s = None
                # NaN would sail past every <= comparison (no 503, no
                # deadline at all) and inf would silently mean
                # "unbounded": both violate the header's contract.
                if deadline_s is None or not math.isfinite(deadline_s):
                    server.metrics.observe_error()
                    return self._send_json(
                        400, {"error": "invalid X-Deppy-Deadline-S header"})
            # A client-controlled Content-Length must not be able to
            # buffer unbounded memory on the service (enforced inside
            # the shared body reader).
            doc, err = self._read_json_body()
            if err is not None:
                return err
            try:
                status, resp = server.resolve_document(
                    doc, deadline_s=deadline_s, timings=timings,
                    tenant=tenant, request_stats=request_stats)
            except Exception as e:  # noqa: BLE001 — a solver or runtime
                # failure (on the card: a kernel that fails to build or
                # launch) → a real 500, visible to the caller and the
                # error counter, instead of a dropped connection from the
                # handler's default traceback.
                server.metrics.observe_error()
                status, resp = 500, {"error": f"internal error: {e}"}
            if want_timings:
                # Opt-in breakdown (X-Deppy-Timings: 1): queue-wait /
                # dispatch / solve / decode seconds in the body.  Without
                # the header the body is untouched (byte-identical).
                timings["total_s"] = time.perf_counter() - t0
                resp = dict(resp)
                resp["timings"] = {k: round(float(v), 6)
                                   for k, v in sorted(timings.items())}
            return self._send_json(status, resp)

    return Handler


def _probe_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path in ("/healthz", "/readyz"):
                ok = self.path == "/healthz" or server.serving()
                body = b"ok" if ok else b"not ready"
                if ok and self.path == "/readyz" and server.degraded():
                    # Still ready — the host engine serves — but say so:
                    # operators watching the probe see the degradation
                    # without waiting for a metrics scrape.
                    body = b"ok (degraded: accelerator breaker open)"
                self.send_response(200 if ok else 503)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(
    bind_address: str = ":8080",
    probe_address: str = ":8081",
    backend: str = "device",
    max_steps: Optional[int] = None,
    request_deadline_s: Optional[float] = None,
    sched: Optional[str] = None,
    sched_max_wait_ms: Optional[float] = None,
    sched_max_fill: Optional[int] = None,
    cache_size: Optional[int] = None,
    mesh_devices: Optional[int] = None,
    incremental: Optional[str] = None,
    incremental_max_delta: Optional[float] = None,
    incremental_index_size: Optional[int] = None,
    slo: Optional[str] = None,
    portfolio: Optional[str] = None,
    speculate: Optional[str] = None,
    speculate_max_backlog: Optional[int] = None,
    replica: Optional[str] = None,
    fair: Optional[str] = None,
    tenant_weights: Optional[str] = None,
    obs_stream: Optional[str] = None,
    obs_flush_ms: Optional[float] = None,
    obs_baseline: Optional[str] = None,
    fleet_router: Optional[str] = None,
    fleet_advertise: Optional[str] = None,
    opt: Optional[str] = None,
    opt_max_iterations: Optional[int] = None,
    opt_iter_budget: Optional[int] = None,
    opt_max_weight: Optional[int] = None,
    route_learn: Optional[str] = None,
    route_shadow_rate: Optional[float] = None,
    route_registry: Optional[str] = None,
    sessions: Optional[str] = None,
    session_lease_s: Optional[float] = None,
    session_max: Optional[int] = None,
    session_max_per_tenant: Optional[int] = None,
    device="cuda",
) -> None:
    """Blocking entry point of ``deppy serve`` (``deppy_tpu_torch/cli.py``),
    the analog of mgr.Start (main.go:85).  Exits cleanly on SIGTERM (how
    Kubernetes stops the shipped Deployment's pods) as well as Ctrl-C:
    readiness is cleared, in-flight requests drain (bounded by the
    request-deadline machinery), and both listeners close via
    ``shutdown()`` instead of dying mid-request."""
    import signal

    srv = Server(bind_address, probe_address, backend, max_steps,
                 request_deadline_s=request_deadline_s, sched=sched,
                 sched_max_wait_ms=sched_max_wait_ms,
                 sched_max_fill=sched_max_fill, cache_size=cache_size,
                 mesh_devices=mesh_devices, incremental=incremental,
                 incremental_max_delta=incremental_max_delta,
                 incremental_index_size=incremental_index_size,
                 slo=slo, portfolio=portfolio, speculate=speculate,
                 speculate_max_backlog=speculate_max_backlog,
                 replica=replica, fair=fair,
                 tenant_weights=tenant_weights,
                 obs_stream=obs_stream, obs_flush_ms=obs_flush_ms,
                 obs_baseline=obs_baseline, fleet_router=fleet_router,
                 fleet_advertise=fleet_advertise, opt=opt,
                 opt_max_iterations=opt_max_iterations,
                 opt_iter_budget=opt_iter_budget,
                 opt_max_weight=opt_max_weight,
                 route_learn=route_learn,
                 route_shadow_rate=route_shadow_rate,
                 route_registry=route_registry,
                 sessions=sessions, session_lease_s=session_lease_s,
                 session_max=session_max,
                 session_max_per_tenant=session_max_per_tenant,
                 device=device)
    srv.start()
    stop = threading.Event()

    def _on_sigterm(signum, frame):
        srv.ready.clear()  # flip /readyz before draining
        stop.set()

    def _on_sigusr2(signum, frame):
        # Operator-triggered flight-recorder dump: every
        # retained request trace goes to the JSONL sink as `trace`
        # events — `kill -USR2 $PID`, then read the sink.
        n = telemetry.trace.default_recorder().dump(reason="sigusr2")
        print(f"[service] SIGUSR2: dumped {n} flight-recorder trace(s) "
              f"to {telemetry.default_registry().sink_path or '(no sink)'}",
              file=sys.stderr, flush=True)

    # Handler goes in before the startup banner: the banner is the "ready
    # to be signaled" cue for process supervisors (and the e2e test).
    prev = signal.signal(signal.SIGTERM, _on_sigterm)
    prev_usr2 = None
    if hasattr(signal, "SIGUSR2"):  # absent on Windows
        prev_usr2 = signal.signal(signal.SIGUSR2, _on_sigusr2)
    print(
        f"deppy service listening on :{srv.api_port} "
        f"(probes on :{srv.probe_port})",
        flush=True,
    )
    try:
        while not stop.is_set():
            stop.wait(3600)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        if prev_usr2 is not None:
            signal.signal(signal.SIGUSR2, prev_usr2)
        srv.shutdown()
        # Host worker pool: after shutdown() drained requests
        # and stopped the scheduler loop, nothing can dispatch to the
        # pool — drain (the pool lock serializes against any straggler
        # dispatch) and terminate the workers.  Owned here, at the
        # PROCESS entry point, not in Server.shutdown: the pool is
        # process-global like the breaker, and embedded servers come
        # and go without owning it.
        from . import hostpool

        hostpool.shutdown_default_pool()
