"""Typed registry of every ``DEPPY_GPU_*`` environment knob (port of
``deppy_tpu/config.py:1-662``).

Every knob the port reads is declared here once: its name, type,
default (as the port reads it), consuming module and help text.  Three
things hang off the declaration:

  * **Typed reads.**  :func:`env_raw` (and the typed wrappers
    :func:`env_str` / :func:`env_int` / :func:`env_float` /
    :func:`env_bool`) resolve the environment *through* the registry —
    reading an undeclared ``DEPPY_GPU_*`` name raises
    :class:`UndeclaredEnvVar` at the call site instead of silently
    minting a knob nobody documented.  The fault layer's defensive
    parsers (``faults.env_float``, ``faults.env_int``) call
    :func:`require` first, so every read site resolves through the
    registry without changing its parse-or-degrade semantics.
  * **Generated docs.**  :func:`render_markdown` emits
    ``deppy_tpu_torch/configuration.md`` (``python -m
    deppy_tpu_torch.config > deppy_tpu_torch/configuration.md``);
    ``tests/test_torch_config.py`` pins the checked-in file against it.
  * **Lint.**  The same test scans the port's tree and ``chip_smoke.py``
    and fails on a ``DEPPY_GPU_*`` name read around this module, on a
    name missing from the registry, and on a declared name no code
    reads.

The knobs are the reference's ``DEPPY_TPU_*`` ones renamed, where the
port has them, plus the HA lease's ``DEPPY_GPU_HA_*`` (the reference's
``DEPPY_HA_*``).  ``flag`` and ``config_key`` stay ``None`` until the
port has its CLI (ROADMAP A7.2d).

Import-light on purpose (stdlib ``os``/``dataclasses`` only): every
module, the fault layer at the bottom of the import order included, can
import it without cycles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

_PREFIX = "DEPPY_GPU_"


class UndeclaredEnvVar(KeyError):
    """A ``DEPPY_GPU_*`` read of a name missing from :data:`REGISTRY`."""


@dataclass(frozen=True)
class EnvVar:
    """One declared environment knob.  ``flag`` / ``config_key`` declare
    the knob's CLI-flag and config-file mirrors, once the port has a CLI
    (ROADMAP A7.2d)."""

    name: str
    type: str       # "int" | "float" | "str" | "bool" | "path"
    default: object  # documented default; None = unset/off
    consumer: str   # primary reading module (dotted path)
    help: str
    flag: Optional[str] = None        # mirrored CLI flag (--foo-bar)
    config_key: Optional[str] = None  # mirrored config file key


def _v(name: str, type: str, default, consumer: str, help: str,
       flag: Optional[str] = None,
       config_key: Optional[str] = None) -> EnvVar:
    return EnvVar(name=name, type=type, default=default,
                  consumer=consumer, help=help, flag=flag,
                  config_key=config_key)


_P = "deppy_tpu_torch."

# Declaration order groups by subsystem; rendering sorts by name so the
# doc table is stable under insertion.
_DECLARATIONS: List[EnvVar] = [
    # --- telemetry -------------------------------------------------------
    _v("DEPPY_GPU_TELEMETRY_FILE", "path", None, _P + "telemetry.registry",
       "JSONL event sink for spans, reports and fault events; summarize "
       "with `profile.report.summarize`."),
    _v("DEPPY_GPU_TRACE_RING", "int", 64, _P + "telemetry.trace",
       "Flight-recorder capacity: recent completed request traces "
       "(malformed reads the default)."),
    _v("DEPPY_GPU_TRACE_ERROR_RING", "int", 256, _P + "telemetry.trace",
       "Flight-recorder error ring: errored traces retained separately "
       "so healthy bursts cannot evict incident context."),
    # --- profiler / SLO --------------------------------------------------
    _v("DEPPY_GPU_PROFILE", "str", "off", _P + "profile.ledger",
       "Engine cost profiler: 'on' records the per-dispatch trip ledger "
       "(`profile` sink events, deppy_profile_* families, SolveReport "
       "ledger columns).  Disarmed is byte-identical to the "
       "pre-profiler pipeline."),
    _v("DEPPY_GPU_PROFILE_SAMPLE", "float", 1.0, _P + "profile.ledger",
       "Fraction of dispatches the armed profiler samples, in (0, 1] "
       "(deterministic 1-in-N; malformed reads the default)."),
    _v("DEPPY_GPU_SLO", "str", None, _P + "profile.slo",
       "Declarative per-tenant SLO config: inline JSON, @FILE, or a path "
       "mapping tenant -> {target_p99_s, error_budget}; burn rates "
       "render on /metrics and /debug/slo."),
    # --- faults ----------------------------------------------------------
    _v("DEPPY_GPU_FAULT_PLAN", "str", None, _P + "faults.inject",
       "Fault-injection plan: inline JSON, @FILE, or a file path; a "
       "malformed plan raises."),
    _v("DEPPY_GPU_FAULT_RETRIES", "int", 2, _P + "faults.policy",
       "Total attempts per device dispatch group (2 = one retry)."),
    _v("DEPPY_GPU_FAULT_BACKOFF_S", "float", 0.05, _P + "faults.policy",
       "Base exponential-backoff sleep between dispatch retries."),
    _v("DEPPY_GPU_FAULT_BACKOFF_MAX_S", "float", 2.0, _P + "faults.policy",
       "Backoff clamp: no retry sleeps longer than this."),
    _v("DEPPY_GPU_CHUNK_DEADLINE_S", "float", 0.0, _P + "faults.policy",
       "Wall-clock bound on ONE dispatch attempt; exceeding it counts "
       "deppy_deadline_exceeded and charges the breaker (0 = off)."),
    _v("DEPPY_GPU_BATCH_DEADLINE_S", "float", None, _P + "faults.policy",
       "Ambient wall-clock budget for a whole resolve batch; expiry "
       "degrades undispatched lanes to Incomplete (<= 0 or malformed: "
       "none, with a warning when malformed)."),
    _v("DEPPY_GPU_BREAKER_THRESHOLD", "int", 3, _P + "faults.breaker",
       "Consecutive device failures that trip the circuit breaker open "
       "(host-only serving); the process breaker and every per-device "
       "breaker of a mesh."),
    _v("DEPPY_GPU_BREAKER_RESET_S", "float", 30.0, _P + "faults.breaker",
       "Breaker cooldown before one half-open probe dispatch."),
    # --- scheduler / cache ----------------------------------------------
    _v("DEPPY_GPU_SCHED", "str", "on", _P + "service",
       "Cross-request continuous-batching scheduler in front of the "
       "service ('off' dispatches each request on its own)."),
    _v("DEPPY_GPU_SCHED_MAX_WAIT_MS", "float", 5.0,
       _P + "sched.scheduler",
       "Flush policy: max milliseconds the oldest queued problem waits "
       "for batchmates."),
    _v("DEPPY_GPU_SCHED_MAX_FILL", "int", 256, _P + "sched.scheduler",
       "Flush policy: dispatch once a size class has this many lanes "
       "queued (under a mesh the default is slots x lanes per device)."),
    _v("DEPPY_GPU_SCHED_MAX_DEPTH", "int", 4096, _P + "sched.scheduler",
       "Queue depth past which admission returns 503 + Retry-After "
       "(0 = unbounded)."),
    _v("DEPPY_GPU_SCHED_LANES_PER_DEVICE", "int", 256,
       _P + "sched.scheduler",
       "Mesh serving: a full flush targets n_slots x this many lanes so "
       "every slot gets a full shard."),
    _v("DEPPY_GPU_CACHE_SIZE", "int", 1024, _P + "sched.scheduler",
       "Canonical-form result-cache capacity in entries (0 disables)."),
    # --- portfolio racing -------------------------------------------------
    _v("DEPPY_GPU_PORTFOLIO", "str", "auto", _P + "sched.scheduler",
       "Portfolio engine racing: 'on' races the top-K candidate backends "
       "per cold flush and serves the first definitive finisher; 'auto' "
       "races only size classes holding a measured `portfolio` row; "
       "'off' restores the single-backend dispatch path."),
    _v("DEPPY_GPU_PORTFOLIO_K", "int", 2, _P + "sched.scheduler",
       "Top-K candidate backends raced per coalesced flush (min 2)."),
    _v("DEPPY_GPU_PORTFOLIO_SAMPLE_CHECK", "float", 0.0625,
       _P + "sched.scheduler",
       "Deterministic 1-in-N fraction of non-canonical race wins "
       "cross-checked against the canonical backend's answer (0 "
       "disables)."),
    # --- speculative pre-resolution --------------------------------------
    _v("DEPPY_GPU_SPECULATE", "str", "on", _P + "sched.scheduler",
       "Speculative pre-resolution: catalog publishes invalidate "
       "retracted cache entries and pre-solve affected cached families "
       "at idle priority ('off' constructs no manager)."),
    _v("DEPPY_GPU_SPECULATE_MAX_BACKLOG", "int", 2048,
       _P + "sched.scheduler",
       "Speculative pre-solve backlog cap in lanes; pre-solves past it "
       "are dropped and counted."),
    # --- incremental tier ------------------------------------------------
    _v("DEPPY_GPU_INCREMENTAL", "str", "on", _P + "sched.scheduler",
       "Delta-aware incremental resolution: clause-set index + "
       "warm-start lane class in front of the exact result cache "
       "('off' removes the tier)."),
    _v("DEPPY_GPU_INCREMENTAL_MAX_DELTA", "float", 0.25,
       _P + "sched.scheduler",
       "Warm-start cutoff: deltas whose touched cone covers more than "
       "this fraction of the problem's variables cold-solve instead."),
    _v("DEPPY_GPU_INCREMENTAL_INDEX_SIZE", "int", 512,
       _P + "sched.scheduler",
       "Clause-set index capacity in solved-problem entries (0 disables "
       "the tier)."),
    # --- optimization tier -----------------------------------------------
    _v("DEPPY_GPU_OPT", "str", "on", _P + "service",
       "Optimization tier: POST /v1/optimize ('off' 404s the "
       "endpoint)."),
    _v("DEPPY_GPU_OPT_MAX_ITERATIONS", "int", 64, _P + "optimize.loop",
       "Bound-tightening iteration cap per optimize request; hitting it "
       "returns the best model found so far flagged non-optimal."),
    _v("DEPPY_GPU_OPT_ITER_BUDGET", "int", 1048576, _P + "optimize.loop",
       "Engine-step budget per tightening probe; an exhausted probe "
       "degrades the request to best-so-far."),
    _v("DEPPY_GPU_OPT_MAX_WEIGHT", "int", 64, _P + "optimize.loop",
       "Largest accepted soft-constraint weight; heavier requests are "
       "rejected as malformed."),
    # --- stateful sessions -----------------------------------------------
    _v("DEPPY_GPU_SESSIONS", "str", "on", _P + "service",
       "Stateful resolution sessions: POST /v1/session and "
       "/v1/session/{id}/op ('off' constructs none of it)."),
    _v("DEPPY_GPU_SESSION_LEASE_S", "float", 300.0, _P + "sessions",
       "Session lease in seconds: every op renews it; the sweeper "
       "expires sessions whose lease lapsed."),
    _v("DEPPY_GPU_SESSION_MAX", "int", 256, _P + "sessions",
       "Hard cap on live sessions per replica; at the cap, expired "
       "sessions are LRU-evicted first and creation sheds 503 once none "
       "remain."),
    _v("DEPPY_GPU_SESSION_MAX_PER_TENANT", "int", 64, _P + "sessions",
       "Per-tenant session cap: a tenant at its cap sheds 503 even with "
       "global headroom."),
    # --- fleet -----------------------------------------------------------
    _v("DEPPY_GPU_FLEET_REPLICAS", "str", None, _P + "fleet.router",
       "Replica addresses the affinity router fronts, comma-separated "
       "host:port."),
    _v("DEPPY_GPU_FLEET_VNODES", "int", 64, _P + "fleet.router",
       "Virtual nodes per replica on the consistent-hash ring."),
    _v("DEPPY_GPU_FLEET_PROBE_INTERVAL_S", "float", 2.0,
       _P + "fleet.router",
       "Seconds between router health probes per replica (0 disables "
       "probing; forwards still charge the breaker)."),
    _v("DEPPY_GPU_FLEET_PROBE_FAILURES", "int", 3, _P + "fleet.router",
       "Consecutive transport failures (probe or live forward) that "
       "mark a replica dead and reassign its ring arcs."),
    _v("DEPPY_GPU_REPLICA", "str", None, _P + "service",
       "This replica's serving identity in a fleet: labels the "
       "per-tenant SLO families, /debug/slo and the service.request "
       "span."),
    _v("DEPPY_GPU_FLEET", "str", "elastic", _P + "fleet.membership",
       "Fleet membership mode: 'elastic' arms runtime joins, "
       "drain-as-leave, peer gossip and GET /fleet/policy; 'static' "
       "keeps an immutable ring."),
    _v("DEPPY_GPU_FLEET_PEERS", "str", None, _P + "fleet.router",
       "Peer router addresses for membership gossip, comma-separated "
       "host:port."),
    _v("DEPPY_GPU_FLEET_SYNC_INTERVAL_S", "float", 2.0,
       _P + "fleet.router",
       "Seconds between membership gossip rounds with the peer list (0 "
       "disables the background loop)."),
    _v("DEPPY_GPU_FLEET_PROBE_JITTER", "float", 0.2, _P + "fleet.router",
       "Random fraction of the probe (and gossip) interval added to each "
       "cycle's sleep, clamped to [0, 1]."),
    _v("DEPPY_GPU_FLEET_JOIN_CHUNK", "int", 64, _P + "fleet.membership",
       "Warm-state entries per checksummed join-stream chunk."),
    _v("DEPPY_GPU_FLEET_JOIN_RETRIES", "int", 2, _P + "fleet.membership",
       "Resend attempts per failed join-stream chunk before the join "
       "aborts (membership unchanged)."),
    _v("DEPPY_GPU_FLEET_ROUTER", "str", None, _P + "service",
       "Fleet router address this replica announces itself to: POST "
       "/fleet/join once serving starts, the drain handoff on graceful "
       "shutdown."),
    _v("DEPPY_GPU_FLEET_ADVERTISE", "str", None, _P + "service",
       "host:port this replica advertises when joining a fleet (default "
       "127.0.0.1:<api-port>)."),
    _v("DEPPY_GPU_FLEET_BURN_UP", "float", 1.0, _P + "fleet.policy",
       "Per-tenant SLO burn-rate threshold above which the scale policy "
       "recommends scale_up or rebalance on GET /fleet/policy."),
    _v("DEPPY_GPU_FLEET_BURN_DOWN", "float", 0.25, _P + "fleet.policy",
       "Per-tenant SLO burn-rate floor: every replica under it with an "
       "idle queue recommends scale_down."),
    # --- scheduler fairness ----------------------------------------------
    _v("DEPPY_GPU_SCHED_FAIR", "str", "on", _P + "sched.scheduler",
       "Weighted-fair per-tenant admission + priority lanes ('off' "
       "restores the global-depth 503 and strict FIFO)."),
    _v("DEPPY_GPU_SCHED_TENANT_WEIGHTS", "str", None,
       _P + "sched.scheduler",
       "Declarative tenant weights/priorities for the fair gate: inline "
       "JSON, @FILE, or a path mapping tenant -> weight or {weight, "
       "priority}."),
    # --- observability plane ---------------------------------------------
    _v("DEPPY_GPU_OBS_STREAM", "str", None, _P + "service",
       "Fleet telemetry streaming: aggregator address (host:port, "
       "normally the router) this replica batch-pushes its sink events "
       "to via POST /fleet/telemetry."),
    _v("DEPPY_GPU_OBS_FLUSH_MS", "float", 200.0, _P + "obs.stream",
       "Max milliseconds a queued telemetry event waits before the "
       "streamer flushes a batch (malformed reads the default)."),
    _v("DEPPY_GPU_OBS_QUEUE", "int", 4096, _P + "obs.stream",
       "Streamer queue capacity in events; past it events are dropped "
       "and counted."),
    _v("DEPPY_GPU_OBS_BATCH", "int", 256, _P + "obs.stream",
       "Max events per streamed POST /fleet/telemetry batch."),
    _v("DEPPY_GPU_OBS_BACKOFF_MAX_S", "float", 5.0, _P + "obs.stream",
       "Ceiling in seconds on the streamer's exponential hold-off after "
       "a failed telemetry POST."),
    _v("DEPPY_GPU_OBS_SINK", "path", None, _P + "fleet.router",
       "Router-side merged fleet sink: JSONL path the telemetry "
       "aggregator appends replica-stamped events to; unset 404s POST "
       "/fleet/telemetry."),
    _v("DEPPY_GPU_OBS_BASELINE", "path", None, _P + "service",
       "Cost-model baseline for the drift watchdog (a `profile` report "
       "or any JSON with a `costmodel` section); unset disarms it."),
    _v("DEPPY_GPU_OBS_DRIFT_BAND", "float", 0.5, _P + "obs.drift",
       "Relative drift band for the cost-model watchdog."),
    _v("DEPPY_GPU_OBS_DRIFT_MIN", "int", 8, _P + "obs.drift",
       "Minimum sampled device dispatches per size class before the "
       "drift watchdog compares."),
    # --- route health ----------------------------------------------------
    _v("DEPPY_GPU_ROUTE_LEARN", "str", "off", _P + "routes",
       "Route-health plane: 'off' arms nothing; 'observe' runs the "
       "regret ledger, staleness watcher and shadow probing; 'on' adds "
       "the online route registry's learned rows."),
    _v("DEPPY_GPU_ROUTE_SHADOW_RATE", "float", 0.0625,
       _P + "routes.shadow",
       "Fraction of a stale class's flushes duplicated to one "
       "non-serving backend at idle priority (0 disables)."),
    _v("DEPPY_GPU_ROUTE_MAX_AGE_S", "float", 604800.0,
       _P + "routes.staleness",
       "Measured-defaults provenance age past which a live class's "
       "routing row is flagged stale (default 7 days)."),
    _v("DEPPY_GPU_ROUTE_MIN_SAMPLES", "int", 8, _P + "routes.learn",
       "Uncensored live observations per (class, backend) before the "
       "online route registry re-ranks."),
    _v("DEPPY_GPU_ROUTE_DECAY", "float", 0.2, _P + "routes",
       "EWMA weight of the newest observation in the regret ledger's "
       "wall estimates, in (0, 1]."),
    _v("DEPPY_GPU_ROUTE_REGISTRY", "path", None, _P + "routes.learn",
       "Optional path where live-learned routing rows persist; unset "
       "keeps adoptions in memory."),
    # --- service ---------------------------------------------------------
    _v("DEPPY_GPU_REQUEST_DEADLINE_S", "float", None, _P + "service",
       "Default wall-clock budget per /v1/resolve request (clients "
       "override via X-Deppy-Deadline-S; malformed warns and reads "
       "unset)."),
    _v("DEPPY_GPU_DRAIN_S", "float", None, _P + "service",
       "Graceful-shutdown bound on draining in-flight requests (default: "
       "the request deadline, else 10 s)."),
    _v("DEPPY_GPU_REPROBE", "float", 600.0, _P + "service",
       "Seconds between background device re-probes while serving "
       "degraded (0 disables; malformed warns and reads 600)."),
    # --- HA lease (the reference's DEPPY_HA_*) ---------------------------
    _v("DEPPY_GPU_HA_LEASE", "str", None, _P + "utils.lease",
       "Leader-election lease name; empty or unset disables election."),
    _v("DEPPY_GPU_HA_API", "str", None, _P + "utils.lease",
       "Lease API base URL override (default: in-cluster discovery)."),
    _v("DEPPY_GPU_HA_NAMESPACE", "str", None, _P + "utils.lease",
       "Lease namespace override."),
    _v("DEPPY_GPU_HA_LEASE_SECONDS", "int", 15, _P + "utils.lease",
       "Lease duration in seconds (malformed or < 1 reads 15)."),
    # --- hostpool --------------------------------------------------------
    _v("DEPPY_GPU_HOST_WORKERS", "int", None, _P + "hostpool.pool",
       "Host-engine worker pool size (default min(cpu_count, 8); 0 = "
       "inline serial engine)."),
    _v("DEPPY_GPU_HOST_WORKER_RECYCLE", "int", 256, _P + "hostpool.pool",
       "Solves per worker before it is retired and replaced (0 = "
       "never)."),
    _v("DEPPY_GPU_HOSTPOOL_SPAWN_TIMEOUT_S", "float", 30.0,
       _P + "hostpool.pool",
       "Bound on a spawned worker's ready handshake."),
    # --- mesh serving ----------------------------------------------------
    _v("DEPPY_GPU_MESH_DEVICES", "int", None, _P + "parallel.mesh",
       "Shard each coalesced micro-batch across N CUDA devices "
       "('all'/-1 = every visible card; unset/0/1 = single-device "
       "dispatch; malformed warns and reads unset)."),
    # --- engine ----------------------------------------------------------
    _v("DEPPY_GPU_HOST_CORE_NCONS", "int", 768, _P + "engine.driver",
       "Constraint count above which UNSAT-core extraction routes to "
       "the host engine (read at import; malformed raises)."),
    _v("DEPPY_GPU_BANK_OCC_CAP", "int", 0, _P + "engine.driver",
       "Watched-bank occurrence-width cap: a bucket whose max "
       "per-literal clause count exceeds it keeps dummy banks and runs "
       "the dense rounds (0 = the size class's cap; read at import)."),
    _v("DEPPY_GPU_BCP", "str", "auto", _P + "engine.core",
       "BCP implementation: auto/bits/blockwise/watched/gather/pallas "
       "('auto' is 'bits'; read at import)."),
    _v("DEPPY_GPU_MEASURED_DEFAULTS", "path", None, _P + "engine.defaults",
       "Override path of the measured-defaults registry JSON (default: "
       "the package-local engine/measured_defaults.json)."),
    _v("DEPPY_GPU_BLOCK_ROWS", "int", 2048, _P + "engine.cuda_blockwise",
       "Clause-row tile height of the blockwise BCP kernel (read at "
       "import; malformed raises)."),
]

REGISTRY: "dict[str, EnvVar]" = {v.name: v for v in _DECLARATIONS}
assert len(REGISTRY) == len(_DECLARATIONS), "duplicate EnvVar declaration"


def declared(name: str) -> bool:
    return name in REGISTRY


def require(name: str) -> Optional[EnvVar]:
    """Assert ``name`` is a declared knob.  Only ``DEPPY_GPU_*`` names
    are enforced — the defensive parse helpers are shared with
    non-namespaced names this registry does not own.  Returns the
    declaration (None for foreign names)."""
    if not name.startswith(_PREFIX):
        return None
    try:
        return REGISTRY[name]
    except KeyError:
        raise UndeclaredEnvVar(
            f"{name} is not declared in deppy_tpu_torch.config.REGISTRY — "
            f"declare it (name, type, default, consumer, help) so "
            f"deppy_tpu_torch/configuration.md stays in sync"
        ) from None


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """``os.environ.get`` through the registry: the declaration is
    asserted, the value comes back verbatim (callers keep their own
    parse-or-degrade semantics)."""
    require(name)
    return os.environ.get(name, default)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    raw = env_raw(name)
    return raw if raw is not None and raw.strip() else default


def env_int(name: str, default: Optional[int] = None,
            strict: bool = True) -> Optional[int]:
    """Typed int read.  ``strict`` raises on a malformed value;
    ``strict=False`` degrades to the default like the fault layer's
    parsers."""
    raw = env_raw(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        if strict:
            raise
        return default


def env_float(name: str, default: Optional[float] = None,
              strict: bool = True) -> Optional[float]:
    raw = env_raw(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        if strict:
            raise
        return default


_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off", ""))


def env_bool(name: str, default: bool = False) -> bool:
    raw = env_raw(name)
    if raw is None:
        return default
    token = raw.strip().lower()
    if token in _TRUE:
        return True
    if token in _FALSE:
        return False
    return default


# ------------------------------------------------------------------ docs


def _fmt_default(v: EnvVar) -> str:
    if v.default is None:
        return "(unset)"
    if v.type == "bool":
        return "on" if v.default else "off"
    return str(v.default)


def render_markdown() -> str:
    """The ``deppy_tpu_torch/configuration.md`` body, generated from the
    registry.  ``python -m deppy_tpu_torch.config`` prints it;
    tests/test_torch_config.py pins the checked-in copy against this."""
    lines = [
        "# Configuration of the PyTorch/CUDA port",
        "",
        "<!-- GENERATED FILE — do not edit by hand.",
        "     Regenerate with: python -m deppy_tpu_torch.config > "
        "deppy_tpu_torch/configuration.md",
        "     Source of truth: deppy_tpu_torch/config.py (REGISTRY). -->",
        "",
        "Every `DEPPY_GPU_*` environment knob, generated from the typed",
        "registry in `deppy_tpu_torch/config.py`.  `tests/test_torch_config.py`",
        "fails on any knob read in code but missing here, on any knob",
        "declared here that no code reads, and on a read that bypasses",
        "the registry.  The Mirrors column names the knob's CLI-flag and",
        "config-key twins once the port has its CLI.",
        "",
        "| Name | Type | Default | Consumer | Mirrors | Description |",
        "| --- | --- | --- | --- | --- | --- |",
    ]
    for name in sorted(REGISTRY):
        v = REGISTRY[name]
        mirrors = " ".join(
            f"`{m}`" for m in (v.flag, v.config_key) if m) or "—"
        lines.append(
            f"| `{v.name}` | {v.type} | `{_fmt_default(v)}` | "
            f"`{v.consumer}` | {mirrors} | {v.help} |")
    lines.append("")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    sys.stdout.write(render_markdown())
