"""Command-line interface of the port (copy of ``deppy_tpu/cli.py:1-2075``).

``python -m deppy_tpu_torch <verb>`` behaves as ``python -m deppy_tpu
<verb>`` does: the same verbs, flags, config keys, output and exit
codes.  Exit codes: 0 = all problems satisfiable, 1 = at least one
unsatisfiable, 2 = bad input / usage, 3 = incomplete (iteration budget
exhausted before a definitive answer).

Where the port differs, on purpose:

  * ``--backend`` takes ``auto``, ``host`` and ``device`` (the
    reference's ``tpu``); any other value is a usage error.
  * ``--device {cuda,cpu}`` on ``resolve``, ``serve`` and ``fleet
    scale`` stands for the reference's ``JAX_PLATFORMS``.  It defaults
    to ``cuda``; without a card ``resolve`` is a usage error (exit 2, no
    answer printed): nothing falls back to the CPU unasked.
  * ``resolve --backend`` and ``serve``'s built-in backend default to
    ``device``, where the reference's default to ``auto``: a default
    must not quietly resolve to the host when no card is found.
  * The knobs are ``DEPPY_GPU_*`` (the reference's ``DEPPY_TPU_*``).
  * ``bench`` waits for ROADMAP A7.2b; ``lint``, ``compiles`` and
    ``doctor`` for A7.2c.  Each is in the parser, and running one is a
    usage error naming its item.  The parser imports nothing of them,
    so a missing module never takes down another verb.
  * The reference's ``main`` first asserts JAX's platform and arms
    XLA's compile cache (``utils/platform_env.py``); the port compiles
    no XLA program, and the kernels' build cache (``engine/_build.py``)
    is reused across processes already.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import io as problem_io
from .sat.errors import (BackendCapabilityError, DuplicateIdentifier,
                         InternalSolverError)

# The verbs whose modules the port has not yet: verb -> ROADMAP item.
DEFERRED = {"bench": "A7.2b", "lint": "A7.2c", "compiles": "A7.2c",
            "doctor": "A7.2c"}


def _mesh_devices_arg(raw: str) -> int:
    """--mesh-devices value: a device count, or 'all' → -1 (every local
    device) — the same spelling DEPPY_GPU_MESH_DEVICES accepts
    (``deppy_tpu/cli.py:34``)."""
    if raw.strip().lower() == "all":
        return -1
    try:
        return int(raw)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'all', got {raw!r}")


def _add_device(p: argparse.ArgumentParser, what: str) -> None:
    """``--device``: the torch device the solves of ``what`` run on."""
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help=f"torch device {what} (default cuda, which fails without a "
        "card; cpu runs the kernels' plain PyTorch versions)",
    )


def _build_parser() -> argparse.ArgumentParser:
    """Every verb and flag (``deppy_tpu/cli.py:46-850``)."""
    parser = argparse.ArgumentParser(
        prog="deppy",
        description="deppy-tpu: an open-source constraint solver framework, "
        "PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command")

    p_resolve = sub.add_parser(
        "resolve", help="resolve a problem file and print the solution(s)"
    )
    p_resolve.add_argument(
        "file", help="JSON problem file (see deppy_tpu_torch.io)")
    p_resolve.add_argument(
        "--backend",
        choices=["auto", "host", "device"],
        default="device",
        help="solver backend (default: device — the kernels on --device; "
        "auto takes the device when a probe solve succeeds there, else "
        "the host engine)",
    )
    _add_device(p_resolve, "the problems are solved on")
    p_resolve.add_argument(
        "--output",
        choices=["text", "json"],
        default="text",
        help="output format (default: text)",
    )
    p_resolve.add_argument(
        "--max-steps",
        type=int,
        default=None,
        help="iteration budget per problem; exceeding it reports incomplete",
    )
    p_resolve.add_argument(
        "--checkpoint-dir",
        default=None,
        metavar="DIR",
        help="persist each dispatch group's results under DIR and resume "
        "a crashed batch run from its completed groups (tensor backend; "
        "see deppy_tpu_torch.engine.checkpoint)",
    )
    p_resolve.add_argument(
        "--telemetry-file",
        default=None,
        metavar="FILE",
        help="append every pipeline span and the per-batch solve report "
        "as JSONL events to FILE (also via DEPPY_GPU_TELEMETRY_FILE; "
        "summarize with `deppy stats FILE`)",
    )
    p_resolve.add_argument(
        "--report",
        action="store_true",
        help="print the per-batch solve report (padding occupancy, "
        "escalation stage, host fallback) on stderr after resolving",
    )
    p_resolve.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="SECONDS",
        help="wall-clock budget for the whole resolve: problems not "
        "dispatched before it expires report incomplete instead of the "
        "batch aborting (also via DEPPY_GPU_BATCH_DEADLINE_S)",
    )
    p_resolve.add_argument(
        "--fault-plan",
        default=None,
        metavar="SPEC",
        help="arm the fault-injection harness: inline JSON, @FILE, or a "
        "path to a JSON fault plan (also via DEPPY_GPU_FAULT_PLAN; see "
        "docs/robustness.md)",
    )
    p_resolve.add_argument(
        "--host-workers", type=int, default=None, metavar="N",
        help="host-engine worker pool size for host-path solves "
        "(default min(cpu_count, 8); 0 = inline serial engine; also "
        "via DEPPY_GPU_HOST_WORKERS — see docs/robustness.md)",
    )

    # The deferred verbs (``DEFERRED``) take any arguments and only exit
    # 2: their flags come with the verbs, in ROADMAP A7.2b and A7.2c.
    sub.add_parser(
        "bench", help="run the headline benchmark (one JSON line on "
        "stdout; waits for ROADMAP A7.2b)"
    )

    p_serve = sub.add_parser(
        "serve", help="run the batch-resolution service"
    )
    # Serve flags default to None (sentinel) so precedence layers cleanly:
    # built-in defaults < --config file values < explicitly passed flags.
    p_serve.add_argument(
        "--bind-address", default=None,
        help="API + metrics listen address (reference main.go:48-49 "
        "metrics-bind-address; default :8080)",
    )
    p_serve.add_argument(
        "--health-probe-bind-address", default=None,
        help="healthz/readyz listen address (reference main.go:50; "
        "default :8081)",
    )
    p_serve.add_argument(
        "--backend", choices=["auto", "host", "device"], default=None,
        help="solver backend (default device; with the breaker open a "
        "device server sheds 503s, an auto server drains on the host)",
    )
    _add_device(p_serve, "the service solves on")
    p_serve.add_argument("--max-steps", type=int, default=None)
    p_serve.add_argument(
        "--config", default=None, metavar="FILE",
        help="ResolverConfig file (the analog of the reference's "
        "controller_manager_config.yaml, config/manager/"
        "controller_manager_config.yaml:1-11); explicitly passed flags "
        "override file values",
    )
    p_serve.add_argument(
        "--telemetry-file", default=None, metavar="FILE",
        help="append every pipeline span and per-batch solve report as "
        "JSONL events to FILE (also via DEPPY_GPU_TELEMETRY_FILE)",
    )
    p_serve.add_argument(
        "--request-deadline", type=float, default=None, metavar="SECONDS",
        help="default wall-clock budget per /v1/resolve request; clients "
        "override with the X-Deppy-Deadline-S header (also via "
        "DEPPY_GPU_REQUEST_DEADLINE_S)",
    )
    p_serve.add_argument(
        "--fault-plan", default=None, metavar="SPEC",
        help="arm the fault-injection harness for the whole service "
        "(inline JSON, @FILE, or a path; also via DEPPY_GPU_FAULT_PLAN)",
    )
    p_serve.add_argument(
        "--sched", choices=["on", "off"], default=None,
        help="cross-request continuous-batching scheduler (default on; "
        "also via DEPPY_GPU_SCHED).  'off' restores per-request "
        "dispatch — responses are byte-identical either way",
    )
    p_serve.add_argument(
        "--sched-max-wait-ms", type=float, default=None, metavar="MS",
        help="scheduler flush policy: max milliseconds a queued problem "
        "waits for batchmates before dispatching (default 5; also via "
        "DEPPY_GPU_SCHED_MAX_WAIT_MS) — a lone request keeps low "
        "latency, a burst coalesces",
    )
    p_serve.add_argument(
        "--sched-max-fill", type=int, default=None, metavar="N",
        help="scheduler flush policy: dispatch as soon as a size class "
        "has N problems queued (default 256; also via "
        "DEPPY_GPU_SCHED_MAX_FILL)",
    )
    p_serve.add_argument(
        "--cache-size", type=int, default=None, metavar="N",
        help="canonical-form result-cache capacity in entries (default "
        "1024, 0 disables; also via DEPPY_GPU_CACHE_SIZE) — repeated "
        "identical problems are answered without a dispatch",
    )
    p_serve.add_argument(
        "--host-workers", type=int, default=None, metavar="N",
        help="host-engine worker pool size for breaker-open / "
        "host-backend serving (default min(cpu_count, 8); 0 = inline "
        "serial engine; also via DEPPY_GPU_HOST_WORKERS)",
    )
    p_serve.add_argument(
        "--incremental", choices=["on", "off"], default=None,
        help="delta-aware incremental resolution tier (default on; "
        "also via DEPPY_GPU_INCREMENTAL).  'off' removes the clause-set "
        "index and warm-start lane class, restoring pre-tier dispatch "
        "byte for byte",
    )
    p_serve.add_argument(
        "--incremental-max-delta", type=float, default=None,
        metavar="RATIO",
        help="touched-cone cutoff for warm starts: a delta whose cone "
        "covers more than this fraction of the problem's variables "
        "cold-solves instead (default 0.25; also via "
        "DEPPY_GPU_INCREMENTAL_MAX_DELTA)",
    )
    p_serve.add_argument(
        "--incremental-index-size", type=int, default=None, metavar="N",
        help="clause-set index capacity in entries (default 512, 0 "
        "disables the tier; also via DEPPY_GPU_INCREMENTAL_INDEX_SIZE)",
    )
    p_serve.add_argument(
        "--portfolio", choices=["auto", "on", "off"], default=None,
        help="portfolio engine racing: race the top-K "
        "candidate backends per cold flush and serve the first "
        "definitive finisher, cross-checked by sampled differential "
        "comparison (default auto — race only size classes with a "
        "measured `portfolio` row; 'off' restores single-backend "
        "dispatch byte for byte; also via DEPPY_GPU_PORTFOLIO)",
    )
    p_serve.add_argument(
        "--speculate", choices=["on", "off"], default=None,
        help="speculative pre-resolution: catalog publishes "
        "(POST /v1/catalog/publish / `deppy publish`) pre-solve "
        "affected cached families at idle priority and the what-if "
        "preview endpoint serves proposed-change resolutions read-only "
        "(default on; 'off' restores pre-change dispatch byte for byte "
        "and 404s both endpoints; also via DEPPY_GPU_SPECULATE)",
    )
    p_serve.add_argument(
        "--speculate-max-backlog", type=int, default=None, metavar="N",
        help="speculative pre-solve backlog cap in lanes — pre-solves "
        "past it are dropped and counted (default 2048; also via "
        "DEPPY_GPU_SPECULATE_MAX_BACKLOG)",
    )
    p_serve.add_argument(
        "--slo", default=None, metavar="SPEC",
        help="declarative per-tenant SLO config: inline JSON, @FILE, "
        "or a path mapping tenant -> {target_p99_s, error_budget} "
        "(also via DEPPY_GPU_SLO); burn rates ride /metrics and "
        "/debug/slo",
    )
    p_serve.add_argument(
        "--bcp",
        choices=["auto", "gather", "bits", "pallas", "blockwise",
                 "watched"],
        default=None,
        help="BCP propagation implementation (default auto — the "
        "measured-defaults registry, falling back to bits; also via "
        "DEPPY_GPU_BCP).  'watched' selects the compressed-clause-bank "
        "implication-driven engine",
    )
    p_serve.add_argument(
        "--profile", choices=["on", "off"], default=None,
        help="engine cost profiler: per-dispatch trip ledger + "
        "per-backend cost attribution as `profile` sink events and "
        "deppy_profile_* metric families (default off; also via "
        "DEPPY_GPU_PROFILE; summarize with `deppy profile`)",
    )
    p_serve.add_argument(
        "--profile-sample", type=float, default=None, metavar="RATE",
        help="fraction of dispatches the armed profiler samples, in "
        "(0, 1] (default 1.0; also via DEPPY_GPU_PROFILE_SAMPLE) — "
        "bounds the armed overhead",
    )
    p_serve.add_argument(
        "--replica", default=None, metavar="ID",
        help="this replica's serving identity in a fleet (also via "
        "DEPPY_GPU_REPLICA): labels the per-tenant SLO families, "
        "/debug/slo, and the request root span so burn rate is "
        "attributable per tenant per replica",
    )
    p_serve.add_argument(
        "--sched-fair", choices=["on", "off"], default=None,
        help="weighted-fair per-tenant admission + priority lanes "
        "(default on; also via DEPPY_GPU_SCHED_FAIR).  'on' sheds "
        "each tenant at its weighted share of the queue instead of "
        "the global-depth 503 — one noisy tenant can no longer "
        "starve the rest at the door; 'off' restores the global "
        "gate byte for byte",
    )
    p_serve.add_argument(
        "--sched-tenant-weights", default=None, metavar="SPEC",
        help="tenant weights/priorities for the fair gate: inline "
        "JSON, @FILE, or a path mapping tenant -> weight number or "
        "{weight, priority} ('default' covers unlisted tenants; also "
        "via DEPPY_GPU_SCHED_TENANT_WEIGHTS)",
    )
    p_serve.add_argument(
        "--obs-stream", default=None, metavar="HOST:PORT",
        help="stream this replica's telemetry sink events to the fleet "
        "router's POST /fleet/telemetry aggregator at HOST:PORT "
        "(also via DEPPY_GPU_OBS_STREAM).  Batched and "
        "bounded: a slow aggregator drops batches (counted in "
        "deppy_obs_stream_dropped_total), never stalls serving",
    )
    p_serve.add_argument(
        "--obs-flush-ms", type=float, default=None, metavar="MS",
        help="telemetry-streamer flush interval in milliseconds "
        "(default 200; also via DEPPY_GPU_OBS_FLUSH_MS)",
    )
    p_serve.add_argument(
        "--obs-baseline", default=None, metavar="FILE",
        help="arm the cost-model drift watchdog against the committed "
        "baseline artifact (a BENCH_rNN.json with a costmodel section, "
        "or a `deppy profile --json` report; also via "
        "DEPPY_GPU_OBS_BASELINE).  Live us/trip per size class outside "
        "the band emits a costmodel_drift event and the "
        "deppy_costmodel_drift_ratio gauge",
    )
    p_serve.add_argument(
        "--fleet-router", default=None, metavar="HOST:PORT",
        help="announce this replica to the fleet router at HOST:PORT "
        "(also via DEPPY_GPU_FLEET_ROUTER): POST /fleet/join "
        "once serving starts — the router streams the warm state this "
        "replica's arcs inherit, then flips the ring atomically — and "
        "leave via the drain handoff on graceful shutdown",
    )
    p_serve.add_argument(
        "--fleet-advertise", default=None, metavar="HOST:PORT",
        help="the address this replica advertises when joining a fleet "
        "(default 127.0.0.1:<api-port>; also via "
        "DEPPY_GPU_FLEET_ADVERTISE)",
    )
    p_serve.add_argument(
        "--mesh-devices", type=_mesh_devices_arg, default=None,
        metavar="N|all",
        help="shard each coalesced micro-batch across N accelerator "
        "devices ('all' = every local device; default off — "
        "single-device dispatch; also via DEPPY_GPU_MESH_DEVICES).  "
        "Each device gets its own fault domain and "
        "deppy_breaker_state{device=...} breaker",
    )
    p_serve.add_argument(
        "--opt", choices=["on", "off"], default=None,
        help="optimization tier: best-solution queries — "
        "minimal-change upgrade planning, weighted soft constraints, "
        "and explain-why-not — behind POST /v1/optimize, served by a "
        "bound-tightening loop riding the scheduler's idle-priority "
        "queue (default on; 'off' 404s the endpoint and leaves "
        "/v1/resolve byte-identical; also via DEPPY_GPU_OPT)",
    )
    p_serve.add_argument(
        "--opt-max-iterations", type=int, default=None, metavar="N",
        help="optimization tier: cap on bound-tightening probes per "
        "request — past it the best model so far returns flagged "
        "non-optimal (default 64; also via "
        "DEPPY_GPU_OPT_MAX_ITERATIONS)",
    )
    p_serve.add_argument(
        "--opt-iter-budget", type=int, default=None, metavar="STEPS",
        help="optimization tier: engine step budget per tightening "
        "probe (default 1048576; also via DEPPY_GPU_OPT_ITER_BUDGET)",
    )
    p_serve.add_argument(
        "--opt-max-weight", type=int, default=None, metavar="W",
        help="optimization tier: largest accepted soft-constraint "
        "weight — bigger weights are a 400, bounding probe work "
        "(default 64; also via DEPPY_GPU_OPT_MAX_WEIGHT)",
    )
    p_serve.add_argument(
        "--route-learn", choices=["off", "observe", "on"], default=None,
        help="route-health plane: 'observe' arms the live "
        "regret ledger, measured-defaults staleness watcher, and "
        "idle-priority shadow probing of stale classes; 'on' adds the "
        "online route registry that adopts live-learned portfolio "
        "rows (racing order only — answers stay gated by the "
        "definitive-winner rule and sampled cross-check) and gossips "
        "them fleet-wide; default off arms nothing and keeps every "
        "surface byte-identical (also via DEPPY_GPU_ROUTE_LEARN; "
        "audit with `deppy routes`)",
    )
    p_serve.add_argument(
        "--route-shadow-rate", type=float, default=None, metavar="RATE",
        help="fraction of a stale-flagged class's flushes duplicated "
        "to one non-serving backend at idle priority (deterministic "
        "1-in-N per class, default 0.0625, 0 disables probing; also "
        "via DEPPY_GPU_ROUTE_SHADOW_RATE)",
    )
    p_serve.add_argument(
        "--route-registry", default=None, metavar="FILE",
        help="persist live-learned routing rows to FILE through the "
        "shared flock-guarded measured-defaults store, provenance-"
        "stamped (also via DEPPY_GPU_ROUTE_REGISTRY; default: "
        "in-memory only)",
    )
    p_serve.add_argument(
        "--sessions", choices=["on", "off"], default=None,
        help="stateful resolution sessions: POST "
        "/v1/session pins a catalog epoch server-side, then "
        "/v1/session/{id}/op drives assume/test/untest/resolve/"
        "explain against the retained state, answered byte-"
        "identically to a one-shot cold resolve; 'off' constructs "
        "none of it — the endpoints 404 and no session metric "
        "family registers (default on with the scheduler; also via "
        "DEPPY_GPU_SESSIONS)",
    )
    p_serve.add_argument(
        "--session-lease-s", type=float, default=None, metavar="SECONDS",
        help="session lease: each op renews; a session idle past its "
        "lease is swept and ops on it answer 404 (default 300; also "
        "via DEPPY_GPU_SESSION_LEASE_S)",
    )
    p_serve.add_argument(
        "--session-max", type=int, default=None, metavar="N",
        help="hard cap on live sessions per replica — creates beyond "
        "it evict an expired session or shed with a counted 503 "
        "(default 256; also via DEPPY_GPU_SESSION_MAX)",
    )
    p_serve.add_argument(
        "--session-max-per-tenant", type=int, default=None, metavar="N",
        help="per-tenant session cap, enforced before the replica-"
        "wide one (default 64; also via "
        "DEPPY_GPU_SESSION_MAX_PER_TENANT)",
    )

    p_route = sub.add_parser(
        "route",
        help="run the replica-fleet affinity router: a "
        "front-end speaking the /v1/resolve surface that routes each "
        "problem's family onto the consistent-hash ring so churn "
        "concentrates on the replica holding its warm seeds, health-"
        "probes replicas (a dead replica's arc reassigns, in-flight "
        "requests retry once on the successor), fans catalog "
        "publishes out fleet-wide, and orchestrates warm-state drain "
        "handoffs (POST /fleet/drain)",
    )
    p_route.add_argument(
        "--bind-address", default=":8079",
        help="router listen address (default :8079)",
    )
    p_route.add_argument(
        "--replicas", default=None, metavar="HOST:PORT[,...]",
        help="replica API addresses to front, comma-separated (also "
        "via DEPPY_GPU_FLEET_REPLICAS)",
    )
    p_route.add_argument(
        "--vnodes", type=int, default=None, metavar="N",
        help="virtual nodes per replica on the hash ring (default 64; "
        "also via DEPPY_GPU_FLEET_VNODES)",
    )
    p_route.add_argument(
        "--probe-interval", type=float, default=None, metavar="SECONDS",
        help="seconds between per-replica health probes (default 2; "
        "also via DEPPY_GPU_FLEET_PROBE_INTERVAL_S)",
    )
    p_route.add_argument(
        "--probe-failures", type=int, default=None, metavar="N",
        help="consecutive transport failures that mark a replica dead "
        "and reassign its arcs (default 3; also via "
        "DEPPY_GPU_FLEET_PROBE_FAILURES)",
    )
    p_route.add_argument(
        "--policy", choices=["affinity", "roundrobin"],
        default="affinity",
        help="routing policy (default affinity; roundrobin exists as "
        "the warm-state-destroying baseline for bench.py --workload "
        "fleet)",
    )
    p_route.add_argument(
        "--membership", choices=["elastic", "static"], default=None,
        help="fleet membership mode (default elastic; also via "
        "DEPPY_GPU_FLEET).  elastic arms runtime joins (POST "
        "/fleet/join — chunked warm-state streaming, then an atomic "
        "arc flip), drain-as-leave ring removal with a membership "
        "epoch, peer gossip, and GET /fleet/policy; static restores "
        "the immutable-ring surface byte for byte",
    )
    p_route.add_argument(
        "--peers", default=None, metavar="HOST:PORT[,...]",
        help="peer router addresses for membership gossip, comma-"
        "separated (also via DEPPY_GPU_FLEET_PEERS): routers "
        "exchange epoch-versioned ring views over POST /fleet/sync so "
        "clients can hit any of them",
    )
    p_route.add_argument(
        "--telemetry-file", default=None, metavar="FILE",
        help="append router spans and fleet fault events as JSONL to "
        "FILE (also via DEPPY_GPU_TELEMETRY_FILE)",
    )
    p_route.add_argument(
        "--fault-plan", default=None, metavar="SPEC",
        help="arm the fault-injection harness for the router (the "
        "fleet.forward point; inline JSON, @FILE, or a path; also via "
        "DEPPY_GPU_FAULT_PLAN)",
    )
    p_route.add_argument(
        "--obs-sink", default=None, metavar="FILE",
        help="aggregate replica-streamed telemetry into the merged "
        "fleet JSONL sink at FILE (also via "
        "DEPPY_GPU_OBS_SINK).  Arms POST /fleet/telemetry, replica-"
        "stamps every event, and joins the router's own spans/events "
        "under replica=\"router\" — `deppy trace --fleet` reads this "
        "one file",
    )

    p_publish = sub.add_parser(
        "publish",
        help="publish a catalog delta to a running service "
        "(POST /v1/catalog/publish): the server invalidates retracted "
        "cache entries and pre-solves every affected cached family at "
        "idle priority, so dependents' re-asks become cache hits "
        "(--preview resolves the change read-only instead)",
    )
    p_publish.add_argument(
        "file",
        help="JSON publish document: {\"updates\": [{\"id\": ..., "
        "\"constraints\": [...]}], \"removed\": [...]} — constraint "
        "objects use the deppy_tpu_torch.io problem-file format",
    )
    p_publish.add_argument(
        "--server", default="http://127.0.0.1:8080", metavar="URL",
        help="base URL of the running service (default "
        "http://127.0.0.1:8080)",
    )
    p_publish.add_argument(
        "--preview", action="store_true",
        help="POST /v1/resolve/preview instead: resolve the PROPOSED "
        "change against the live index without serving or caching it "
        "(upgrade-impact preview)",
    )
    p_publish.add_argument(
        "--limit", type=int, default=None, metavar="N",
        help="with --preview: cap the affected families previewed "
        "(most recently served first; server default 32)",
    )
    p_publish.add_argument(
        "--output", choices=["text", "json"], default="text",
        help="output format (default: text)",
    )

    p_optimize = sub.add_parser(
        "optimize",
        help="POST an optimize request to a running service "
        "(POST /v1/optimize): minimal-change upgrade "
        "planning (query 'upgrade') or weighted soft constraints "
        "(query 'soft'), answered optimal/degraded/unsat by the "
        "bound-tightening loop",
    )
    p_optimize.add_argument(
        "file",
        help="JSON optimize document: {\"query\": \"upgrade\"|\"soft\", "
        "\"variables\": [...], \"installed\": [...], \"prefer\": [...], "
        "\"soft\": [{\"id\", \"installed\", \"weight\"}]} — variables "
        "use the deppy_tpu_torch.io problem-file format",
    )
    p_optimize.add_argument(
        "--server", default="http://127.0.0.1:8080", metavar="URL",
        help="base URL of the running service (default "
        "http://127.0.0.1:8080)",
    )
    p_optimize.add_argument(
        "--output", choices=["text", "json"], default="text",
        help="output format (default: text)",
    )

    p_explain = sub.add_parser(
        "explain",
        help="explain-why-not against a running service: "
        "POST /v1/optimize with query 'explain' — the named goals "
        "become mandatory and the answer is either a plan or the "
        "unsat core as a human-readable blocking set",
    )
    p_explain.add_argument(
        "file",
        help="JSON explain document: {\"variables\": [...], "
        "\"goal\": [ids...]} (a \"query\" field, if present, must be "
        "\"explain\")",
    )
    p_explain.add_argument(
        "--server", default="http://127.0.0.1:8080", metavar="URL",
        help="base URL of the running service (default "
        "http://127.0.0.1:8080)",
    )
    p_explain.add_argument(
        "--output", choices=["text", "json"], default="text",
        help="output format (default: text)",
    )

    p_stats = sub.add_parser(
        "stats",
        help="summarize a telemetry JSONL file: per-span counts/timings "
        "with p50/p95/p99 and the last solve report (see "
        "docs/observability.md)",
    )
    p_stats.add_argument(
        "file", nargs="?", default=None,
        help="telemetry JSONL file (default: $DEPPY_GPU_TELEMETRY_FILE)",
    )
    p_stats.add_argument(
        "--file", action="append", default=None, dest="files",
        metavar="FILE",
        help="additional telemetry JSONL file(s) to merge (repeatable): "
        "per-replica sinks summarize as one fleet view, "
        "with flight-recorder dump copies deduped by their per-process "
        "event seq",
    )
    p_stats.add_argument(
        "--output", choices=["text", "json"], default="text",
        help="output format (default: text)",
    )
    p_stats.add_argument(
        "--span", default=None, metavar="NAME",
        help="summarize only the named span (e.g. driver.solve)",
    )
    p_stats.add_argument(
        "--tenant", default=None, metavar="TENANT",
        help="summarize only events attributable to TENANT "
        "(X-Deppy-Tenant): spans whose attrs carry the tenant, "
        "deadline fault events, and single-tenant profile flushes "
        "(device dispatches and mixed-tenant flushes carry no tenant "
        "and are excluded)",
    )

    p_profile = sub.add_parser(
        "profile",
        help="render the engine cost model from a telemetry JSONL "
        "sink's `profile` events (armed via DEPPY_GPU_PROFILE=on): "
        "trip-overhead regression, useful-work ratio per size class, "
        "straggler/pad waste, per-backend us/solve — plus the "
        "portfolio race table (wins/cancels/win-margin per backend "
        "per size class, straggler resubmissions) from `race` events "
        "and the optimization-probe table (warm-vs-cold iterations, "
        "improvement deltas, per-probe backend wins) from "
        "`optimize` events (see docs/observability.md, Profiling)",
    )
    p_profile.add_argument(
        "file", nargs="?", default=None,
        help="telemetry JSONL file (default: $DEPPY_GPU_TELEMETRY_FILE)",
    )
    p_profile.add_argument(
        "--file", action="append", default=None, dest="files",
        metavar="FILE",
        help="additional telemetry JSONL file(s) to merge (repeatable): "
        "the cost model fits over every replica's profile "
        "events, dump copies deduped",
    )
    p_profile.add_argument(
        "--output", choices=["text", "json"], default="text",
        help="output format (default: text)",
    )

    p_routes = sub.add_parser(
        "routes",
        help="reconstruct the route-health table from a telemetry "
        "JSONL sink alone: per-size-class races, win "
        "shares, regret charged to the frozen default backend "
        "(censored-aware), staleness verdicts, shadow-probe counts, "
        "and live-learned row adoptions — the offline twin of the "
        "deppy_route_* metric families (see docs/observability.md, "
        "Route health)",
    )
    p_routes.add_argument(
        "file", nargs="?", default=None,
        help="telemetry JSONL file (default: $DEPPY_GPU_TELEMETRY_FILE)",
    )
    p_routes.add_argument(
        "--file", action="append", default=None, dest="files",
        metavar="FILE",
        help="additional telemetry JSONL file(s) to merge (repeatable): "
        "per-replica sinks reconstruct as one fleet route-health view, "
        "dump copies deduped",
    )
    p_routes.add_argument(
        "--registry", default=None, metavar="FILE",
        help="measured-defaults registry JSON to join provenance from "
        "(default: $DEPPY_GPU_MEASURED_DEFAULTS, else the package-"
        "local registry)",
    )
    p_routes.add_argument(
        "--output", choices=["text", "json"], default="text",
        help="output format (default: text)",
    )

    p_trace = sub.add_parser(
        "trace",
        help="reconstruct one request's span tree from a telemetry "
        "JSONL sink and pretty-print it (see docs/observability.md, "
        "Tracing)",
    )
    p_trace.add_argument(
        "trace_id",
        help="trace id or X-Deppy-Request-Id of the request",
    )
    p_trace.add_argument(
        "--file", action="append", default=None, metavar="FILE",
        help="telemetry JSONL file (repeatable — multiple replica "
        "sinks merge, dump copies deduped by event seq; default: "
        "$DEPPY_GPU_TELEMETRY_FILE)",
    )
    p_trace.add_argument(
        "--fleet", action="store_true",
        help="fleet mode: default the input to the merged "
        "fleet sink ($DEPPY_GPU_OBS_SINK, the router's --obs-sink "
        "file) and reconstruct the routed request as one tree — "
        "router hop + replica request + coalesced dispatch",
    )
    p_trace.add_argument(
        "--output", choices=["text", "json"], default="text",
        help="output format (default: text)",
    )

    p_top = sub.add_parser(
        "top",
        help="live terminal fleet dashboard: refreshes a "
        "per-replica table (state, warm-hit ratio, queue depth, worst "
        "cost-model drift ratio, telemetry events ingested) plus fleet "
        "rollups from the router's /fleet/metrics and /fleet/status",
    )
    p_top.add_argument(
        "--router", default="127.0.0.1:8079", metavar="HOST:PORT",
        help="fleet router address (default 127.0.0.1:8079)",
    )
    p_top.add_argument(
        "--interval", type=float, default=2.0, metavar="SECONDS",
        help="refresh interval (default 2)",
    )
    p_top.add_argument(
        "--once", action="store_true",
        help="render one snapshot and exit (no screen clearing) — the "
        "scriptable mode the obs smoke uses",
    )

    sub.add_parser(
        "lint",
        help="run the static-analysis checkers and fail on findings not "
        "in the baseline (waits for ROADMAP A7.2c)",
    )
    sub.add_parser(
        "compiles",
        help="summarize compile-guard trace/retrace counts per entry "
        "from a telemetry JSONL sink, or print the static compile-"
        "surface registry with --surface (waits for ROADMAP A7.2c)",
    )

    p_fleet = sub.add_parser(
        "fleet",
        help="elastic fleet operations against a running router: "
        "print the SLO-burn autoscale recommendation "
        "(GET /fleet/policy), and optionally apply it in local-process "
        "mode — execution stays operator-driven",
    )
    fleet_sub = p_fleet.add_subparsers(dest="fleet_command")
    p_fpolicy = fleet_sub.add_parser(
        "policy",
        help="print the router's current autoscale recommendation "
        "(scale_up / scale_down / rebalance / hold) as JSON",
    )
    p_fscale = fleet_sub.add_parser(
        "scale",
        help="fetch the recommendation; with --apply, execute it "
        "locally: scale_up spawns a `deppy serve --fleet-router` "
        "replica on a free port (it joins via the warm-state stream + "
        "arc flip), scale_down/rebalance drains the suggested replica",
    )
    for p_f in (p_fpolicy, p_fscale):
        p_f.add_argument(
            "--router", default="127.0.0.1:8079", metavar="HOST:PORT",
            help="fleet router address (default 127.0.0.1:8079)",
        )
    p_fscale.add_argument(
        "--apply", action="store_true",
        help="execute the recommendation in local-process mode (the "
        "bench/soak harness); without it the recommendation is only "
        "printed",
    )
    p_fscale.add_argument(
        "--backend", choices=["auto", "host", "device"], default="device",
        help="backend for a replica spawned by scale_up (default device)",
    )
    _add_device(p_fscale, "a replica spawned by scale_up solves on")

    sub.add_parser(
        "doctor",
        help="diagnose the accelerator backend (waits for ROADMAP A7.2c)",
    )
    return parser


# ResolverConfig file keys → serve() kwargs (config/manager/
# resolver_config.yaml; ``deppy_tpu/cli.py:856``).  Parsed as YAML when
# available, JSON otherwise (the shipped config is valid YAML; JSON
# configs work without pyyaml).
_CONFIG_KEYS = {
    "bindAddress": ("bind_address", str),
    "healthProbeBindAddress": ("probe_address", str),
    "backend": ("backend", str),
    "maxSteps": ("max_steps", int),
    "requestDeadlineSeconds": ("request_deadline_s", float),
    "sched": ("sched", str),
    "schedMaxWaitMs": ("sched_max_wait_ms", float),
    "schedMaxFill": ("sched_max_fill", int),
    "cacheSize": ("cache_size", int),
    "hostWorkers": ("host_workers", int),
    "meshDevices": ("mesh_devices", int),
    "incremental": ("incremental", str),
    "incrementalMaxDelta": ("incremental_max_delta", float),
    "incrementalIndexSize": ("incremental_index_size", int),
    "slo": ("slo", str),
    "portfolio": ("portfolio", str),
    "speculate": ("speculate", str),
    "speculateMaxBacklog": ("speculate_max_backlog", int),
    "profile": ("profile", str),
    "profileSample": ("profile_sample", float),
    "bcp": ("bcp", str),
    "replica": ("replica", str),
    "schedFair": ("fair", str),
    "schedTenantWeights": ("tenant_weights", str),
    "obsStream": ("obs_stream", str),
    "obsFlushMs": ("obs_flush_ms", float),
    "obsBaseline": ("obs_baseline", str),
    "fleetRouter": ("fleet_router", str),
    "fleetAdvertise": ("fleet_advertise", str),
    "opt": ("opt", str),
    "optMaxIterations": ("opt_max_iterations", int),
    "optIterBudget": ("opt_iter_budget", int),
    "optMaxWeight": ("opt_max_weight", int),
    "routeLearn": ("route_learn", str),
    "routeShadowRate": ("route_shadow_rate", float),
    "routeRegistry": ("route_registry", str),
    "sessions": ("sessions", str),
    "sessionLeaseS": ("session_lease_s", float),
    "sessionMax": ("session_max", int),
    "sessionMaxPerTenant": ("session_max_per_tenant", int),
}


def _load_serve_config(path: str) -> dict:
    """The ``serve()`` kwargs a ResolverConfig file sets
    (``deppy_tpu/cli.py:900``)."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml

        try:
            doc = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise problem_io.ProblemFormatError(
                f"config file {path}: invalid YAML: {e}"
            ) from e
    except ImportError:
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise problem_io.ProblemFormatError(
                f"config file {path}: invalid JSON: {e}"
            ) from e
    if not isinstance(doc, dict):
        raise problem_io.ProblemFormatError(
            f"config file {path}: expected a mapping, got {type(doc).__name__}"
        )
    out = {}
    for key, (kwarg, cast) in _CONFIG_KEYS.items():
        if key in doc and doc[key] is not None:
            out[kwarg] = cast(doc[key])
    return out


def _arm_fault_plan(spec) -> int:
    """Install a --fault-plan spec; returns 0 or a usage-error code
    (``deppy_tpu/cli.py:930``).  Rules naming no registered fault point
    warn (registry-sync): an operator chaos plan against a renamed point
    must not report green while injecting nothing."""
    if not spec:
        return 0
    from . import faults
    from .faults.inject import _warn_unmatched

    try:
        plan = faults.plan_from_spec(spec)
    except (OSError, ValueError) as e:
        print(f"error: invalid fault plan: {e}", file=sys.stderr)
        return 2
    _warn_unmatched(plan)
    faults.configure_plan(plan)
    return 0


def _cmd_resolve(args) -> int:
    """Resolve a problem file and print each answer
    (``deppy_tpu/cli.py:950-1010``), on ``--device``.  A card asked for
    on a machine without one (``driver.NoDeviceError``) is a usage
    error, printed before any answer."""
    if args.telemetry_file:
        from .telemetry import configure_sink

        configure_sink(args.telemetry_file)
    if _arm_fault_plan(args.fault_plan):
        return 2
    if args.host_workers is not None:
        from . import hostpool

        hostpool.configure_pool(args.host_workers)
    try:
        problems, is_batch = problem_io.load_document(args.file)
    except FileNotFoundError:
        print(f"error: no such file: {args.file}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read {args.file}: {e}", file=sys.stderr)
        return 2
    except problem_io.ProblemFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from .engine.driver import NoDeviceError
    from .resolution.facade import BatchResolver

    resolver = BatchResolver(
        backend=args.backend, device=args.device, max_steps=args.max_steps,
        checkpoint_dir=args.checkpoint_dir, deadline_s=args.deadline,
    )
    try:
        results = resolver.solve(problems)
    except (BackendCapabilityError, DuplicateIdentifier,
            InternalSolverError, NoDeviceError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.report and resolver.last_report is not None:
        print(resolver.last_report.format_table(), file=sys.stderr)

    rendered = [problem_io.result_to_dict(res) for res in results]
    statuses = {r["status"] for r in rendered}
    rc = 3 if "incomplete" in statuses else (1 if "unsat" in statuses else 0)

    if args.output == "json":
        # Output shape is a function of the *input* form: a batch document
        # always yields {"results": [...]}, a single problem a bare object.
        doc = {"results": rendered} if is_batch else rendered[0]
        json.dump(doc, sys.stdout, indent=2)
        print()
        return rc

    for i, r in enumerate(rendered):
        prefix = f"problem {i}: " if is_batch else ""
        if r["status"] == "sat":
            sel = ", ".join(r["selected"]) if r["selected"] else "(nothing)"
            print(f"{prefix}resolution set: {sel}")
        elif r["status"] == "unsat":
            print(f"{prefix}constraints not satisfiable: "
                  + ", ".join(r["conflicts"]))
        else:
            print(f"{prefix}resolution incomplete: {r['error']}")
    return rc


def _cmd_route(args) -> int:
    """Run the replica-fleet affinity router
    (``deppy_tpu/cli.py:1013``)."""
    if args.telemetry_file:
        from .telemetry import configure_sink

        configure_sink(args.telemetry_file)
    if _arm_fault_plan(args.fault_plan):
        return 2
    from .fleet.router import serve_router

    try:
        serve_router(bind_address=args.bind_address,
                     replicas=args.replicas,
                     vnodes=args.vnodes,
                     probe_interval_s=args.probe_interval,
                     probe_failures=args.probe_failures,
                     policy=args.policy,
                     obs_sink=args.obs_sink,
                     membership=args.membership,
                     peers=args.peers)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _cmd_fleet(args) -> int:
    """Elastic fleet operations (``deppy_tpu/cli.py:1039``): `deppy fleet
    policy` prints the router's autoscale recommendation; `deppy fleet
    scale --apply` executes it in local-process mode — scale_up spawns a
    joining port replica on ``--device``, scale_down/rebalance drains the
    suggested victim.  Exit 0 on success, 1 on a router-side error, 2 on
    usage/transport errors."""
    from http.client import HTTPConnection

    if not getattr(args, "fleet_command", None):
        print("error: fleet requires a subcommand (policy, scale)",
              file=sys.stderr)
        return 2
    host, _, port = args.router.rpartition(":")
    try:
        port_n = int(port)
    except ValueError:
        print(f"error: invalid --router address {args.router!r} "
              "(want HOST:PORT)", file=sys.stderr)
        return 2
    host = host or "127.0.0.1"

    def _exchange(method: str, path: str, doc=None, timeout=120.0):
        conn = HTTPConnection(host, port_n, timeout=timeout)
        try:
            conn.request(
                method, path,
                body=json.dumps(doc).encode() if doc is not None
                else None,
                headers={"Content-Type": "application/json"}
                if doc is not None else {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    try:
        status, body = _exchange("GET", "/fleet/policy")
    except OSError as e:
        print(f"error: router {args.router} unreachable: {e}",
              file=sys.stderr)
        return 2
    if status != 200:
        print(f"error: GET /fleet/policy -> HTTP {status}: "
              f"{body[:200].decode('utf-8', 'replace')}",
              file=sys.stderr)
        return 1
    policy = json.loads(body).get("policy") or {}
    print(json.dumps(policy, indent=2))
    if args.fleet_command == "policy" or not args.apply:
        return 0
    decision = policy.get("decision")
    if decision == "hold":
        print("fleet scale: hold — nothing to apply")
        return 0
    if decision == "scale_up":
        import socket
        import subprocess

        ports = []
        for _ in range(2):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
            s.close()
        addr = f"127.0.0.1:{ports[0]}"
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from deppy_tpu_torch.cli import main; "
             "sys.exit(main())",
             "serve", "--bind-address", addr,
             "--health-probe-bind-address", f"127.0.0.1:{ports[1]}",
             "--backend", args.backend, "--device", args.device,
             "--replica", f"scale{ports[0]}",
             "--fleet-router", args.router,
             "--fleet-advertise", addr],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        print(f"fleet scale: spawned replica {addr} (pid {proc.pid}); "
              "it joins the ring once its warm-state stream lands")
        return 0
    target = policy.get("target")
    if not target:
        print("fleet scale: recommendation names no target replica; "
              "nothing to apply")
        return 0
    try:
        status, body = _exchange("POST", "/fleet/drain",
                                 {"replica": target})
    except OSError as e:
        print(f"error: drain of {target} failed: {e}", file=sys.stderr)
        return 1
    if status != 200:
        print(f"error: POST /fleet/drain -> HTTP {status}: "
              f"{body[:200].decode('utf-8', 'replace')}",
              file=sys.stderr)
        return 1
    out = json.loads(body).get("drain") or {}
    print(f"fleet scale: drained {target} ({decision}); handed off "
          f"{out.get('handed_off', 0)} warm entries to "
          f"{sorted(out.get('recipients') or {})}")
    return 0


def _cmd_publish(args) -> int:
    """POST a catalog publish document to a running service — the
    subscribe-side CLI of the speculative tier
    (``deppy_tpu/cli.py:1142``).  With
    ``--preview`` the change resolves read-only instead (the what-if
    endpoint); exit 0 on a 2xx response, 2 on usage/transport errors,
    1 on any other HTTP status."""
    from http.client import HTTPConnection, HTTPSConnection
    from urllib.parse import urlsplit

    try:
        with open(args.file, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        print(f"error: no such file: {args.file}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read {args.file}: {e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: invalid JSON in {args.file}: {e}", file=sys.stderr)
        return 2
    if args.preview and args.limit is not None:
        if not isinstance(doc, dict):
            print("error: publish document must be a JSON object",
                  file=sys.stderr)
            return 2
        doc = dict(doc)
        doc["limit"] = args.limit
    parts = urlsplit(args.server if "://" in args.server
                     else f"http://{args.server}")
    if parts.scheme not in ("http", "https"):
        print(f"error: unsupported --server scheme {parts.scheme!r} "
              "(use http:// or https://)", file=sys.stderr)
        return 2
    path = "/v1/resolve/preview" if args.preview else "/v1/catalog/publish"
    conn_cls = HTTPSConnection if parts.scheme == "https" \
        else HTTPConnection
    default_port = 443 if parts.scheme == "https" else 8080
    try:
        conn = conn_cls(parts.hostname or "127.0.0.1",
                        parts.port or default_port, timeout=60)
        conn.request("POST", path, body=json.dumps(doc),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        status = resp.status
        conn.close()
    except OSError as e:
        print(f"error: cannot reach {args.server}: {e}", file=sys.stderr)
        return 2
    try:
        payload = json.loads(body)
    except (ValueError, json.JSONDecodeError):
        payload = {"raw": body.decode(errors="replace")}
    if args.output == "json" or status >= 400:
        json.dump(payload, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0 if status < 300 else (2 if status == 404 else 1)
    if args.preview:
        entries = payload.get("preview", [])
        print(f"preview: {len(entries)} affected famil"
              f"{'y' if len(entries) == 1 else 'ies'}")
        for e in entries:
            r = e.get("result") or {}
            status_s = r.get("status", e.get("error", "?"))
            detail = ""
            if status_s == "sat":
                sel = r.get("selected") or []
                detail = f"  selected: {', '.join(sel) or '(nothing)'}"
            elif status_s == "unsat":
                detail = f"  conflicts: {', '.join(r.get('conflicts', []))}"
            print(f"  {e.get('fingerprint', '?')[:12]}  "
                  f"[{e.get('delta_class') or 'cold'}]  {status_s}{detail}")
    else:
        p = payload.get("publish", {})
        print("published: "
              + "  ".join(f"{k}={p.get(k)}"
                          for k in ("changed", "affected", "invalidated",
                                    "queued", "dropped", "unchanged")))
    return 0


def _cmd_optimize(args, explain: bool = False) -> int:
    """POST an optimize document to a running service (POST
    /v1/optimize; ``deppy_tpu/cli.py:1224``).  ``explain=True`` is the
    `deppy explain` spelling: the query field is forced to "explain" (a document that
    names a DIFFERENT query is a usage error, not silently rewritten).
    Exit 0 on a 2xx response, 2 on usage/transport errors (a 404 means
    the tier is off — DEPPY_GPU_OPT=off — or the server predates it),
    1 on any other HTTP status."""
    from http.client import HTTPConnection, HTTPSConnection
    from urllib.parse import urlsplit

    try:
        with open(args.file, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        print(f"error: no such file: {args.file}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read {args.file}: {e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: invalid JSON in {args.file}: {e}", file=sys.stderr)
        return 2
    if explain:
        if not isinstance(doc, dict):
            print("error: explain document must be a JSON object",
                  file=sys.stderr)
            return 2
        if doc.get("query", "explain") != "explain":
            print(f"error: `deppy explain` requires query \"explain\", "
                  f"the document says {doc['query']!r} — use "
                  "`deppy optimize`", file=sys.stderr)
            return 2
        doc = dict(doc)
        doc["query"] = "explain"
    parts = urlsplit(args.server if "://" in args.server
                     else f"http://{args.server}")
    if parts.scheme not in ("http", "https"):
        print(f"error: unsupported --server scheme {parts.scheme!r} "
              "(use http:// or https://)", file=sys.stderr)
        return 2
    conn_cls = HTTPSConnection if parts.scheme == "https" \
        else HTTPConnection
    default_port = 443 if parts.scheme == "https" else 8080
    try:
        conn = conn_cls(parts.hostname or "127.0.0.1",
                        parts.port or default_port, timeout=60)
        conn.request("POST", "/v1/optimize", body=json.dumps(doc),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        status = resp.status
        conn.close()
    except OSError as e:
        print(f"error: cannot reach {args.server}: {e}", file=sys.stderr)
        return 2
    try:
        payload = json.loads(body)
    except (ValueError, json.JSONDecodeError):
        payload = {"raw": body.decode(errors="replace")}
    if args.output == "json" or status >= 400:
        json.dump(payload, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0 if status < 300 else (2 if status == 404 else 1)
    out = payload.get("optimize", {})
    if out.get("query") == "explain":
        if out.get("status") == "feasible":
            plan = out.get("plan") or []
            print(f"feasible: {', '.join(plan) or '(nothing)'}")
        elif out.get("status") == "blocked":
            print("blocked:")
            for line in out.get("blocking", []):
                print(f"  {line}")
        else:
            print(f"degraded: {out.get('reason')}")
    else:
        head = out.get("status", "?")
        if head == "degraded":
            head += f" ({out.get('reason')})"
        elif out.get("proof"):
            head += f" (proof: {out['proof']})"
        print(f"{head}: objective={out.get('objective')} "
              f"iterations={out.get('iterations')} "
              f"improvements={out.get('improvements')}")
        if out.get("status") == "unsat":
            for line in out.get("blocking", []):
                print(f"  {line}")
        else:
            sel = out.get("selected") or []
            print(f"  selected: {', '.join(sel) or '(nothing)'}")
            if out.get("query") == "upgrade":
                print(f"  touched={out.get('touched')} "
                      f"missing_prefer="
                      f"{', '.join(out.get('missing_prefer') or []) or '-'}")
    return 0


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over pre-sorted values (0 on empty) —
    the shared telemetry statistic (``deppy_tpu/cli.py:1332``)."""
    from .telemetry import percentile

    return percentile(sorted_vals, q)


def _iter_sink_events(path: str):
    """Yield one item per non-empty sink line: the parsed event dict, or
    None for a malformed line (callers count those;
    ``deppy_tpu/cli.py:1341``)."""
    from .telemetry import iter_sink_events

    return iter_sink_events(path)


def _sink_paths(args) -> List[str]:
    """Effective sink path list for stats/profile: the positional file
    plus any repeated ``--file``, falling back to
    $DEPPY_GPU_TELEMETRY_FILE when neither was given
    (``deppy_tpu/cli.py:1351``)."""
    from . import config

    paths = ([args.file] if args.file else []) \
        + list(getattr(args, "files", None) or [])
    if not paths:
        default = config.env_raw("DEPPY_GPU_TELEMETRY_FILE")
        if default:
            paths = [default]
    return paths


def _iter_paths_events(paths: List[str]):
    """One path reads verbatim (byte-identical single-sink behavior);
    several merge with cross-replica dedupe (``deppy_tpu/cli.py:1366``)."""
    if len(paths) == 1:
        return _iter_sink_events(paths[0])
    from .telemetry import iter_merged_sink_events

    return iter_merged_sink_events(paths)


def _cmd_stats(args) -> int:
    """Summarize a telemetry JSONL file (the sink written under
    ``--telemetry-file`` / ``DEPPY_GPU_TELEMETRY_FILE``): per-span
    count/total/mean/p50/p95/p99 wall clock, event totals, and the last
    recorded solve report — the same report `deppy resolve --report`
    and the bench harness print.  ``--span NAME`` narrows the summary
    to one span family.  Repeated ``--file`` merges several replica
    sinks into one fleet summary (``deppy_tpu/cli.py:1376``)."""
    paths = _sink_paths(args)
    if not paths:
        print("error: no telemetry file (pass FILE or set "
              "DEPPY_GPU_TELEMETRY_FILE)", file=sys.stderr)
        return 2
    path = ", ".join(paths)
    spans: dict = {}
    last_report = None
    n_events = 0
    n_bad = 0
    kinds: dict = {}
    # Trip-ledger tally: `profile` events summarize inline
    # alongside the kind=n line; the full cost model is `deppy profile`.
    prof = {"events": 0, "trips": 0, "lane_steps": 0,
            "_useful": 0.0, "_useful_n": 0}
    try:
        for ev in _iter_paths_events(paths):
            if ev is None:
                n_bad += 1
                continue
            if args.tenant is not None:
                # --tenant: keep only events attributable to the tenant
                # — spans carrying it in attrs (the service.request
                # root), and fault/profile events stamped with it.
                if (ev.get("tenant") != args.tenant
                        and (ev.get("attrs") or {}).get("tenant")
                        != args.tenant):
                    continue
            n_events += 1
            if ev.get("kind") == "profile":
                prof["events"] += 1
                prof["trips"] += int(ev.get("trips", 0) or 0)
                prof["lane_steps"] += int(ev.get("lane_steps", 0) or 0)
                if ev.get("useful_work_ratio") is not None:
                    try:
                        prof["_useful"] += float(ev["useful_work_ratio"])
                        prof["_useful_n"] += 1
                    except (TypeError, ValueError):
                        pass
            kind = ev.get("kind", "?")
            kinds[kind] = kinds.get(kind, 0) + 1
            if ev.get("kind") == "span":
                name = ev.get("name", "?")
                if args.span is not None and name != args.span:
                    # Filter in the read loop: a --span run over a
                    # long-lived sink must not buffer every family's
                    # durations just to discard them afterwards.
                    continue
                agg = spans.setdefault(
                    name,
                    {"count": 0, "total_s": 0.0, "durs": []},
                )
                agg["count"] += 1
                try:
                    dur = float(ev.get("dur_s", 0.0))
                except (TypeError, ValueError):
                    continue
                agg["total_s"] += dur
                agg["durs"].append(dur)
            elif ev.get("kind") == "report":
                if isinstance(ev.get("report"), dict):
                    last_report = ev["report"]
    except FileNotFoundError:
        print(f"error: no such file: {path}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return 2

    for agg in spans.values():
        agg["mean_s"] = agg["total_s"] / agg["count"] if agg["count"] else 0.0
        durs = sorted(agg.pop("durs"))
        for q in (50, 95, 99):
            agg[f"p{q}_s"] = _percentile(durs, q)

    useful_n = prof.pop("_useful_n")
    useful_sum = prof.pop("_useful")
    prof["mean_useful_work_ratio"] = (
        round(useful_sum / useful_n, 4) if useful_n else None)

    if args.output == "json":
        json.dump({"events": n_events, "malformed_lines": n_bad,
                   "event_kinds": kinds,
                   "tenant": args.tenant,
                   "profile": (prof if prof["events"] else None),
                   "spans": spans,
                   # --span narrows to one span family in BOTH formats.
                   "last_report": (last_report if args.span is None
                                   else None)},
                  sys.stdout, indent=2, sort_keys=True)
        print()
        return 0

    print(f"telemetry: {n_events} events from {path}"
          + (f" (tenant {args.tenant})" if args.tenant else "")
          + (f" ({n_bad} malformed lines skipped)" if n_bad else ""))
    # Non-span kinds get a one-line tally so fault/breaker/lockdep
    # events are visible from `deppy stats` without a trace id in hand.
    other = {k: n for k, n in sorted(kinds.items())
             if k not in ("span", "report")}
    if other and args.span is None:
        print("events: " + "  ".join(f"{k}={n}"
                                     for k, n in other.items()))
    if prof["events"] and args.span is None:
        useful = prof["mean_useful_work_ratio"]
        print(f"profile: {prof['events']} events  "
              f"trips={prof['trips']}  lane_steps={prof['lane_steps']}"
              + (f"  useful={useful:.3f}" if useful is not None else "")
              + "  (full cost model: `deppy profile`)")
    if spans:
        width = max(len(n) for n in spans)
        print(f"{'span'.ljust(width)}  {'count':>7}  {'total_s':>9}  "
              f"{'mean_ms':>8}  {'p50_ms':>8}  {'p95_ms':>8}  "
              f"{'p99_ms':>8}")
        for name in sorted(spans):
            agg = spans[name]
            print(f"{name.ljust(width)}  {agg['count']:>7}  "
                  f"{agg['total_s']:>9.3f}  {agg['mean_s'] * 1e3:>8.2f}  "
                  f"{agg['p50_s'] * 1e3:>8.2f}  "
                  f"{agg['p95_s'] * 1e3:>8.2f}  "
                  f"{agg['p99_s'] * 1e3:>8.2f}")
    elif args.span is not None:
        print(f"no span events named {args.span!r}")
    else:
        print("no span events recorded")
    if last_report is not None and args.span is None:
        from .telemetry import SolveReport

        print()
        # One canonical renderer: the same table `deppy resolve
        # --report` and the bench harness print.
        print("last " + SolveReport.from_dict(last_report).format_table())
    return 0


def _cmd_trace(args) -> int:
    """Reconstruct one request's span tree from a telemetry JSONL sink
    (span/fault/breaker events stamped with trace ids, plus flight-
    recorder ``trace`` dumps) and pretty-print it — including dispatch
    traces grafted via their span links, so a request served by a
    coalesced dispatch shows queue-wait → dispatch (with retry/fallback
    events) → decode as one tree.  ``--fleet`` reads the merged fleet
    sink instead, so a routed request reconstructs router hop →
    replica request → dispatch from one file; repeated ``--file``
    merges several replica sinks with dump copies deduped
    (``deppy_tpu/cli.py:1519``)."""
    from . import config

    paths = list(args.file or [])
    if not paths:
        default = config.env_raw("DEPPY_GPU_OBS_SINK") if args.fleet \
            else config.env_raw("DEPPY_GPU_TELEMETRY_FILE")
        if default:
            paths = [default]
    if not paths:
        print("error: no telemetry file (pass --file or set "
              + ("DEPPY_GPU_OBS_SINK" if args.fleet
                 else "DEPPY_GPU_TELEMETRY_FILE") + ")", file=sys.stderr)
        return 2
    path = ", ".join(paths)

    # (trace_id, span_id) -> span event; trace_id -> [events]; the
    # request-id alias map comes from flight-recorder dumps.
    spans: dict = {}
    events_by_trace: dict = {}
    request_alias: dict = {}
    seen_events: set = set()

    def _take_span(ev):
        tid, sid = ev.get("trace_id"), ev.get("span_id")
        if tid and sid:
            spans[(tid, sid)] = ev
            # Root spans carry the request id in their attrs, so a
            # client-chosen X-Deppy-Request-Id resolves from live sink
            # lines alone (not just flight-recorder dumps).
            rid = (ev.get("attrs") or {}).get("request_id")
            if rid:
                request_alias.setdefault(rid, tid)

    def _take_event(ev):
        tid = ev.get("trace_id")
        if not tid:
            return
        # The same fault/breaker event reaches the sink twice when a
        # flight-recorder dump follows the live stamped line (and once
        # more per additional dump).  Stamped events carry a per-process
        # `seq` exactly so dump copies dedupe without collapsing
        # genuinely distinct identical-field events; pre-seq sink lines
        # fall back to the full canonical form.  seq counters are
        # per-process, so in a merged fleet sink the key needs the
        # aggregator's replica stamp too (absent = None on local sinks,
        # preserving single-sink behavior).
        seq = ev.get("seq")
        key = (ev.get("replica"), tid, seq) if seq is not None \
            else json.dumps(ev, sort_keys=True, default=str)
        if key in seen_events:
            return
        seen_events.add(key)
        events_by_trace.setdefault(tid, []).append(ev)

    try:
        for ev in _iter_paths_events(paths):
            if ev is None:
                continue
            kind = ev.get("kind")
            if kind == "span":
                _take_span(ev)
            elif kind == "trace" and isinstance(ev.get("trace"), dict):
                trace = ev["trace"]
                if trace.get("request_id") and trace.get("trace_id"):
                    request_alias[trace["request_id"]] = trace["trace_id"]
                for sp in trace.get("spans", []):
                    _take_span(sp)
                for fe in trace.get("events", []):
                    _take_event(fe)
            elif kind in ("fault", "breaker", "lockdep", "profile"):
                # `profile` events are stamped like fault
                # events when a dispatch trace was active — the span
                # tree then shows the trip ledger of the dispatch that
                # served the request.
                _take_event(ev)
    except FileNotFoundError:
        print(f"error: no such file: {path}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return 2

    target = request_alias.get(args.trace_id, args.trace_id)
    # Pull in traces that LINK into the target (coalesced dispatches):
    # their root spans display under the linked request span.
    included = {target}
    graft = {}  # trace_id -> parent span_id to graft its roots under
    changed = True
    while changed:
        changed = False
        for (tid, sid), sp in spans.items():
            if tid in included:
                continue
            for link in sp.get("links") or []:
                if link.get("trace_id") in included:
                    included.add(tid)
                    graft[tid] = link.get("span_id")
                    changed = True
                    break

    chosen = [sp for (tid, _), sp in spans.items() if tid in included]
    if not chosen:
        print(f"error: no spans for trace {args.trace_id!r} in {path}",
              file=sys.stderr)
        return 2
    chosen.sort(key=lambda sp: sp.get("ts", 0.0))
    fault_events = [e for tid in included
                    for e in events_by_trace.get(tid, [])]

    if args.output == "json":
        json.dump({"trace_id": target, "spans": chosen,
                   "events": fault_events}, sys.stdout, indent=2,
                  default=str)
        print()
        return 0

    by_id = {sp["span_id"]: sp for sp in chosen}
    children: dict = {}
    roots = []
    for sp in chosen:
        parent = sp.get("parent_id")
        if sp["trace_id"] in graft and parent not in by_id:
            parent = graft[sp["trace_id"]]  # dispatch root → link target
        if parent in by_id:
            children.setdefault(parent, []).append(sp)
        else:
            roots.append(sp)
    notes: dict = {}
    for e in fault_events:
        notes.setdefault(e.get("parent_id"), []).append(e)

    def _fmt_span(sp):
        attrs = {k: v for k, v in (sp.get("attrs") or {}).items()}
        extra = ""
        if sp.get("links"):
            extra += "  links=" + ",".join(
                link.get("trace_id", "?")[:8] for link in sp["links"])
        if attrs:
            extra += "  " + " ".join(f"{k}={v}"
                                     for k, v in sorted(attrs.items()))
        return (f"{sp.get('name', '?')}  "
                f"{float(sp.get('dur_s', 0.0)) * 1e3:.2f}ms  "
                f"[{sp.get('span_id', '?')[:8]}]{extra}")

    def _fmt_event(e):
        detail = " ".join(
            f"{k}={v}" for k, v in sorted(e.items())
            if k not in ("ts", "kind", "trace_id", "parent_id"))
        return f"({e.get('kind')}) {detail}"

    def _walk(sp, prefix, is_last):
        branch = "└─ " if is_last else "├─ "
        print(prefix + branch + _fmt_span(sp))
        child_prefix = prefix + ("   " if is_last else "│  ")
        kids = children.get(sp["span_id"], [])
        tail = notes.get(sp["span_id"], [])
        items = [("span", k) for k in kids] + [("event", e) for e in tail]
        for i, (kind, item) in enumerate(items):
            last = i == len(items) - 1
            if kind == "span":
                _walk(item, child_prefix, last)
            else:
                print(child_prefix + ("└─ " if last else "├─ ")
                      + _fmt_event(item))

    print(f"trace {target}"
          + (f" (request {args.trace_id})"
             if args.trace_id != target else ""))
    for i, root in enumerate(roots):
        _walk(root, "", i == len(roots) - 1)
    # Events whose parent span never completed (process died mid-span,
    # or stamped with no open span) must not vanish from the text view
    # — the JSON view includes them, and an incident reconstruction is
    # exactly when they matter.
    orphans = [e for pid, evs in notes.items() if pid not in by_id
               for e in evs]
    if orphans:
        print("unattached events:")
        for i, e in enumerate(orphans):
            print(("└─ " if i == len(orphans) - 1 else "├─ ")
                  + _fmt_event(e))
    return 0


def _cmd_profile(args) -> int:
    """Render the engine cost model from a sink's ``profile`` events
    (``deppy_tpu/cli.py:1714``): trip-overhead regression, useful-work
    ratio per size class, straggler/pad waste breakdowns, per-backend µs/solve — the
    continuously-collected version of the hand-run A/B trip-overhead
    model (see docs/observability.md, Profiling).  Repeated ``--file``
    fits the model over several replica sinks merged."""
    from .profile import report as profile_report

    paths = _sink_paths(args)
    if not paths:
        print("error: no telemetry file (pass FILE or set "
              "DEPPY_GPU_TELEMETRY_FILE)", file=sys.stderr)
        return 2
    path = ", ".join(paths)
    try:
        summary = profile_report.summarize(
            paths[0] if len(paths) == 1 else paths)
    except FileNotFoundError:
        print(f"error: no such file: {path}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return 2
    if args.output == "json":
        json.dump(summary, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    if not summary["profile_events"] and not summary.get("races"):
        print(f"no profile or race events in {path} (arm with "
              f"DEPPY_GPU_PROFILE=on and a telemetry sink; race events "
              f"ride every portfolio race)")
        return 0
    print(profile_report.render_text(summary, path))
    return 0


def _cmd_routes(args) -> int:
    """Reconstruct the route-health table from the JSONL sink alone
    (``deppy_tpu/cli.py:1751``): the same :class:`RegretLedger` the live
    plane drives, replayed offline over ``race``/``route``/``route_stale``/
    ``route_learned`` events, joined with the measured-defaults
    registry's provenance stamps.  Repeated ``--file`` merges replica
    sinks into one fleet view."""
    from .engine import defaults
    from .routes import report as routes_report

    paths = _sink_paths(args)
    if not paths:
        print("error: no telemetry file (pass FILE or set "
              "DEPPY_GPU_TELEMETRY_FILE)", file=sys.stderr)
        return 2
    rows_doc = defaults.read_rows(args.registry)
    try:
        doc = routes_report.build_report(_iter_paths_events(paths),
                                         rows_doc=rows_doc)
    except FileNotFoundError:
        print(f"error: no such file: {', '.join(paths)}",
              file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot read {', '.join(paths)}: {e}",
              file=sys.stderr)
        return 2
    if args.output == "json":
        json.dump(doc, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    print(routes_report.render_text(doc))
    return 0


def _cmd_serve(args) -> int:
    """Run the service (``deppy_tpu/cli.py:1880-2013``) on ``--device``:
    built-in defaults < ``--config`` < explicit flags.  A backend other
    than ``auto``, ``host`` or ``device``, from the config file too, or a
    card asked for on a machine without one, is a usage error."""
    from .engine.driver import NoDeviceError
    from .service import serve

    if args.telemetry_file:
        from .telemetry import configure_sink

        configure_sink(args.telemetry_file)
    if _arm_fault_plan(args.fault_plan):
        return 2

    # Precedence: built-in defaults < --config file < explicit flags
    # (the reference's flag-vs-ControllerManagerConfig behavior).  Flags
    # default to None, so a non-None parsed value IS an explicit flag.
    kwargs = {
        "bind_address": ":8080",
        "probe_address": ":8081",
        "backend": "device",
        "max_steps": None,
        "request_deadline_s": None,
        "sched": None,
        "sched_max_wait_ms": None,
        "sched_max_fill": None,
        "cache_size": None,
        "host_workers": None,
        "mesh_devices": None,
        "incremental": None,
        "incremental_max_delta": None,
        "incremental_index_size": None,
        "slo": None,
        "portfolio": None,
        "speculate": None,
        "speculate_max_backlog": None,
        "profile": None,
        "profile_sample": None,
        "bcp": None,
        "replica": None,
        "fair": None,
        "tenant_weights": None,
        "obs_stream": None,
        "obs_flush_ms": None,
        "obs_baseline": None,
        "fleet_router": None,
        "fleet_advertise": None,
        "opt": None,
        "opt_max_iterations": None,
        "opt_iter_budget": None,
        "opt_max_weight": None,
        "route_learn": None,
        "route_shadow_rate": None,
        "route_registry": None,
        "sessions": None,
        "session_lease_s": None,
        "session_max": None,
        "session_max_per_tenant": None,
        "device": args.device,
    }
    try:
        if args.config:
            kwargs.update(_load_serve_config(args.config))
        for key, val in (
            ("bind_address", args.bind_address),
            ("probe_address", args.health_probe_bind_address),
            ("backend", args.backend),
            ("max_steps", args.max_steps),
            ("request_deadline_s", args.request_deadline),
            ("sched", args.sched),
            ("sched_max_wait_ms", args.sched_max_wait_ms),
            ("sched_max_fill", args.sched_max_fill),
            ("cache_size", args.cache_size),
            ("host_workers", args.host_workers),
            ("mesh_devices", args.mesh_devices),
            ("incremental", args.incremental),
            ("incremental_max_delta", args.incremental_max_delta),
            ("incremental_index_size", args.incremental_index_size),
            ("slo", args.slo),
            ("portfolio", args.portfolio),
            ("speculate", args.speculate),
            ("speculate_max_backlog", args.speculate_max_backlog),
            ("profile", args.profile),
            ("profile_sample", args.profile_sample),
            ("bcp", args.bcp),
            ("replica", args.replica),
            ("fair", args.sched_fair),
            ("tenant_weights", args.sched_tenant_weights),
            ("obs_stream", args.obs_stream),
            ("obs_flush_ms", args.obs_flush_ms),
            ("obs_baseline", args.obs_baseline),
            ("fleet_router", args.fleet_router),
            ("fleet_advertise", args.fleet_advertise),
            ("opt", args.opt),
            ("opt_max_iterations", args.opt_max_iterations),
            ("opt_iter_budget", args.opt_iter_budget),
            ("opt_max_weight", args.opt_max_weight),
            ("route_learn", args.route_learn),
            ("route_shadow_rate", args.route_shadow_rate),
            ("route_registry", args.route_registry),
            ("sessions", args.sessions),
            ("session_lease_s", args.session_lease_s),
            ("session_max", args.session_max),
            ("session_max_per_tenant", args.session_max_per_tenant),
        ):
            if val is not None:
                kwargs[key] = val
        # The pool is process-global (like the breaker), not a Server
        # field: install the size before the service boots.
        host_workers = kwargs.pop("host_workers", None)
        if host_workers is not None:
            from . import hostpool

            hostpool.configure_pool(host_workers)
        # Profiler arming is process-global too: installed
        # here, at the process entry point, never inside Server — an
        # embedded server must not leak arming into its process.
        prof_mode = kwargs.pop("profile", None)
        prof_sample = kwargs.pop("profile_sample", None)
        if prof_mode is not None or prof_sample is not None:
            from . import profile as profiling

            profiling.configure(mode=prof_mode, sample=prof_sample)
        # BCP impl selection is engine-global (like the pool and the
        # profiler): installed at the process entry point, before any
        # program compiles.
        bcp_impl = kwargs.pop("bcp", None)
        if bcp_impl is not None:
            from .engine import core as _engine_core

            _engine_core.set_bcp_impl(bcp_impl)
        serve(**kwargs)
    except FileNotFoundError:
        print(f"error: no such file: {args.config}", file=sys.stderr)
        return 2
    except (ValueError, OSError, problem_io.ProblemFormatError,
            InternalSolverError, NoDeviceError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _cmd_top(args) -> int:
    """Live terminal fleet dashboard over the router's /fleet/status +
    /fleet/metrics surfaces (``deppy_tpu/cli.py:2016``)."""
    from .obs import top

    return top.run(args.router, interval_s=args.interval,
                   once=args.once)


def _cmd_deferred(args) -> int:
    """A verb whose modules the port has not yet: a usage error naming
    its ROADMAP item."""
    print(f"error: deppy {args.command} is not in the port yet "
          f"(ROADMAP {DEFERRED[args.command]})", file=sys.stderr)
    return 2


_COMMANDS = {
    "resolve": _cmd_resolve,
    "serve": _cmd_serve,
    "fleet": _cmd_fleet,
    "route": _cmd_route,
    "publish": _cmd_publish,
    "optimize": _cmd_optimize,
    "explain": lambda args: _cmd_optimize(args, explain=True),
    "stats": _cmd_stats,
    "trace": _cmd_trace,
    "profile": _cmd_profile,
    "routes": _cmd_routes,
    "top": _cmd_top,
    **{verb: _cmd_deferred for verb in DEFERRED},
}


def main(argv: Optional[List[str]] = None) -> int:
    """Parse ``argv`` and run its verb (``deppy_tpu/cli.py:2025-2071``).
    A deferred verb takes any arguments; every other verb refuses the
    ones it does not declare, as ``parse_args`` does."""
    parser = _build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.command not in DEFERRED:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.command is None:
        parser.print_help()
        return 0
    return _COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
