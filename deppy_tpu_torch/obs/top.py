"""``deppy top`` (copy of ``deppy_tpu/obs/top.py:1-172``): a terminal fleet
dashboard.

A refresh loop over the router's two fleet surfaces:

  * ``GET /fleet/status`` — replica liveness/drain states, routing
    policy, telemetry-ingest counts per replica;
  * ``GET /fleet/metrics`` — the federated scrape: per-replica
    families under the ``replica`` label plus the fleet rollups.

Rendered as one screen per refresh: a fleet header line (live
replicas, fleet warm-hit ratio, fleet queue depth), one row per
replica (state, warm-hit, queue depth, worst cost-model drift ratio,
ingested event count), and the per-tenant fleet burn-rate line.  Pure
functions end to end (fetch -> snapshot dict -> text) so tests can pin
the rendering without a live fleet.  The ``deppy top`` command itself
comes with the port's CLI.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Dict, Optional

from .federate import parse_samples

FETCH_TIMEOUT_S = 10.0


def fetch(router: str) -> dict:
    """One dashboard snapshot from a live router (raises OSError-family
    on transport failure)."""
    host, _, port = router.rpartition(":")
    conn = http.client.HTTPConnection(host or "127.0.0.1", int(port),
                                      timeout=FETCH_TIMEOUT_S)
    try:
        conn.request("GET", "/fleet/status")
        status = json.loads(conn.getresponse().read().decode("utf-8"))
        conn.request("GET", "/fleet/metrics")
        metrics = conn.getresponse().read().decode("utf-8",
                                                   errors="replace")
    finally:
        conn.close()
    return snapshot(router, status, metrics)


def snapshot(router: str, status: dict, metrics_text: str) -> dict:
    """Fold the two fleet surfaces into one renderable dict."""
    samples = parse_samples(metrics_text)

    def _fleet(family: str) -> Optional[float]:
        vals = [v for n, labels, v in samples
                if n == family and "replica" not in labels]
        return vals[0] if vals else None

    def _per_replica(family: str, agg="sum") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, labels, v in samples:
            if n != family or "replica" not in labels:
                continue
            rep = labels["replica"]
            if agg == "max":
                out[rep] = max(out.get(rep, v), v)
            else:
                out[rep] = out.get(rep, 0.0) + v
        return out

    hits = _per_replica("deppy_cache_hits_total")
    incr = _per_replica("deppy_incremental_hits_total")
    misses = _per_replica("deppy_cache_misses_total")
    warm: Dict[str, Optional[float]] = {}
    for rep in set(hits) | set(misses):
        asks = hits.get(rep, 0.0) + misses.get(rep, 0.0)
        warm[rep] = (round((hits.get(rep, 0.0) + incr.get(rep, 0.0))
                           / asks, 3) if asks else None)
    burn = {labels.get("tenant", "?"): v
            for n, labels, v in samples
            if n == "deppy_fleet_tenant_burn_rate"}
    ingest = (status.get("telemetry") or {}).get("ingested") or {}
    rows = []
    for state in status.get("replicas", []):
        addr = state.get("replica", "?")
        rows.append({
            "replica": addr,
            "state": ("dead" if state.get("dead")
                      else "drained" if state.get("drained") else "up"),
            "warm_hit_ratio": warm.get(addr),
            "queue_depth": _per_replica("deppy_sched_queue_depth")
            .get(addr),
            "drift_ratio": _per_replica(
                "deppy_costmodel_drift_ratio", agg="max").get(addr),
            "regret_s": _per_replica(
                "deppy_route_regret_seconds_total").get(addr),
            "stale_classes": _per_replica(
                "deppy_route_stale_classes").get(addr),
            "events": ingest.get(addr),
        })
    return {
        "router": router,
        "policy": status.get("policy"),
        "replicas": rows,
        "fleet": {
            "warm_hit_ratio": _fleet("deppy_fleet_warm_hit_ratio"),
            "queue_depth": _fleet("deppy_fleet_queue_depth"),
            "tenant_burn_rate": burn,
            "route_regret_s": _fleet("deppy_fleet_route_regret_seconds"),
            "route_stale_classes":
                _fleet("deppy_fleet_route_stale_classes"),
        },
    }


def _num(v, fmt="{:.3f}") -> str:
    return "-" if v is None else fmt.format(v)


def render_text(snap: dict) -> str:
    fleet = snap.get("fleet", {})
    rows = snap.get("replicas", [])
    live = sum(1 for r in rows if r["state"] == "up")
    lines = [
        f"deppy fleet @ {snap.get('router', '?')}   "
        f"policy={snap.get('policy', '?')}   "
        f"{live}/{len(rows)} live   "
        f"warm={_num(fleet.get('warm_hit_ratio'))}   "
        f"queue={_num(fleet.get('queue_depth'), '{:.0f}')}   "
        f"regret={_num(fleet.get('route_regret_s'))}s   "
        f"stale={_num(fleet.get('route_stale_classes'), '{:.0f}')}",
        "",
        f"  {'REPLICA':<22}  {'STATE':<8}  {'WARM':>6}  {'QUEUE':>6}  "
        f"{'DRIFT':>6}  {'REGRET':>7}  {'STALE':>5}  {'EVENTS':>8}",
    ]
    for r in rows:
        lines.append(
            f"  {r['replica']:<22}  {r['state']:<8}  "
            f"{_num(r['warm_hit_ratio']):>6}  "
            f"{_num(r['queue_depth'], '{:.0f}'):>6}  "
            f"{_num(r['drift_ratio'], '{:.2f}'):>6}  "
            f"{_num(r.get('regret_s'), '{:.2f}'):>7}  "
            f"{_num(r.get('stale_classes'), '{:.0f}'):>5}  "
            f"{_num(r['events'], '{:.0f}'):>8}")
    burn = fleet.get("tenant_burn_rate") or {}
    if burn:
        lines.append("")
        lines.append("  tenant burn (fleet): " + "  ".join(
            f"{t}={burn[t]:.3f}" for t in sorted(burn)))
    return "\n".join(lines)


def run(router: str, interval_s: float = 2.0, once: bool = False,
        out=None) -> int:
    """The ``deppy top`` loop.  Returns a process exit code."""
    import sys

    out = out or sys.stdout
    while True:
        try:
            snap = fetch(router)
        except (OSError, ValueError, http.client.HTTPException) as exc:
            print(f"deppy top: cannot reach router at {router}: {exc}",
                  file=sys.stderr)
            return 1
        if not once:
            out.write("\x1b[2J\x1b[H")  # clear + home
        out.write(render_text(snap) + "\n")
        out.flush()
        if once:
            return 0
        try:
            time.sleep(interval_s)
        except KeyboardInterrupt:
            return 0
