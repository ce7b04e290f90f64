"""Metrics federation (copy of ``deppy_tpu/obs/federate.py:1-299``): one
fleet scrape from N replica scrapes.

Router ``GET /fleet/metrics`` = :func:`collect` (scrape every live
replica's ``/metrics`` concurrently, one thread per replica, mirroring
the split-forward path) + :func:`render_fleet_metrics`:

  * **rollups first** — the fleet-level gauges an autoscaler policy
    consumes, computed from the per-replica samples:
    ``deppy_fleet_warm_hit_ratio`` (fleet warm hits / fleet asks — the
    request-weighted average of the per-replica ratios),
    ``deppy_fleet_tenant_burn_rate{tenant}`` (request-weighted),
    ``deppy_fleet_queue_depth`` (sum), ``deppy_fleet_race_win_share
    {backend}`` (fraction of fleet race wins per backend) and the
    route-health totals (:func:`fleet_rollups`, reference ``:73-134``);
  * **merged families** — every per-replica family re-labeled with
    ``replica="<addr>"`` (first replica's HELP/TYPE wins), samples
    grouped per family so the output stays valid exposition format;
  * the router's own ``deppy_fleet_*`` registry last.

:func:`collect` and :func:`render_fleet_metrics` (reference
``:264-299``) need only an object with ``live_replicas()``,
``forward(addr, method, path, body, timeout=)`` and ``render_metrics()``.
A replica that fails to scrape is skipped (and charges the router's
transport breaker via ``forward``); the fleet scrape degrades instead
of failing.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

_SAMPLE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')

SCRAPE_TIMEOUT_S = 10.0


def parse_samples(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """``(name, labels, value)`` per sample line of an exposition page
    (comments and non-numeric samples skipped)."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            continue
        name, rawlabels, rawval = m.groups()
        try:
            value = float(rawval)
        except ValueError:
            continue
        labels = dict(_LABEL.findall(rawlabels)) if rawlabels else {}
        out.append((name, labels, value))
    return out


def _sum(samples, family: str) -> float:
    return sum(v for n, _, v in samples if n == family)


def _by_label(samples, family: str, label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n, labels, v in samples:
        if n == family and label in labels:
            out[labels[label]] = out.get(labels[label], 0.0) + v
    return out


# ------------------------------------------------------------- rollups


def fleet_rollups(scrapes: List[Tuple[str, str]]) -> dict:
    """Fleet-level aggregates from ``[(replica, exposition_text)]``."""
    warm_hits = warm_asks = queue_depth = 0.0
    route_regret = route_stale = route_shadow = route_learned = 0.0
    burn_num: Dict[str, float] = {}
    burn_den: Dict[str, float] = {}
    wins: Dict[str, float] = {}
    per_replica: Dict[str, dict] = {}
    for replica, text in scrapes:
        samples = parse_samples(text)
        hits = _sum(samples, "deppy_cache_hits_total") \
            + _sum(samples, "deppy_incremental_hits_total")
        asks = _sum(samples, "deppy_cache_hits_total") \
            + _sum(samples, "deppy_cache_misses_total")
        depth = _sum(samples, "deppy_sched_queue_depth")
        regret = _sum(samples, "deppy_route_regret_seconds_total")
        stale = _sum(samples, "deppy_route_stale_classes")
        warm_hits += hits
        warm_asks += asks
        queue_depth += depth
        route_regret += regret
        route_stale += stale
        route_shadow += _sum(samples,
                             "deppy_route_shadow_dispatches_total")
        route_learned += _sum(samples, "deppy_route_learned_rows")
        per_replica[replica] = {
            "warm_hit_ratio": (round(hits / asks, 6) if asks else None),
            "queue_depth": depth,
            "route_regret_s": round(regret, 6),
            "route_stale_classes": stale,
        }
        burn = _by_label(samples, "deppy_tenant_burn_rate", "tenant")
        reqs = _by_label(samples, "deppy_tenant_requests_total",
                         "tenant")
        for tenant, rate in burn.items():
            weight = reqs.get(tenant, 1.0) or 1.0
            burn_num[tenant] = burn_num.get(tenant, 0.0) + rate * weight
            burn_den[tenant] = burn_den.get(tenant, 0.0) + weight
        for backend, n in _by_label(samples, "deppy_race_wins_total",
                                    "backend").items():
            wins[backend] = wins.get(backend, 0.0) + n
    total_wins = sum(wins.values())
    return {
        "replicas": len(scrapes),
        "warm_hit_ratio": (round(warm_hits / warm_asks, 6)
                           if warm_asks else None),
        "warm_hits": warm_hits,
        "warm_asks": warm_asks,
        "queue_depth": queue_depth,
        "tenant_burn_rate": {
            t: round(burn_num[t] / burn_den[t], 6)
            for t in sorted(burn_num) if burn_den.get(t)},
        "race_win_share": {
            b: round(wins[b] / total_wins, 6)
            for b in sorted(wins)} if total_wins else {},
        "route_regret_s": round(route_regret, 6),
        "route_stale_classes": route_stale,
        "route_shadow_dispatches": route_shadow,
        "route_learned_rows": route_learned,
        "per_replica": per_replica,
    }


def render_rollup_lines(rollups: dict) -> List[str]:
    lines: List[str] = []
    if rollups.get("warm_hit_ratio") is not None:
        lines += [
            "# HELP deppy_fleet_warm_hit_ratio Fleet warm-hit ratio: "
            "(cache + incremental hits) / (cache hits + misses) summed "
            "over live replicas.",
            "# TYPE deppy_fleet_warm_hit_ratio gauge",
            f"deppy_fleet_warm_hit_ratio {rollups['warm_hit_ratio']}",
        ]
    lines += [
        "# HELP deppy_fleet_queue_depth Problems queued for coalesced "
        "dispatch right now, summed over live replicas.",
        "# TYPE deppy_fleet_queue_depth gauge",
        f"deppy_fleet_queue_depth {_fmt_num(rollups.get('queue_depth', 0))}",
    ]
    burn = rollups.get("tenant_burn_rate") or {}
    if burn:
        lines += [
            "# HELP deppy_fleet_tenant_burn_rate Request-weighted fleet "
            "error-budget burn rate per tenant.",
            "# TYPE deppy_fleet_tenant_burn_rate gauge",
        ]
        for tenant in sorted(burn):
            lines.append(
                f'deppy_fleet_tenant_burn_rate{{tenant="{tenant}"}} '
                f"{burn[tenant]}")
    share = rollups.get("race_win_share") or {}
    if share:
        lines += [
            "# HELP deppy_fleet_race_win_share Fraction of fleet "
            "portfolio-race wins per backend.",
            "# TYPE deppy_fleet_race_win_share gauge",
        ]
        for backend in sorted(share):
            lines.append(
                f'deppy_fleet_race_win_share{{backend="{backend}"}} '
                f"{share[backend]}")
    # Route health: fleet totals render only once some
    # replica exposes the families — a learn=off fleet's scrape stays
    # byte-identical to pre-plane.
    if (rollups.get("route_regret_s") or rollups.get("route_stale_classes")
            or rollups.get("route_shadow_dispatches")
            or rollups.get("route_learned_rows")):
        lines += [
            "# HELP deppy_fleet_route_regret_seconds Wall-clock seconds "
            "frozen routing defaults burned beyond observed race "
            "winners, summed over live replicas.",
            "# TYPE deppy_fleet_route_regret_seconds gauge",
            f"deppy_fleet_route_regret_seconds "
            f"{rollups.get('route_regret_s', 0.0)}",
            "# HELP deppy_fleet_route_stale_classes Live size classes "
            "with stale/missing routing rows, summed over live "
            "replicas.",
            "# TYPE deppy_fleet_route_stale_classes gauge",
            f"deppy_fleet_route_stale_classes "
            f"{_fmt_num(rollups.get('route_stale_classes', 0))}",
            "# HELP deppy_fleet_route_learned_rows Live-learned routing "
            "rows adopted across live replicas.",
            "# TYPE deppy_fleet_route_learned_rows gauge",
            f"deppy_fleet_route_learned_rows "
            f"{_fmt_num(rollups.get('route_learned_rows', 0))}",
        ]
    return lines


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


# -------------------------------------------------------------- merge


def merge_scrapes(scrapes: List[Tuple[str, str]]) -> List[str]:
    """Merge N exposition pages into one, every sample re-labeled with
    its source ``replica``.  Families are grouped (samples contiguous
    under one HELP/TYPE, first replica's header wins) so the merged
    page stays valid exposition format."""
    order: List[str] = []
    headers: Dict[str, List[str]] = {}
    samples: Dict[str, List[str]] = {}
    known: set = set()

    def _family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in known:
                return name[: -len(suffix)]
        return name

    for replica, text in scrapes:
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    fam = parts[2]
                    known.add(fam)
                    if fam not in headers:
                        headers[fam] = []
                        samples[fam] = []
                        order.append(fam)
                    if len(headers[fam]) < 2:
                        headers[fam].append(line)
                continue
            m = _SAMPLE.match(line)
            if m is None:
                continue
            name, rawlabels, rawval = m.groups()
            fam = _family_of(name)
            if fam not in headers:
                headers[fam] = []
                samples[fam] = []
                order.append(fam)
            labels = f'replica="{replica}"'
            if rawlabels:
                labels += f",{rawlabels}"
            samples[fam].append(f"{name}{{{labels}}} {rawval}")
    lines: List[str] = []
    for fam in order:
        lines.extend(headers[fam])
        lines.extend(samples[fam])
    return lines


# ------------------------------------------------------------- collect


def collect(router) -> List[Tuple[str, str]]:
    """Scrape every live replica's ``/metrics`` concurrently through
    the router's forward path (so failures charge the transport
    breaker).  Returns ``[(replica_addr, text)]`` for the replicas that
    answered, in address order."""
    replicas = router.live_replicas()
    results: List[Optional[str]] = [None] * len(replicas)

    def _scrape(i: int, addr: str) -> None:
        try:
            status, data, _ = router.forward(
                addr, "GET", "/metrics", None,
                timeout=SCRAPE_TIMEOUT_S)
        except OSError:
            return
        if status == 200:
            results[i] = data.decode("utf-8", errors="replace")

    threads = [threading.Thread(target=_scrape, args=(i, addr),
                                name=f"fleet-scrape-{i}", daemon=True)
               for i, addr in enumerate(replicas)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SCRAPE_TIMEOUT_S + 1.0)
    return [(addr, text)
            for addr, text in zip(replicas, results) if text is not None]


def render_fleet_metrics(router) -> str:
    """The ``GET /fleet/metrics`` body: rollups, merged replica
    families, then the router's own registry."""
    scrapes = collect(router)
    lines = render_rollup_lines(fleet_rollups(scrapes))
    lines += merge_scrapes(scrapes)
    return "\n".join(lines) + "\n" + router.render_metrics()
