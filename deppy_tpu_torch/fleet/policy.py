"""The SLO-burn autoscale policy (copy of ``deppy_tpu/fleet/policy.py:1-125``).

The fleet already measures what autoscalers usually guess: every
replica exports the per-tenant SLO burn rate
(``deppy_tenant_burn_rate``, federated fleet-wide by
:mod:`deppy_tpu_torch.obs.federate`).  Burn > 1 means a tenant spends
error budget faster than its SLO window replenishes it.  This module
turns that signal into scale recommendations:

  * ``scale_up``    — the hottest replica burns above ``BURN_UP`` and
    no replica is cold enough to absorb a rebalance: the fleet needs
    another member (a runtime join via ``POST /fleet/join``).
  * ``rebalance``   — a replica burns above ``BURN_UP`` while another
    sits at or below ``BURN_DOWN``: capacity exists, placement is
    wrong.  Drain the hot replica; its arcs (and warm state) respread.
  * ``scale_down``  — every replica burns below ``BURN_DOWN`` with an
    idle queue: the coldest replica is the cheapest drain.
  * ``hold``        — burn within band, or no samples yet.

Execution stays operator-driven: the recommendation surfaces on
``GET /fleet/policy`` and as ``fleet_policy`` telemetry events.
:func:`decide` is pure — thresholds and burn samples in, decision out.
The thresholds are ``DEPPY_GPU_FLEET_BURN_UP`` and ``_BURN_DOWN``, read
as the reference reads its ``DEPPY_TPU_FLEET_BURN_*`` (a malformed value
warns and reads the default).  The CLI's ``deppy fleet scale`` is
ROADMAP A7.2.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import faults, telemetry

DEFAULT_BURN_UP = 1.0
DEFAULT_BURN_DOWN = 0.25


def decide(per_replica_burn: Dict[str, Dict[str, float]],
           queue_depth: float, burn_up: float, burn_down: float) -> dict:
    """Pure decision core: per-replica-per-tenant burn rates in,
    ``{decision, target, reasons}`` out.

    Each replica is scored by its hottest tenant (fairness means the
    worst-served tenant is the one the SLO answers for), and the
    thresholds compare against that peak.
    """
    hot = {rep: max(burn.values())
           for rep, burn in per_replica_burn.items() if burn}
    reasons: List[str] = []
    if not hot:
        return {"decision": "hold", "target": None,
                "reasons": ["no per-tenant burn samples yet"]}
    # Ties break on the address so two routers evaluating the same
    # scrape recommend the same victim.
    peak_rep = max(hot, key=lambda r: (hot[r], r))
    cold_rep = min(hot, key=lambda r: (hot[r], r))
    peak, cold = hot[peak_rep], hot[cold_rep]
    target: Optional[str] = None
    if peak > burn_up and cold > burn_down:
        decision = "scale_up"
        reasons.append(
            f"peak burn {peak:.3f} > {burn_up:g} on {peak_rep} and the "
            f"coldest replica ({cold_rep}, {cold:.3f}) is above "
            f"{burn_down:g} — no capacity to rebalance into")
    elif peak > burn_up:
        decision, target = "rebalance", peak_rep
        reasons.append(
            f"burn skew: {peak_rep} at {peak:.3f} > {burn_up:g} while "
            f"{cold_rep} sits at {cold:.3f} <= {burn_down:g} — drain "
            f"{peak_rep} so its arcs respread onto cold capacity")
    elif peak < burn_down and len(hot) > 1 and queue_depth <= 0:
        decision, target = "scale_down", cold_rep
        reasons.append(
            f"fleet-wide peak burn {peak:.3f} < {burn_down:g} across "
            f"{len(hot)} replicas with an idle queue — {cold_rep} is "
            f"the cheapest drain")
    else:
        decision = "hold"
        reasons.append(f"burn within band ({cold:.3f}..{peak:.3f})")
    return {"decision": decision, "target": target, "reasons": reasons}


def evaluate(router) -> dict:
    """One policy evaluation over a live fleet scrape.

    Scrapes every routable replica, extracts each replica's per-tenant
    burn rates, and runs :func:`decide` against the
    ``DEPPY_GPU_FLEET_BURN_UP``/``_DOWN`` thresholds.  Emits a
    ``fleet_policy`` telemetry event and counts the decision on
    ``deppy_fleet_policy_evals_total``.
    """
    from ..obs import federate

    scrapes = federate.collect(router)
    rollups = federate.fleet_rollups(scrapes)
    per_replica_burn: Dict[str, Dict[str, float]] = {}
    for replica, text in scrapes:
        samples = federate.parse_samples(text)
        burn = federate._by_label(samples, "deppy_tenant_burn_rate",
                                  "tenant")
        per_replica_burn[replica] = {t: round(v, 6)
                                     for t, v in burn.items()}
    burn_up = faults.env_float("DEPPY_GPU_FLEET_BURN_UP",
                               DEFAULT_BURN_UP, warn=True)
    burn_down = faults.env_float("DEPPY_GPU_FLEET_BURN_DOWN",
                                 DEFAULT_BURN_DOWN, warn=True)
    out = decide(per_replica_burn, rollups.get("queue_depth") or 0.0,
                 burn_up, burn_down)
    out.update({
        "epoch": router.epoch,
        "replicas": len(scrapes),
        "burn_up": burn_up,
        "burn_down": burn_down,
        "per_replica_burn": per_replica_burn,
        "tenant_burn_rate": rollups.get("tenant_burn_rate") or {},
        "warm_hit_ratio": rollups.get("warm_hit_ratio"),
        "queue_depth": rollups.get("queue_depth"),
    })
    if router._c_policy_evals is not None:
        router._c_policy_evals.inc(label=out["decision"])
    telemetry.default_registry().event(
        "fleet_policy", decision=out["decision"], target=out["target"],
        epoch=router.epoch, replicas=len(scrapes),
        reasons=out["reasons"])
    return out
