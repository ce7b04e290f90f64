"""Per-tenant weighted-fair admission policy (copy of ``deppy_tpu/sched/fair.py:1-104``).

With ``DEPPY_GPU_SCHED_FAIR`` on (the default) the scheduler keeps
per-tenant queued-lane accounting and sheds a tenant only when it
exceeds its own weighted share of the queue:

    cap(tenant) = max_depth * weight(tenant) / sum(weights of tenants
                                                   queued right now)

A lone tenant's cap is the whole queue — single-tenant behavior is
byte-identical to a global depth gate — while under contention the caps
split the queue by weight, so the offender sheds at its share and the
victim's lanes always find room.  (The scheduler adds a hard aggregate
backstop at 2x max_depth: caps sum to max_depth for any FIXED tenant
set, but tenant labels are client-controlled and sequentially minted
fresh tenants could otherwise ratchet total depth unbounded.)  Weights
(and priority lanes) are declarative, ``DEPPY_GPU_SCHED_TENANT_WEIGHTS``:
inline JSON, ``@FILE``, or a path mapping tenant to a bare weight number
or ``{"weight": W, "priority": P}``; the ``"default"`` entry covers
unlisted tenants.

**Priority lanes.**  ``priority`` (0 = urgent, larger = later; default
1) orders the dispatch loop's flush-head selection: the oldest queued
group of the MOST urgent priority class present flushes first, so a
latency-tier tenant's lanes never wait behind a bulk tenant's backlog.
Groups still coalesce across priorities (same size class + budget share
a dispatch — a free ride, never a delay).
"""

from __future__ import annotations

import json
from typing import Dict, Optional

DEFAULT_WEIGHT = 1.0
DEFAULT_PRIORITY = 1


class TenantPolicy:
    """Declarative per-tenant weights and priority classes."""

    def __init__(self, tenants: Optional[Dict[str, object]] = None):
        self.tenants: Dict[str, dict] = {}
        for name, spec in (tenants or {}).items():
            if isinstance(spec, (int, float)) \
                    and not isinstance(spec, bool):
                spec = {"weight": float(spec)}
            if not isinstance(spec, dict):
                raise ValueError(
                    f"tenant-weight entry for {name!r} must be a "
                    f"number or an object, got {type(spec).__name__}")
            weight = float(spec.get("weight", DEFAULT_WEIGHT))
            if weight <= 0:
                raise ValueError(
                    f"tenant {name!r}: weight must be positive")
            self.tenants[str(name)] = {
                "weight": weight,
                "priority": int(spec.get("priority", DEFAULT_PRIORITY)),
            }

    def _entry(self, tenant: str) -> dict:
        return self.tenants.get(tenant) or self.tenants.get("default") \
            or {"weight": DEFAULT_WEIGHT, "priority": DEFAULT_PRIORITY}

    def weight(self, tenant: str) -> float:
        return self._entry(tenant)["weight"]

    def priority(self, tenant: str) -> int:
        return self._entry(tenant)["priority"]

    def cap(self, tenant: str, max_depth: int,
            active_tenants) -> float:
        """``tenant``'s queued-lane cap given who is queued right now
        (``tenant`` itself always counts as active — its own admission
        is the question being asked)."""
        names = set(active_tenants) | {tenant}
        total = sum(self.weight(t) for t in names)
        return max_depth * self.weight(tenant) / max(total, 1e-9)

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> "TenantPolicy":
        """Inline JSON, ``@FILE``, or a file path — the fault-plan
        spec convention.  Raises ``ValueError``/``OSError`` on a
        malformed spec: an operator fairness policy that silently
        parses to nothing would admit the noisy tenant it was written
        to shed."""
        if not spec:
            return cls()
        text = spec.strip()
        if text.startswith("@"):
            with open(text[1:], "r", encoding="utf-8") as fh:
                text = fh.read()
        elif not text.startswith(("{", "[")):
            with open(text, "r", encoding="utf-8") as fh:
                text = fh.read()
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError(
                f"tenant-weight spec must be a tenant->weight mapping, "
                f"got {type(doc).__name__}")
        return cls(doc)
