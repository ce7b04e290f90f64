"""Per-tenant SLO accounting (copy of ``deppy_tpu/profile/slo.py:1-260``, plain locks).

Tenant identity comes from the caller (the scheduler's ``tenant=``;
the service's ``X-Deppy-Tenant`` header comes with the service),
threaded through the scheduler's groups so deadline expiries are
attributable to the tenant whose lane expired, not its coalesced
batchmates.  The :class:`SLOAccountant` keeps one bounded sliding
window of request latencies per tenant and renders:

  * ``deppy_tenant_requests_total{tenant=}`` — requests served;
  * ``deppy_tenant_deadline_miss_total{tenant=}`` — requests with at
    least one deadline-degraded lane;
  * ``deppy_tenant_slo_violations_total{tenant=}`` — requests that
    violated the tenant's SLO (latency above target p99, a deadline
    miss, or a server error);
  * ``deppy_tenant_p99_seconds{tenant=}`` — p99 latency over the
    window;
  * ``deppy_tenant_burn_rate{tenant=}`` — (violating fraction of the
    window) / error budget: 1.0 = consuming the budget exactly, above
    1.0 = burning faster than the SLO allows.

The SLO itself is declarative (``DEPPY_GPU_SLO``): inline JSON,
``@FILE``, or a file path — the fault plans' spec convention — mapping
tenant name to ``{"target_p99_s": ..., "error_budget": ...}``; the
``"default"`` entry covers unlisted tenants.  The accountant takes a
plain ``threading`` lock where the reference takes a lockdep-named one
(``analysis.lockdep`` comes with ROADMAP A7.2).
"""

from __future__ import annotations

import json
import re
import threading
from collections import deque
from typing import Dict, Optional

from .. import config

# Built-in default SLO when no spec (or no "default" entry) is given:
# generous enough that an unconfigured service never alarms, tight
# enough that burn rate still moves under real degradation.
DEFAULT_TARGET_P99_S = 1.0
DEFAULT_ERROR_BUDGET = 0.01
# Sliding-window size per tenant (requests).  Burn rate and p99 are
# computed over this window, so they recover once the incident ends.
WINDOW = 256
# Distinct tenants tracked.  X-Deppy-Tenant is unauthenticated, so a
# client minting a fresh tenant per request must not grow server
# memory or /metrics cardinality without bound: past the cap, new
# names account under one shared overflow bucket (the cap is far above
# any real tenant population; a legit tenant seen before the flood
# keeps its own stats).
MAX_TENANTS = 256
OVERFLOW_TENANT = "_overflow"

# Tenant names become Prometheus label values: restrict to a safe
# charset so a hostile header can never inject exposition syntax.
_TENANT_RE = re.compile(r"[^A-Za-z0-9._-]+")
_MAX_TENANT_LEN = 64
# Replica identities are operator-set (never attacker-controlled), but
# they still land in label values — same charset plus ':' and '[]' so
# the conventional host:port spelling survives.
_REPLICA_RE = re.compile(r"[^A-Za-z0-9._:\[\]-]+")


def sanitize_replica(raw: Optional[str]) -> Optional[str]:
    """Serving-identity string → label-safe replica id (None when it
    sanitizes to nothing)."""
    if not raw:
        return None
    return _REPLICA_RE.sub("", raw.strip())[:_MAX_TENANT_LEN] or None


def sanitize_tenant(raw: Optional[str]) -> str:
    """Header value → tenant id: strip, drop unsafe characters, bound
    the length, and strip leading underscores (``_``-prefixed names —
    notably the ``_overflow`` cardinality bucket — are reserved for
    the accountant itself; an unauthenticated client must not be able
    to write into them); anything that sanitizes to nothing is the
    default tenant."""
    from .ledger import DEFAULT_TENANT

    if not raw:
        return DEFAULT_TENANT
    clean = _TENANT_RE.sub("", raw.strip()).lstrip("_")[:_MAX_TENANT_LEN]
    return clean or DEFAULT_TENANT


class SLOConfig:
    """Declarative per-tenant SLO targets."""

    def __init__(self, tenants: Optional[Dict[str, dict]] = None):
        self.tenants: Dict[str, dict] = {}
        for name, spec in (tenants or {}).items():
            if not isinstance(spec, dict):
                raise ValueError(
                    f"SLO entry for {name!r} must be an object, got "
                    f"{type(spec).__name__}")
            self.tenants[str(name)] = {
                "target_p99_s": float(
                    spec.get("target_p99_s", DEFAULT_TARGET_P99_S)),
                "error_budget": float(
                    spec.get("error_budget", DEFAULT_ERROR_BUDGET)),
            }

    def for_tenant(self, tenant: str) -> dict:
        return self.tenants.get(tenant) or self.tenants.get("default") or {
            "target_p99_s": DEFAULT_TARGET_P99_S,
            "error_budget": DEFAULT_ERROR_BUDGET,
        }

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> "SLOConfig":
        """Inline JSON, ``@FILE``, or a file path (the fault-plan spec
        convention).  Raises ``ValueError``/``OSError`` on a malformed
        spec — an operator SLO that silently parses to nothing would
        report every tenant green."""
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
                f"SLO spec must be a tenant->target mapping, got "
                f"{type(doc).__name__}")
        return cls(doc)


def slo_config_from_env() -> SLOConfig:
    return SLOConfig.from_spec(config.env_raw("DEPPY_GPU_SLO"))


class _TenantStats:
    __slots__ = ("requests", "deadline_misses", "violations", "window")

    def __init__(self):
        self.requests = 0
        self.deadline_misses = 0
        self.violations = 0
        # (latency_s, violated) per request, bounded.
        self.window: deque = deque(maxlen=WINDOW)


class SLOAccountant:
    """Per-tenant request accounting + burn-rate rendering.

    Self-contained (own lock, own families) and appended to the
    service's ``/metrics`` scrape via :meth:`render_metric_lines` —
    the same injection pattern the fault and hostpool families use, so
    embedded servers and tests get it without touching a registry."""

    def __init__(self, config: Optional[SLOConfig] = None,
                 replica: Optional[str] = None):
        self.config = config if config is not None else SLOConfig()
        # Replica identity: set from the server's serving identity
        # (the service's replica name, ROADMAP A5.6.6) so fleet burn rate
        # is attributable per tenant PER REPLICA when N replicas'
        # scrapes aggregate.  None (single-process deployments) keeps
        # the historical tenant-only label set byte for byte.
        self.replica = sanitize_replica(replica)
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantStats] = {}

    def observe(self, tenant: str, total_s: float,
                deadline_miss: bool = False, error: bool = False) -> None:
        """Account one finished request for ``tenant``."""
        slo = self.config.for_tenant(tenant)
        violated = bool(deadline_miss or error
                        or total_s > slo["target_p99_s"])
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                if len(self._tenants) >= MAX_TENANTS:
                    # Cardinality bound (unauthenticated header): new
                    # names past the cap share the overflow bucket.
                    tenant = OVERFLOW_TENANT
                    st = self._tenants.get(tenant)
                if st is None:
                    st = self._tenants[tenant] = _TenantStats()
            st.requests += 1
            if deadline_miss:
                st.deadline_misses += 1
            if violated:
                st.violations += 1
            st.window.append((float(total_s), violated))

    # ------------------------------------------------------------- reading

    def _tenant_view_locked(self, tenant: str, st: _TenantStats) -> dict:
        from ..telemetry import percentile

        slo = self.config.for_tenant(tenant)
        lat = sorted(l for l, _ in st.window)
        n = len(lat)
        p99 = float(percentile(lat, 99)) if n else 0.0
        bad = sum(1 for _, v in st.window if v)
        frac = bad / n if n else 0.0
        budget = max(slo["error_budget"], 1e-9)
        return {
            "requests": st.requests,
            "deadline_misses": st.deadline_misses,
            "violations": st.violations,
            "window": n,
            "window_violations": bad,
            "p99_s": round(p99, 6),
            "target_p99_s": slo["target_p99_s"],
            "error_budget": slo["error_budget"],
            "burn_rate": round(frac / budget, 4),
        }

    def snapshot(self) -> Dict[str, dict]:
        """The ``/debug/slo`` document body: every observed tenant's
        counters, window p99, SLO targets, and burn rate."""
        with self._lock:
            return {t: self._tenant_view_locked(t, st)
                    for t, st in sorted(self._tenants.items())}

    def render_metric_lines(self) -> list:
        """Prometheus exposition lines for every observed tenant, in
        sorted tenant order (deterministic scrapes, like the registry
        families)."""
        snap = self.snapshot()
        if not snap:
            return []
        lines = []
        rep = (f',replica="{self.replica}"' if self.replica else "")

        def fam(name, kind, help, value_of):
            lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for tenant, view in snap.items():
                lines.append(
                    f'{name}{{tenant="{tenant}"{rep}}} '
                    f"{value_of(view)}")

        fam("deppy_tenant_requests_total", "counter",
            "Requests served, by tenant (X-Deppy-Tenant).",
            lambda v: v["requests"])
        fam("deppy_tenant_deadline_miss_total", "counter",
            "Requests with at least one deadline-degraded lane, by "
            "tenant.", lambda v: v["deadline_misses"])
        fam("deppy_tenant_slo_violations_total", "counter",
            "Requests violating the tenant's SLO (latency > target "
            "p99, deadline miss, or server error).",
            lambda v: v["violations"])
        fam("deppy_tenant_p99_seconds", "gauge",
            "p99 request latency over the tenant's sliding window.",
            lambda v: v["p99_s"])
        fam("deppy_tenant_burn_rate", "gauge",
            "Error-budget burn rate over the sliding window (1.0 = "
            "consuming the budget exactly).", lambda v: v["burn_rate"])
        return lines
