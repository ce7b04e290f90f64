"""The per-process online route registry (copy of
``deppy_tpu/routes/learn.py:1-183``).

Decayed live measurements (the regret ledger's per-(class, backend)
µs-per-lane estimates, fed by race winners, uncensored losers and shadow
probes) are re-ranked into candidate ``portfolio.<class>`` rows.  Once
at least two backends carry ``DEPPY_GPU_ROUTE_MIN_SAMPLES`` (default 8)
uncensored observations for a class and the measured best differs from
the currently served head, the row is ADOPTED:

  * the in-memory overlay
    (:func:`deppy_tpu_torch.engine.registry.set_route_overlay`) flips
    ``ranked()`` for this process — the registry file is never mutated
    mid-serve;
  * a ``route_learned`` sink event records the row, the estimates it was
    ranked from and its provenance (replica, source, platform);
  * optionally (``DEPPY_GPU_ROUTE_REGISTRY``, a path) the row persists
    through the flock-guarded store
    (:func:`deppy_tpu_torch.engine.defaults.merge_rows`),
    provenance-stamped, so a restart keeps the discovery.  Persistence
    is best-effort: an ``OSError`` never fails serving.

Safety is structural: adoption only reorders which DEFINITIVE backends
the racer launches.  The first-definitive-winner rule and the sampled
cross-check still gate every answer, so an adversarially wrong learned
row costs speed, never answers.  The platform is the serving device's
(``"gpu"`` for ``"cuda"``), and :meth:`consider` reads the served order
for that device.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

DEFAULT_MIN_SAMPLES = 8


def _env_min_samples() -> int:
    """``DEPPY_GPU_ROUTE_MIN_SAMPLES`` as the reference's
    ``config.env_int(strict=False)`` reads it: an int, else the default."""
    raw = os.environ.get("DEPPY_GPU_ROUTE_MIN_SAMPLES")
    if raw is None or not raw.strip():
        return DEFAULT_MIN_SAMPLES
    try:
        return int(raw)
    except ValueError:
        return DEFAULT_MIN_SAMPLES


class OnlineRouteRegistry:
    def __init__(self, ledger, min_samples: Optional[int] = None,
                 platform: Optional[str] = None,
                 replica: Optional[str] = None,
                 registry=None, registry_path: Optional[str] = None,
                 watcher=None, device="cuda"):
        from .. import telemetry
        from ..engine import defaults

        if min_samples is None:
            min_samples = _env_min_samples()
        self.min_samples = max(int(min_samples), 1)
        self.device = device
        if platform is None:
            platform = defaults.platform_of(device)
        self.platform = platform
        self.replica = replica
        self._registry = (registry if registry is not None
                          else telemetry.default_registry())
        if registry_path is None:
            raw = os.environ.get("DEPPY_GPU_ROUTE_REGISTRY")
            registry_path = raw if raw is not None and raw.strip() else None
        self.registry_path = registry_path or None
        self.watcher = watcher
        self._ledger = ledger
        self._lock = threading.Lock()
        self._adopted: Dict[str, str] = {}  # "portfolio.<cls>" -> row

    # ---------------------------------------------------------- propose

    def consider(self, cls: str) -> Optional[str]:
        """Re-rank one class from the ledger's live estimates; adopt a
        new row when the measurement disagrees with what is served.
        Returns the adopted row (None = no change)."""
        from ..engine import registry as engine_registry

        est = self._ledger_estimates().get(cls) or {}
        eligible = {
            b: row for b, row in est.items()
            if row.get("us_per_lane") is not None
            and row.get("samples", 0) >= self.min_samples
            and b in engine_registry.specs()}
        if len(eligible) < 2:
            return None
        order = sorted(eligible,
                       key=lambda b: eligible[b]["us_per_lane"])
        row = ",".join(order)
        key = f"portfolio.{cls}"
        with self._lock:
            if self._adopted.get(key) == row:
                return None
            served, _ = engine_registry.ranked(cls, self.device)
            if key not in self._adopted and served \
                    and served[0] == order[0]:
                # The frozen row already leads with the measured best —
                # adopting would churn the tail for no regret win.
                return None
        self.adopt({key: row}, source="live",
                   estimates={b: eligible[b]["us_per_lane"]
                              for b in order})
        return row

    def _ledger_estimates(self) -> dict:
        return self._ledger.estimates() if self._ledger is not None \
            else {}

    # ------------------------------------------------------------ adopt

    def adopt(self, rows: Dict[str, str], source: str,
              origin: Optional[str] = None,
              estimates: Optional[dict] = None) -> Dict[str, str]:
        """Install learned rows on the overlay (idempotent — already-
        adopted identical rows are skipped, which also terminates a
        gossip echo).  Returns the rows actually applied."""
        from ..engine import registry as engine_registry

        specs = engine_registry.specs()
        applied: Dict[str, str] = {}
        with self._lock:
            for key, row in rows.items():
                if not (isinstance(key, str)
                        and key.startswith("portfolio")
                        and isinstance(row, str)):
                    continue
                names = [n.strip() for n in row.split(",")
                         if n.strip() in specs]
                if len(names) < 2:
                    continue
                canon = ",".join(names)
                if self._adopted.get(key) == canon:
                    continue
                self._adopted[key] = canon
                applied[key] = canon
            if applied:
                engine_registry.update_route_overlay(applied, self.device)
        if not applied:
            return applied
        for key, row in applied.items():
            cls = key.split(".", 1)[1] if "." in key else None
            if cls and self.watcher is not None:
                self.watcher.mark_fresh(cls)
            fields = {"key": key, "row": row, "source": source,
                      "platform": self.platform}
            if cls:
                fields["size_class_name"] = cls
            if self.replica:
                fields["replica"] = self.replica
            if origin:
                fields["origin"] = origin
            if estimates:
                fields["est_us_per_lane"] = {
                    b: round(v, 3) for b, v in estimates.items()}
            self._registry.event("route_learned", **fields)
        if self.registry_path and source == "live":
            # Persist through the flock-guarded store so a restart keeps
            # the discovery, provenance-stamped like every other
            # measured row.
            from ..engine import defaults

            try:
                defaults.merge_rows(
                    self.platform, dict(applied),
                    evidence={"platform": self.platform,
                              "source": "route_learn",
                              "replica": self.replica or ""},
                    path=self.registry_path)
            except OSError:
                pass  # persistence is best-effort; serving never fails
        return applied

    # ---------------------------------------------------------- snapshot

    def adopted(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._adopted)

    def render_metric_lines(self, replica: Optional[str] = None) -> list:
        rep = f'{{replica="{replica}"}}' if replica else ""
        with self._lock:
            n = len(self._adopted)
        return [
            "# HELP deppy_route_learned_rows Live-learned routing rows "
            "currently adopted on this replica's overlay.",
            "# TYPE deppy_route_learned_rows gauge",
            f"deppy_route_learned_rows{rep} {n}",
        ]
