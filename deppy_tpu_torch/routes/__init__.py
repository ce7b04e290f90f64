"""The route-health plane (copy of ``deppy_tpu/routes/__init__.py:1-279``).

Every routing decision in the stack is measured offline and frozen; this
package makes routing-decision QUALITY a live metric and closes the
measured-defaults loop.  Four pieces:

  * **ledger** — :class:`~deppy_tpu_torch.routes.ledger.RegretLedger`:
    folds the racer's ``race`` events (winner wall and censored-aware
    loser walls) and shadow ``route`` events into decayed per-(class,
    backend) wall estimates, per-class win shares and a running regret
    total charged to the frozen default
    (``deppy_route_regret_seconds_total`` / ``deppy_route_win_share``).
  * **staleness** — :class:`~deppy_tpu_torch.routes.staleness.StalenessWatcher`:
    grades live-observed classes against the defaults store's
    provenance stamps (``route_stale`` events, one per crossing;
    ``deppy_route_stale_classes``).
  * **shadow** — :class:`~deppy_tpu_torch.routes.shadow.ShadowSampler`:
    for flagged classes only, a deterministic 1-in-N sampler duplicates
    an already-coalesced flush to one non-serving candidate on the
    scheduler's idle-priority queue
    (:meth:`deppy_tpu_torch.sched.Scheduler.submit_shadow`: live traffic
    preempts; results feed the ledger, never a response).  A probe of the
    ``device`` backend launches the kernels from the ``deppy-sched``
    loop thread.
  * **learn** — :class:`~deppy_tpu_torch.routes.learn.OnlineRouteRegistry`:
    re-ranks classes from live estimates and adopts ``portfolio.<class>``
    rows onto the engine registry's in-memory overlay, gated by the
    racer's definitive-winner rule and sampled cross-check, so a learned
    route changes speed, never answers.

Armed by ``DEPPY_GPU_ROUTE_LEARN`` (the reference's
``DEPPY_TPU_ROUTE_LEARN``) or :func:`start_plane`'s ``mode``: ``off``
(the default) constructs nothing — no forwarder, no scheduler hook, no
metric families, responses unchanged; ``observe`` runs the ledger,
staleness and shadow probing without adoption; ``on`` adds the online
registry.  The other knobs: ``DEPPY_GPU_ROUTE_DECAY``,
``DEPPY_GPU_ROUTE_MAX_AGE_S``, ``DEPPY_GPU_ROUTE_SHADOW_RATE``,
``DEPPY_GPU_ROUTE_MIN_SAMPLES`` and ``DEPPY_GPU_ROUTE_REGISTRY``.  The
plane's platform and candidate ranking follow the scheduler's
``device`` (``"cuda"`` without a scheduler).

Left for later items of ROADMAP: ``POST /v1/routes/learned`` and the
``/metrics`` route families on the service (A5.6.6), the obs streamer's
gossip leg and the fleet's route rollups (A5.6.5, A5.6.7), and the
``deppy routes`` CLI over :mod:`.report` (A7.2).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from .ledger import RegretLedger
from .learn import OnlineRouteRegistry
from .shadow import ShadowSampler
from .staleness import StalenessWatcher

MODES = ("off", "observe", "on")


def resolve_mode(mode: Optional[str] = None) -> str:
    if mode is None:
        mode = os.environ.get("DEPPY_GPU_ROUTE_LEARN", "off")
    mode = str(mode).strip().lower()
    if mode in ("off", "0", "false", "no", ""):
        return "off"
    if mode in ("on", "1", "true", "yes", "learn"):
        return "on"
    return "observe"


class RoutePlane:
    """The per-process route-health plane: a default-registry event
    forwarder (ledger + learner) plus the scheduler's flush-observation
    hook (staleness + shadow sampling)."""

    def __init__(self, scheduler=None, mode: str = "observe",
                 shadow_rate: Optional[float] = None,
                 max_age_s: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 decay: Optional[float] = None,
                 registry_path: Optional[str] = None,
                 replica: Optional[str] = None,
                 registry=None):
        from .. import faults, telemetry
        from ..engine import defaults
        from ..profile import sanitize_replica

        self.mode = mode
        self.replica = sanitize_replica(replica)
        self._registry = (registry if registry is not None
                          else telemetry.default_registry())
        self._scheduler = scheduler
        self.device = getattr(scheduler, "device", "cuda")
        if decay is None:
            decay = faults.env_float("DEPPY_GPU_ROUTE_DECAY", None)
        self.ledger = RegretLedger(decay=decay)
        self.watcher = StalenessWatcher(
            max_age_s=max_age_s, platform=defaults.platform_of(self.device),
            replica=self.replica, registry=self._registry)
        self.sampler = ShadowSampler(rate=shadow_rate, device=self.device)
        self.learner: Optional[OnlineRouteRegistry] = None
        if mode == "on":
            self.learner = OnlineRouteRegistry(
                self.ledger, min_samples=min_samples,
                platform=self.watcher.platform, replica=self.replica,
                registry=self._registry, registry_path=registry_path,
                watcher=self.watcher, device=self.device)

    # -------------------------------------------------------- lifecycle

    def install(self) -> None:
        self._registry.add_forwarder(self)
        if self._scheduler is not None:
            self._scheduler.set_route_plane(self)

    def close(self, clear_overlay: bool = True) -> None:
        from ..engine import registry as engine_registry

        self._registry.remove_forwarder(self)
        if self._scheduler is not None:
            self._scheduler.set_route_plane(None)
        if clear_overlay and self.learner is not None:
            adopted = self.learner.adopted()
            if adopted:
                overlay = engine_registry.route_overlay(self.device)
                for key in adopted:
                    overlay.pop(key, None)
                engine_registry.set_route_overlay(overlay, self.device)

    # ------------------------------------------------------- event side

    def __call__(self, event: dict) -> None:
        """Registry event forwarder — must never raise."""
        try:
            kind = event.get("kind")
            if kind not in ("race", "route"):
                return
            self.ledger.fold(event)
            if self.learner is not None:
                cls = event.get("size_class_name")
                if cls:
                    self.learner.consider(str(cls))
        # A broken route-health fold must never fail the race that
        # emitted the event.
        except Exception:
            pass

    # ------------------------------------------------------- flush side

    def observe_flush(self, scheduler, live) -> None:
        """Called by the scheduler after each cold live flush: grade
        the class's routing row and, when flagged, maybe queue one
        shadow probe at idle priority."""
        from .. import faults
        from ..engine.driver import padded_class

        cls = padded_class([lane.problem for lane in live])
        reason = self.watcher.observe(cls)
        if reason is None or self.sampler.interval == 0:
            return
        from ..engine import registry as engine_registry

        racer = getattr(scheduler, "_racer", None)
        k = racer.k if racer is not None else 1
        need_card = any(
            lane.problem.card_act.shape[0] > 0
            and (lane.problem.card_act >= 0).any() for lane in live)
        device_ok = not faults.default_breaker().blocks_device()
        # The exclusion set is exactly the entrant set the racer's
        # plan() would launch for this flush — a shadow probe must
        # measure a backend the live race does NOT already measure.
        serving, _ = engine_registry.candidates(
            cls, k=k, device_ok=device_ok, cardinality=need_card,
            device=scheduler.device)
        exclude = list(serving)
        if serving:
            head = (self.ledger.estimates().get(cls) or {}).get(
                serving[0])
            if head is None or head.get("us_per_lane") is None:
                # The serving head (the frozen default) is cancelled the
                # moment another entrant wins, so the race can never
                # observe its full wall — yet that counterfactual IS the
                # regret signal.  Keep it probeable until one uncensored
                # wall lands in the ledger.
                exclude = serving[1:]
        backend = self.sampler.pick(cls, exclude=exclude,
                                    cardinality=need_card,
                                    device_ok=device_ok)
        if backend is None:
            return
        scheduler.submit_shadow(backend, cls,
                                [lane.problem for lane in live],
                                max_steps=live[0].max_steps)

    # ----------------------------------------------------------- render

    def snapshot(self) -> dict:
        doc = {
            "mode": self.mode,
            "classes": self.ledger.snapshot(),
            "stale": self.watcher.status(),
            "shadow": self.ledger.shadow_counts(),
        }
        if self.learner is not None:
            doc["learned"] = self.learner.adopted()
        return doc

    def render_metric_lines(self) -> List[str]:
        lines = self.ledger.render_metric_lines(replica=self.replica)
        lines += self.watcher.render_metric_lines(replica=self.replica)
        if self.learner is not None:
            lines += self.learner.render_metric_lines(
                replica=self.replica)
        return lines


# The process-wide active plane (one serving process = one replica):
# disarmed, the module-level render_metric_lines() is exactly [].
_LOCK = threading.Lock()
_PLANE: Optional[RoutePlane] = None


def start_plane(scheduler=None, mode: Optional[str] = None,
                **kw) -> Optional[RoutePlane]:
    """Build, install and register the process route plane; replaces
    any previous one.  Returns None (nothing armed, nothing changed)
    when the resolved mode is ``off``."""
    global _PLANE
    resolved = resolve_mode(mode)
    if resolved == "off":
        return None
    plane = RoutePlane(scheduler, mode=resolved, **kw)
    with _LOCK:
        prev, _PLANE = _PLANE, plane
    if prev is not None:
        prev.close()
    plane.install()
    return plane


def stop_plane() -> None:
    global _PLANE
    with _LOCK:
        plane, _PLANE = _PLANE, None
    if plane is not None:
        plane.close()


def active_plane() -> Optional[RoutePlane]:
    return _PLANE


def adopt_remote(rows: Dict[str, str],
                 origin: Optional[str] = None) -> Dict[str, str]:
    """Adopt peer-learned rows onto this process's overlay (the gossip
    ingress the service's ``POST /v1/routes/learned`` calls, A5.6.6).
    No plane, or a plane without learning, ignores the push — a process
    that did not opt into learned routing never changes behaviour on a
    peer's say-so."""
    with _LOCK:
        plane = _PLANE
    if plane is None or plane.learner is None:
        return {}
    return plane.learner.adopt(rows, source="gossip", origin=origin)


def render_metric_lines() -> List[str]:
    with _LOCK:
        plane = _PLANE
    return plane.render_metric_lines() if plane is not None else []


__all__ = [
    "MODES",
    "OnlineRouteRegistry",
    "RegretLedger",
    "RoutePlane",
    "ShadowSampler",
    "StalenessWatcher",
    "active_plane",
    "adopt_remote",
    "render_metric_lines",
    "resolve_mode",
    "start_plane",
    "stop_plane",
]
