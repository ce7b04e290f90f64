"""Engine-backend registry (port of ``deppy_tpu/engine/registry.py:1-343``).

Every engine path registers a :class:`BackendSpec` (capabilities:
size-class range, cardinality support, warm-start support, whether it
can decide ANY instance) plus a per-class cost estimate, and a uniform
:func:`solve_via` adapter that renders every backend's answers in the
one lane vocabulary (:class:`~deppy_tpu_torch.hostpool.worker.HostLaneResult`)
the scheduler's host drain already decodes.  The backends: the batched
driver on the card (``device``), the inline host engine (``host``), the
host worker pool (``hostpool``), the gradient-relaxation entrant
(``grad_relax``) and the incremental tier's certified warm starts
(``warm``, whose lanes are :class:`deppy_tpu_torch.incremental.WarmPlan`
objects; :func:`candidates` never races it).

The portfolio racer (:class:`deppy_tpu_torch.sched.scheduler.PortfolioRacer`)
consumes this surface: :func:`candidates` ranks the backends for a size
class — by a learned-route overlay row (:func:`set_route_overlay`, the
route plane's learner) or else the measured-defaults registry's
``portfolio.<class>`` / ``portfolio`` rows for the device's platform
when one was measured (:mod:`.defaults`), else by the static
canonical-first order — and the racer dispatches the top K
concurrently.

Answer identity: the host engine is the executable spec and the device
engine is pinned bit-identical to it (models, unsat cores), so any
definitive backend's answers are interchangeable; the grad entrant
serves only what its certification proves identical.  Step counts are
engine-relative.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import size_classes as _size_classes
from ..hostpool.worker import HostLaneResult
from . import defaults

_CLASS_NAMES = tuple(name for name, _ in _size_classes.ordered_classes())


@dataclass(frozen=True)
class BackendSpec:
    """One registered engine backend.

    ``classes``: ladder classes the backend serves.  ``definitive``:
    whether the backend can decide ANY instance it accepts (the grad
    entrant cannot — unverified lanes come back None and the racer
    treats its result as non-definitive).  ``cost_us``: rough per-lane
    µs-per-solve by class — the ranking fallback when no measured
    ``portfolio`` row exists, and the straggler-triage estimate's
    floor.  Measured rows override the ordering entirely."""

    name: str
    classes: Tuple[str, ...]
    cardinality: bool
    warm_start: bool
    definitive: bool
    cost_us: Dict[str, float]
    # Signed objective-bound support: whether the backend can search
    # under a mixed-sign weighted bound.  All-nonnegative bounds lower
    # to plain AtMost cardinality and need only ``cardinality``.
    bound_weights: bool = False


# cost_us: per-lane µs by class, each lane one of a batch.  Measured by
# chip_smoke.py's race phase (its `race cost` lines: 64 pinned_tenant
# states for xs, 64 gvk_fleet states for s, 8 chains of depth 192 for m
# and of depth 768 for l), each the median of 5 warm calls (3 for the
# host engine on m), on an NVIDIA H100 80GB HBM3 at 700.00 W with 8 pool
# workers: device xs-l, host and hostpool xs-m.  A class whose batch is
# heavier per lane can cost more than a larger class (xs here: mostly
# UNSAT states with cores).  Unmeasured: device xl (the phase reaches no
# xl batch) and host and hostpool l and xl (the host engine takes tens of
# seconds a lane on the l chains) hold the largest measured class's
# value, a floor.  warm: chip_smoke.py's incremental phase (its
# `incremental cost` lines: the 95 warm plans of the churn replay for m,
# the 17 of pinned_tenant states the burst planned for xs), each the
# median of 5 calls after one untimed call, on the same card; s, l and
# xl, which its plans do not reach, hold m's value, their largest
# measured neighbour.  grad_relax keeps the reference's TPU-era anchors
# in every class.
_SPECS: Dict[str, BackendSpec] = {
    spec.name: spec
    for spec in (
        BackendSpec("device", _CLASS_NAMES, cardinality=True,
                    warm_start=False, definitive=True,
                    cost_us={"xs": 186.5, "s": 133.5, "m": 964.2,
                             "l": 49429.8,
                             "xl": 49429.8}),      # xl unmeasured: l's
        BackendSpec("host", _CLASS_NAMES, cardinality=True,
                    warm_start=True, definitive=True,
                    cost_us={"xs": 10551.7, "s": 4292.9, "m": 954430.8,
                             "l": 954430.8,        # unmeasured: m's
                             "xl": 954430.8},      # unmeasured: m's
                    bound_weights=True),
        BackendSpec("hostpool", _CLASS_NAMES, cardinality=True,
                    warm_start=False, definitive=True,
                    cost_us={"xs": 2121.1, "s": 1038.7, "m": 162823.6,
                             "l": 162823.6,        # unmeasured: m's
                             "xl": 162823.6}),     # unmeasured: m's
        BackendSpec("warm", _CLASS_NAMES, cardinality=True,
                    warm_start=True, definitive=False,
                    cost_us={"xs": 262.4, "s": 1893.2,   # s unmeasured: m's
                             "m": 1893.2,
                             "l": 1893.2,         # unmeasured: m's
                             "xl": 1893.2}),      # unmeasured: m's
        BackendSpec("grad_relax", _CLASS_NAMES, cardinality=True,
                    warm_start=False, definitive=False,
                    cost_us={"xs": 250.0, "s": 500.0, "m": 1500.0,
                             "l": 5000.0, "xl": 10000.0}),  # unmeasured
    )
}

# Canonical-first static ranking: without measured evidence the racer
# must keep the canonical winner cheap — the device engine leads (it is
# what racing-off dispatches), the cancellable inline host engine is
# the default second lane, the certified heuristic third, the
# (abandon-only, pool-lock-holding) hostpool last.
_STATIC_ORDER = ("device", "host", "grad_relax", "hostpool")


def specs() -> Dict[str, BackendSpec]:
    """The registered backends (read-only view by convention)."""
    return dict(_SPECS)


def get(name: str) -> BackendSpec:
    return _SPECS[name]


def estimate_us(name: str, class_name: str) -> float:
    """Per-lane cost estimate for one backend in one ladder class."""
    spec = _SPECS[name]
    return spec.cost_us.get(class_name,
                            max(spec.cost_us.values()))


# The learned-route overlay (registry.py:123-153): in-memory ranking
# rows adopted by the online route registry (:mod:`deppy_tpu_torch.routes.
# learn`), consulted ahead of the measured-defaults file so a serving
# process can adopt a live-learned row without mutating the registry
# file mid-serve.  A learned row can only reorder WHICH definitive
# backends race — the racer's first-definitive-winner rule and sampled
# cross-check still gate every answer, so adoption changes speed, never
# answers.  Empty (the default, and always with the route plane off)
# leaves ranked() as it was.  Rows are kept per platform of the device
# they were learned on (``{platform: {key: row}}``): one process may
# serve a card scheduler and a CPU one, and a row measured on one must
# not reorder the other's race.
_ROUTE_OVERLAY: Dict[str, Dict[str, str]] = {}


def set_route_overlay(rows: Optional[Dict[str, str]],
                      device="cuda") -> None:
    """Replace ``device``'s platform's learned-route overlay: ``{key:
    comma-separated row}`` under the keys :func:`ranked` reads
    (``portfolio.<class>``, ``portfolio``).  None or {} clears it."""
    global _ROUTE_OVERLAY
    _ROUTE_OVERLAY = {**_ROUTE_OVERLAY,
                      defaults.platform_of(device): dict(rows or {})}


def update_route_overlay(rows: Dict[str, str], device="cuda") -> None:
    """Merge rows into ``device``'s platform's learned-route overlay (an
    atomic swap: the racer may be reading concurrently)."""
    global _ROUTE_OVERLAY
    platform = defaults.platform_of(device)
    _ROUTE_OVERLAY = {**_ROUTE_OVERLAY,
                      platform: {**_ROUTE_OVERLAY.get(platform, {}), **rows}}


def route_overlay(device="cuda") -> Dict[str, str]:
    return dict(_ROUTE_OVERLAY.get(defaults.platform_of(device), {}))


def ranked(class_name: str, device="cuda") -> Tuple[List[str], bool]:
    """Candidate backend names for a size class, best first, plus
    whether the order came from a MEASURED ``portfolio`` row (the
    ``auto`` racing mode engages only then).  Rows are comma-separated
    backend names under the measured-defaults keys
    ``portfolio.<class>`` (per class) or ``portfolio`` (global) of
    ``device``'s platform; a learned-route overlay row of that platform
    takes precedence and counts as measured (it is a measurement, just a fresher one)."""
    overlay = _ROUTE_OVERLAY.get(defaults.platform_of(device), {})
    for key in (f"portfolio.{class_name}", "portfolio"):
        row = overlay.get(key) or defaults.measured_default(key, device)
        if row:
            names = [n.strip() for n in row.split(",")
                     if n.strip() in _SPECS]
            if len(names) >= 2:
                return names, True
    return list(_STATIC_ORDER), False


def candidates(class_name: str, k: int, device_ok: bool = True,
               pool_ok: Optional[bool] = None,
               cardinality: bool = False,
               device="cuda") -> Tuple[List[str], bool]:
    """Top-K raceable backends for one flush: the ranked order filtered
    by capability (class served, cardinality when the flush carries
    AtMost rows) and availability (``device_ok`` — the scheduler's
    backend; ``pool_ok`` — hostpool spawnability, probed lazily when
    None).  The warm screen never races."""
    names, measured = ranked(class_name, device)
    out: List[str] = []
    for name in names:
        spec = _SPECS.get(name)
        if spec is None or spec.name == "warm":
            continue
        if class_name not in spec.classes:
            continue
        if cardinality and not spec.cardinality:
            continue
        if name == "device" and not device_ok:
            continue
        if name == "hostpool":
            if pool_ok is None:
                from .. import hostpool

                pool = hostpool.default_pool()
                pool_ok = pool is not None and pool.available
            if not pool_ok:
                continue
        out.append(name)
        if len(out) >= max(int(k), 2):
            break
    return out, measured


def optimize_candidates(class_name: str, k: int = 2,
                        signed: bool = False,
                        device_ok: bool = True,
                        pool_ok: Optional[bool] = None,
                        device="cuda") -> Tuple[List[str], bool]:
    """Raceable backends for one bound probe: definitive backends only
    (a probe's UNSAT at the tightened bound is an optimality proof, so
    a backend that can fail to decide an instance it accepts must never
    answer one).  ``signed`` probes (mixed-sign weights) further require
    ``bound_weights``."""
    names, measured = candidates(class_name, k=len(_SPECS),
                                 device_ok=device_ok, pool_ok=pool_ok,
                                 cardinality=True, device=device)
    out = [n for n in names
           if _SPECS[n].definitive
           and (not signed or _SPECS[n].bound_weights)]
    return out[: max(int(k), 1)], measured


# ------------------------------------------------------------- adapters
#
# One lane vocabulary for every backend: HostLaneResult — the shape the
# hostpool workers already emit and the scheduler's host drain already
# decodes, so racing cannot invent a second decode path to drift.


def _from_solve_result(problem, res) -> HostLaneResult:
    """Render one device :class:`core.SolveResult` in the lane
    vocabulary.  Index lists are in ascending index order — exactly the
    order ``driver.decode_results`` walks, so the decoded answers are
    byte-identical."""
    from . import core

    o = int(res.outcome)
    if o == core.SAT:
        idx = np.nonzero(np.asarray(res.installed)[: problem.n_vars])[0]
        return HostLaneResult("sat", [int(i) for i in idx], [],
                              int(res.steps),
                              backtracks=int(res.trace_n))
    if o == core.UNSAT:
        idx = np.nonzero(np.asarray(res.core)[: problem.n_cons])[0]
        return HostLaneResult("unsat", [], [int(i) for i in idx],
                              int(res.steps),
                              backtracks=int(res.trace_n))
    return HostLaneResult("incomplete", [], [], int(res.steps),
                          backtracks=int(res.trace_n))


def _solve_device(problems, max_steps, deadlines, cancel, mesh=None,
                  device="cuda"):
    """Batched dispatch through the driver on ``device`` (the CUDA
    kernels on the card), or sharded over ``mesh``'s slots when it has
    two or more (registry.py:261-273).  A launched kernel cannot be
    cooperatively cancelled — a losing race lane runs to completion and
    its fetch is dropped."""
    from . import driver

    if mesh is not None and mesh.size >= 2:
        results = driver.solve_problems_sharded(problems, mesh=mesh,
                                                max_steps=max_steps)
    else:
        results = driver.solve_problems(problems, max_steps=max_steps,
                                        device=device)
    return [_from_solve_result(p, r) for p, r in zip(problems, results)]


def _solve_host(problems, max_steps, deadlines, cancel, mesh=None,
                device="cuda"):
    """Inline host-engine lanes — the cancellable spelling (the race's
    cooperative stop flag is checked at every engine step boundary)."""
    from ..hostpool.worker import solve_lane

    n = len(problems)
    dls = list(deadlines) if deadlines is not None else [None] * n
    per = (list(max_steps) if isinstance(max_steps, (list, tuple))
           else [max_steps] * n)
    return [solve_lane(p, max_steps=ms, deadline=dl, cancel=cancel)
            for p, ms, dl in zip(problems, per, dls)]


def _solve_hostpool(problems, max_steps, deadlines, cancel, mesh=None,
                    device="cuda"):
    """The shared worker-pool entry.  No cross-process cancel flag —
    a losing pool entrant is abandoned (its results dropped) and its
    dispatch drains in the background."""
    from .. import hostpool

    return hostpool.solve_host_problems(problems, max_steps=max_steps,
                                        deadlines=deadlines)


def _solve_warm(plans, max_steps, deadlines, cancel, mesh=None,
                device="cuda"):
    """Certified warm-start attempts (registry.py:299-317) — ``plans``
    are WarmPlan objects, one per lane; None per lane on fallback.  They
    run on the host engine whatever ``device`` says, and ``attempt``
    already answers in the lane vocabulary."""
    from .. import incremental as inc

    return [inc.attempt(plan, max_steps) for plan in plans]


def _solve_grad(problems, max_steps, deadlines, cancel, mesh=None,
                device="cuda"):
    from . import grad_relax

    return grad_relax.solve_lanes(problems, max_steps=max_steps,
                                  deadlines=deadlines, cancel=cancel,
                                  device=device)


_SOLVERS = {
    "device": _solve_device,
    "host": _solve_host,
    "hostpool": _solve_hostpool,
    "warm": _solve_warm,
    "grad_relax": _solve_grad,
}


def solve_via(name: str, problems: Sequence,
              max_steps=None, deadlines: Optional[Sequence] = None,
              cancel=None, mesh=None, device="cuda"):
    """Dispatch one lane set through the named backend; ``device`` is
    where the device and grad_relax entrants run (``"cuda"`` by
    default).  Returns a list of :class:`HostLaneResult` (None per lane
    a non-definitive backend could not certify)."""
    return _SOLVERS[name](problems, max_steps, deadlines, cancel,
                          mesh=mesh, device=device)
