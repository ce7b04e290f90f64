"""Warm-start execution (copy of ``deppy_tpu/incremental/warm.py:1-74``).

:func:`attempt` (``warm.py:31``) runs a planned warm start on the host
spec engine and reports either the served lane result or None — the
caller (the scheduler's incremental lane class, or any library user)
answers None with a cold solve through its normal backend path, so the
deadline triage and the cold path's error semantics apply unchanged to
every fallback.  Results are shaped as
:class:`deppy_tpu_torch.hostpool.worker.HostLaneResult`, the value
object every other host-path consumer decodes.

:func:`screen` (``warm.py:55``) is the batched DEVICE variant: the
assignment of each lane is initialized from its cached model (off-cone
values pinned, cone left open, activations true) and one elementwise
pass (:func:`deppy_tpu_torch.engine.driver.warm_screen`) flags lanes
whose warm prefix already conflicts — those lanes skip the host warm
attempt entirely and cold-solve with their batchmates.  The screen is a
router: the authoritative certification stays in
``HostEngine.solve_warm``.

One departure from the reference: on ``device="cuda"`` a screen error
propagates to the caller (through the scheduler, into the dispatch and
to every coalesced submitter), where the reference turns any error into
all-True (``warm.py:69-74``).  The reference can route around a device
that cannot build or launch with its breaker; the port has none yet, so
swallowing the error would hide a broken card behind host warm attempts,
as a raising device entrant of the portfolio race would.  ROADMAP A7.1
re-decides this together with the race's device entrant.  On
``device="cpu"`` the reference's behaviour stands: a ``fault`` event
``incremental_screen_failed`` naming the error, then all-True.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from ..hostpool.worker import HostLaneResult
from .clauseset import WarmPlan


def attempt(plan: WarmPlan,
            max_steps: Optional[int] = None) -> Optional[HostLaneResult]:
    """Run one warm-started solve.  Returns the lane result on a served
    warm start, or None when the attempt fell back (warm prefix
    conflict, cone backtrack, budget exhaustion mid-warm) — the caller
    cold-solves.  ``InternalSolverError`` propagates: a malformed
    problem is an error either way."""
    from ..sat.errors import Incomplete
    from ..sat.host import HostEngine, WarmStartConflict

    eng = HostEngine(plan.problem, max_steps=max_steps)
    t0 = time.perf_counter()
    try:
        _, installed_idx = eng.solve_warm(plan.warm_assign, plan.cone)
    except (WarmStartConflict, Incomplete):
        # Fallback is control flow, not failure: the cold path answers.
        return None
    return HostLaneResult(
        "sat", list(installed_idx), [], eng.steps, eng.decisions,
        eng.propagation_rounds, eng.backtracks,
        time.perf_counter() - t0,
    )


def screen(plans: Sequence[WarmPlan], device="cuda") -> List[bool]:
    """Batched warm-prefix screen over one warm lane class on
    ``device``.  ``True`` means the prefix survived the check and the
    host warm attempt is worth paying; ``False`` routes the lane
    straight to the cold path.  On the card any error propagates (see
    the module docstring); on the CPU it degrades to all-True — the
    host attempt re-checks authoritatively."""
    import torch

    from .. import telemetry
    from ..engine import driver

    args = ([p.problem for p in plans], [p.warm_assign > 0 for p in plans],
            [p.cone for p in plans])
    if torch.device(device).type != "cpu":
        return [bool(v) for v in driver.warm_screen(*args, device=device)]
    try:
        ok = driver.warm_screen(*args, device=device)
        return [bool(v) for v in ok]
    except Exception as e:  # noqa: BLE001 — router only; host re-checks
        telemetry.default_registry().event(
            "fault", fault="incremental_screen_failed",
            error=type(e).__name__, lanes=len(plans))
        return [True] * len(plans)
