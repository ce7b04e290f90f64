"""The host path's inline solve (copy of ``deppy_tpu/hostpool/pool.py:580-616``).

The reference's host-path consumers call ``solve_host_problems``, which
sends a batch to its worker-process pool when one is available and
solves inline otherwise, bit-identically either way.  The port has no
pool yet, so its consumers (the scheduler's ``backend="host"`` drain and
``BatchResolver``'s host batch) call :func:`solve_inline` directly;
ROADMAP A5.3 brings the pool and ``solve_host_problems`` with it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from .worker import HostLaneResult, solve_lane


def solve_inline(problems: Sequence,
                 max_steps: Union[int, Sequence[Optional[int]], None] = None,
                 deadlines: Optional[Sequence] = None) -> List[HostLaneResult]:
    """The serial path: :func:`solve_lane` in-process, in order.
    Per-lane deadline triage before each solve reproduces the host
    loop's "break at expiry, degrade the remainder" semantics exactly (a
    shared deadline that expires mid-batch fails every later lane's
    triage)."""
    n = len(problems)
    per_lane_steps = (list(max_steps)
                      if isinstance(max_steps, (list, tuple))
                      else [max_steps] * n)
    dls = list(deadlines) if deadlines is not None else [None] * n
    return [solve_lane(p, max_steps=s, deadline=d)
            for p, s, d in zip(problems, per_lane_steps, dls)]
