"""Host-engine serving (counterpart: ``deppy_tpu/hostpool/__init__.py``).

:func:`solve_inline` is the host path's entry: every lane runs
:func:`solve_lane` on the port's :class:`~deppy_tpu_torch.sat.host.HostEngine`
and reports a :class:`HostLaneResult` (models and unsat cores as index
lists, the engine's counters, and whether a deadline degraded it), which
:func:`count_lane` folds into a report and :func:`lane_answer` decodes.
The reference's forkserver worker pool, and ``solve_host_problems``
that chooses between it and the inline path, are not ported yet
(ROADMAP A5.3); the reference documents the inline path as
bit-identical to its pool.
"""

from .pool import solve_inline
from .worker import HostLaneResult, count_lane, lane_answer, solve_lane

__all__ = [
    "HostLaneResult",
    "count_lane",
    "lane_answer",
    "solve_inline",
    "solve_lane",
]
