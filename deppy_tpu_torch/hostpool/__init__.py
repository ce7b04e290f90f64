"""Host-engine serving (counterpart: ``deppy_tpu/hostpool/__init__.py``).

Every host-path consumer calls :func:`solve_host_problems`: the
``Solver``'s host lane, ``BatchResolver``'s host batch, the scheduler's
host drain, its straggler triage and the racer's ``hostpool`` entrant.
It sends a batch to the forkserver-backed worker pool
(:class:`HostPool`, sized by ``DEPPY_GPU_HOST_WORKERS``, default
``min(cpu_count, 8)``; 0 disables it) when one is available and the
batch has more than one lane, and solves inline (:func:`solve_inline`)
otherwise — bit-identically either way, because the workers and the
inline path run the one :func:`solve_lane`.  A lane reports a
:class:`HostLaneResult` (models and unsat cores as index lists, the
engine's counters, and whether a deadline degraded it), which
:func:`count_lane` folds into a report and :func:`lane_answer` decodes.

Worker crashes retry on a fresh worker, workers recycle after
``DEPPY_GPU_HOST_WORKER_RECYCLE`` solves, per-lane deadlines cancel only
the expired lane, the ``hostpool.dispatch`` and ``hostpool.worker_crash``
fault points script pool failures, and a pool that cannot start
degrades to the inline engine loudly
(``deppy_hostpool_inline_fallback_total`` and a ``fault`` event).  The
metric families are ``deppy_hostpool_*`` (:mod:`.metrics`).
"""

from .metrics import FAMILY_ORDER, render_metric_lines
from .pool import (
    HostPool,
    HostPoolError,
    configure_pool,
    default_pool,
    effective_workers,
    pool_workers,
    shutdown_default_pool,
    solve_host_problems,
    solve_inline,
)
from .worker import HostLaneResult, count_lane, lane_answer, solve_lane

__all__ = [
    "FAMILY_ORDER",
    "HostLaneResult",
    "HostPool",
    "HostPoolError",
    "configure_pool",
    "count_lane",
    "default_pool",
    "effective_workers",
    "lane_answer",
    "pool_workers",
    "render_metric_lines",
    "shutdown_default_pool",
    "solve_host_problems",
    "solve_inline",
    "solve_lane",
]
