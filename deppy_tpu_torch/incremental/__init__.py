"""Delta-aware incremental resolution (counterpart: ``deppy_tpu/incremental/__init__.py``).

Catalog churn re-asks 99%-identical problems; this package turns those
re-solves from full searches into near-lookups:

  * :mod:`.clauseset` — clause-level fingerprinting: a
    :class:`ClauseSetIndex` of solved problems keyed by per-row hashes
    plus the decode vocabulary, with a delta extractor classifying new
    requests as {identical, additive, retractive, mixed} and computing
    the touched cone (variables reachable from changed rows through
    shared literals), and the O(delta) ``scoped`` planner a session's
    declared assumption delta takes;
  * :mod:`.warm` — warm-start execution: seed the assignment from the
    cached model outside the cone, re-solve the cone only
    (``HostEngine.solve_warm``), fall back to a cold solve whenever
    byte-identity cannot be certified; plus the batched device prefix
    screen.

The scheduler (:mod:`deppy_tpu_torch.sched`) wires the index in front of
its exact-fingerprint result cache and drains warm lanes as their own
"incremental" size class; ``DEPPY_GPU_INCREMENTAL=off`` removes the tier
entirely.
"""

from .clauseset import (  # noqa: F401
    DELTA_ADDITIVE,
    DELTA_IDENTICAL,
    DELTA_MIXED,
    DELTA_RETRACTIVE,
    DELTA_SCOPED,
    ClauseSetIndex,
    WarmPlan,
    problem_rows,
    touched_cone,
    vocab_key,
)
from .warm import attempt, screen  # noqa: F401
