"""The fault-domain layer (counterpart: ``deppy_tpu/faults/__init__.py``).

Two of the reference's three pieces, which the request scheduler
(:mod:`deppy_tpu_torch.sched`) stands on:

  * **policy** — :class:`Deadline` (wall-clock budgets per batch,
    carried on a thread-local scope), with
    :func:`ambient_deadline` (``DEPPY_GPU_BATCH_DEADLINE_S``) and the
    ``deppy_deadline_exceeded`` counter;
  * **inject** — the deterministic fault-injection harness
    (``DEPPY_GPU_FAULT_PLAN``): named fault points raise or stall on a
    scripted schedule so every recovery path runs on the CPU.

The circuit breaker (``faults/breaker.py``), the retry policy and the
driver's recovery wrapper that reads it come with ROADMAP A7; until then
a failed dispatch raises to its callers.
"""

from .inject import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    configure_plan,
    current_plan,
    inject,
    plan_from_env,
    plan_from_spec,
)
from .metrics import FAMILIES, fault_counter
from .policy import (
    Deadline,
    DeadlineExceeded,
    ambient_deadline,
    current_deadline,
    deadline_scope,
    env_float,
    note_deadline_exceeded,
)

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "FAMILIES",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "ambient_deadline",
    "configure_plan",
    "current_deadline",
    "current_plan",
    "deadline_scope",
    "env_float",
    "fault_counter",
    "inject",
    "note_deadline_exceeded",
    "plan_from_env",
    "plan_from_spec",
]
