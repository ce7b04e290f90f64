"""The fault-domain layer (counterpart: ``deppy_tpu/faults/__init__.py``).

The reference's three pieces, which the engine driver, the resolution
facade and the request scheduler (:mod:`deppy_tpu_torch.sched`) stand on:

  * **policy** — :class:`RetryPolicy` (exponential backoff and jitter for
    failed device dispatches; ``DEPPY_GPU_FAULT_RETRIES``,
    ``DEPPY_GPU_FAULT_BACKOFF_S``, ``DEPPY_GPU_FAULT_BACKOFF_MAX_S``,
    ``DEPPY_GPU_CHUNK_DEADLINE_S``) and :class:`Deadline` (wall-clock
    budgets per batch, carried on a thread-local scope), with
    :func:`ambient_deadline` (``DEPPY_GPU_BATCH_DEADLINE_S``) and the
    ``deppy_deadline_exceeded`` counter;
  * **breaker** — the card's :class:`CircuitBreaker`: N consecutive
    device failures trip the whole process to host-only solving, a
    cooldown later one half-open probe dispatch decides whether to close
    it again (``DEPPY_GPU_BREAKER_THRESHOLD``,
    ``DEPPY_GPU_BREAKER_RESET_S``);
  * **inject** — the deterministic fault-injection harness
    (``DEPPY_GPU_FAULT_PLAN``): named fault points raise or stall on a
    scripted schedule so every recovery path runs on the CPU.

The families (``deppy_fault_retries``, ``deppy_fault_failures_total``,
``deppy_fault_host_routed_total``, ``deppy_breaker_state``,
``deppy_deadline_exceeded``, ...) live on
:func:`deppy_tpu_torch.telemetry.default_registry`, beside ``fault`` and
``breaker`` events.  The per-device breakers wait for the mesh (ROADMAP
A6) and ``render_metric_lines`` for the service (A5.6.6).
"""

from .breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    default_breaker,
    set_default_breaker,
)
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
    RetryPolicy,
    ambient_deadline,
    current_deadline,
    deadline_scope,
    env_float,
    note_deadline_exceeded,
)

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
    "FAMILIES",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "RetryPolicy",
    "ambient_deadline",
    "configure_plan",
    "current_deadline",
    "current_plan",
    "deadline_scope",
    "default_breaker",
    "env_float",
    "fault_counter",
    "inject",
    "note_deadline_exceeded",
    "plan_from_env",
    "plan_from_spec",
    "set_default_breaker",
]
