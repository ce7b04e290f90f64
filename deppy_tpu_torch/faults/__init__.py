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
``breaker`` events; :func:`render_metric_lines` renders them for the
service's ``/metrics`` (``deppy_tpu/faults/__init__.py:95-122``).  The
mesh's per-slot breakers (:func:`device_breaker`,
:class:`GatedDeviceBreaker`) add their labelled state lines there.
"""

from .breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    GatedDeviceBreaker,
    default_breaker,
    device_breaker,
    device_breakers,
    reset_device_breakers,
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
    env_int,
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
    "GatedDeviceBreaker",
    "InjectedFault",
    "RetryPolicy",
    "ambient_deadline",
    "configure_plan",
    "current_deadline",
    "current_plan",
    "deadline_scope",
    "default_breaker",
    "device_breaker",
    "device_breakers",
    "env_float",
    "env_int",
    "fault_counter",
    "inject",
    "note_deadline_exceeded",
    "plan_from_env",
    "plan_from_spec",
    "render_metric_lines",
    "reset_device_breakers",
    "set_default_breaker",
]


def render_metric_lines() -> list:
    """Prometheus exposition lines for every fault-domain family, for the
    service's ``Metrics.render`` to append (``faults/__init__.py:95-122``).
    Reads the process state, so every server in the process reports the
    one real breaker.  The breaker gauge is synthesized from the live
    breaker (always present, cooldown edge included); the counters
    render from their default-registry families, registered at zero when
    nothing has incremented them yet.  Each slot breaker of the mesh
    (:func:`device_breakers`) adds one labelled line,
    ``deppy_breaker_state{device="<slot>"}``, synthesized live like the
    process-wide gauge."""
    from .. import telemetry
    from .metrics import BREAKER_STATE_HELP

    lines = [
        f"# HELP deppy_breaker_state {BREAKER_STATE_HELP}",
        "# TYPE deppy_breaker_state gauge",
        f"deppy_breaker_state {default_breaker().state_code()}",
    ]
    for key, br in sorted(device_breakers().items()):
        lines.append(f'deppy_breaker_state{{device="{key}"}} '
                     f"{br.state_code()}")
    for name in FAMILIES:
        fault_counter(name)  # ensure registered (zero) before rendering
    return lines + telemetry.default_registry().render_families(
        list(FAMILIES))
