"""The fault-domain metric families (copy of ``deppy_tpu/faults/metrics.py:1-47``).

Every counter the fault layer increments is declared here once (name,
help, optional label) and reached through :func:`fault_counter`, so the
help text cannot drift between the sites that increment it (the
driver's recovery wrapper, the breaker, the injection harness and the
deadline paths).
"""

from __future__ import annotations

from typing import Optional, Tuple

# name -> (help text, labelname or None), in exposition order.
FAMILIES: "dict[str, Tuple[str, Optional[str]]]" = {
    "deppy_breaker_transitions_total":
        ("Circuit-breaker state transitions.", "state"),
    "deppy_fault_failures_total":
        ("Device dispatch attempts that raised.", None),
    "deppy_fault_retries":
        ("Device dispatch attempts retried by the fault policy.", None),
    "deppy_fault_host_routed_total":
        ("Problems solved by the host engine because device dispatch "
         "failed or the breaker was open.", None),
    "deppy_deadline_exceeded":
        ("Dispatches and requests that ran past their deadline.", None),
    "deppy_faults_injected_total":
        ("Scripted faults fired by the injection harness.", "point"),
}

BREAKER_STATE_HELP = ("Accelerator circuit breaker: 0 closed, "
                      "1 half-open, 2 open (host-only).")


def fault_counter(name: str):
    """The named fault-domain counter on the default telemetry registry,
    registered from the :data:`FAMILIES` declaration on first use."""
    from .. import telemetry

    help_text, labelname = FAMILIES[name]
    return telemetry.default_registry().counter(name, help_text,
                                                labelname=labelname)
