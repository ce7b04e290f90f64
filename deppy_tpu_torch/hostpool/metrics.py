"""The hostpool metric families (copy of ``deppy_tpu/hostpool/metrics.py``).

Every family the worker pool touches is declared here once (name,
kind, help) and accessed through the helpers, so the help text cannot
drift between the incrementing site and an exposition
(:func:`render_metric_lines`).

All families live on :func:`deppy_tpu_torch.telemetry.default_registry` — the
pool is process-global (one host, one pool), like the fault layer's
breaker counters.  The helpers re-fetch the family from the *current*
default registry on every call instead of caching the family object, so
tests that swap the registry (``set_default_registry``) observe pool
activity on their own registry.
"""

from __future__ import annotations

# name -> help, in exposition order.
GAUGES = {
    "deppy_hostpool_queue_depth":
        "Lanes waiting for a host-pool worker right now.",
    "deppy_hostpool_busy_workers":
        "Host-pool workers currently solving a lane.",
    "deppy_hostpool_workers":
        "Host-engine worker processes alive in the pool.",
}

COUNTERS = {
    "deppy_hostpool_dispatches_total":
        "Batches dispatched through the host worker pool.",
    "deppy_hostpool_lanes_total":
        "Lanes solved by host-pool workers.",
    "deppy_hostpool_worker_crashes_total":
        "Host-pool workers that died mid-solve (lane retried on a "
        "fresh worker).",
    "deppy_hostpool_worker_recycles_total":
        "Host-pool workers retired after their solve-count limit and "
        "replaced.",
    "deppy_hostpool_inline_fallback_total":
        "Host-path batches solved by the inline engine because the "
        "pool was unavailable or its dispatch failed.",
}

HISTOGRAMS = {
    "deppy_hostpool_worker_solve_seconds":
        "Worker-side wall clock per pool-solved lane.",
}

FAMILY_ORDER = (*GAUGES, *COUNTERS, *HISTOGRAMS)


def gauge(name: str):
    from .. import telemetry

    return telemetry.default_registry().gauge(name, GAUGES[name])


def counter(name: str):
    from .. import telemetry

    return telemetry.default_registry().counter(name, COUNTERS[name])


def histogram(name: str):
    from .. import telemetry

    return telemetry.default_registry().histogram(name, HISTOGRAMS[name])


def render_metric_lines() -> list:
    """Prometheus exposition lines for every hostpool family.  Families
    register at zero on first render so a scrape shows the whole table
    before the pool's first dispatch (gauges default to 0 only while
    unset — a live value is never stomped)."""
    from .. import telemetry

    for name in GAUGES:
        g = gauge(name)
        if g.value is None:
            g.set(0)
    for name in COUNTERS:
        counter(name)
    for name in HISTOGRAMS:
        histogram(name)
    return telemetry.default_registry().render_families(list(FAMILY_ORDER))
