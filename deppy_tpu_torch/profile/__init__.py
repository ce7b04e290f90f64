"""Engine cost profiler and per-tenant SLO accounting (counterpart: ``deppy_tpu/profile/__init__.py:1-65``).

  * **ledger** — the per-dispatch trip ledger: trips against per-lane
    useful work, the straggler distribution, pad waste per size class
    and per-backend cost attribution, sampled at a declared rate
    (``DEPPY_GPU_PROFILE`` / ``DEPPY_GPU_PROFILE_SAMPLE``).  Disarmed,
    it is one cached bool check per dispatch and emits nothing.
    Sampled dispatches emit ``profile`` events into the JSONL sink
    (stamped onto the active trace), update the ``deppy_profile_*``
    families, and fill the :class:`~deppy_tpu_torch.telemetry.SolveReport`
    ledger fields.  Its call sites are the driver's dispatch
    (``device``) and host fallback (``hostpool``) and the scheduler's
    host drain (``host``) and warm flush (``warm``).
  * **slo** — per-tenant SLO accounting: a declarative SLO config
    (``DEPPY_GPU_SLO``), per-tenant request, latency and deadline-miss
    counters and burn-rate gauges.
  * **report** — :func:`report.summarize` reads a sink back into the
    cost model; :func:`report.render_text` prints it.
"""

from .ledger import (
    DEFAULT_TENANT,
    PROFILE_FAMILIES,
    armed,
    configure,
    dispatch_t0,
    override,
    record_backend_flush,
    record_device_dispatch,
    render_metric_lines,
    sample_rate,
)
from .slo import (SLOAccountant, SLOConfig, sanitize_replica,
                  sanitize_tenant, slo_config_from_env)

__all__ = [
    "DEFAULT_TENANT",
    "PROFILE_FAMILIES",
    "SLOAccountant",
    "SLOConfig",
    "render_metric_lines",
    "armed",
    "configure",
    "dispatch_t0",
    "override",
    "record_backend_flush",
    "record_device_dispatch",
    "sample_rate",
    "sanitize_replica",
    "sanitize_tenant",
    "slo_config_from_env",
]
