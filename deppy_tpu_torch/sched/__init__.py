"""Cross-request continuous batching (counterpart: ``deppy_tpu/sched/__init__.py``).

  * **scheduler** — :class:`Scheduler`: a size-class-aware micro-batch
    queue (the driver's cost proxies, so a giant catalog never inflates
    a burst of tiny ones) with a max-wait / max-fill flush policy,
    drained by one dispatch-loop thread into coalesced
    ``driver.solve_problems`` calls.  Each request's deadline rides on
    its lanes; an expired lane degrades to ``Incomplete`` without
    poisoning its coalesced batchmates.  Weighted-fair per-tenant
    admission and priority lanes come from :mod:`.fair`.
  * **cache** — :class:`ResultCache` + :func:`fingerprint`: problems are
    fingerprinted after encoding; hits bypass the queue entirely, entries
    are invalidated on budget escalation, and hit/miss/evict counters
    land in telemetry.  An exact miss consults the incremental tier's
    clause-set index (:meth:`ResultCache.lookup_or_plan`), whose warm
    plans the scheduler serves in their own size class.

Metric families (on the scheduler's registry): ``deppy_sched_queue_depth``,
``deppy_sched_coalesced_batch_size``, ``deppy_sched_dispatches_total``,
``deppy_sched_coalesced_requests_total``, ``deppy_sched_flushes_total``,
``deppy_sched_tenant_sheds_total``, ``deppy_cache_hit_ratio`` and the
``deppy_cache_*`` counters and gauges.
"""

from .cache import ResultCache, fingerprint
from .scheduler import Scheduler

__all__ = [
    "ResultCache",
    "Scheduler",
    "fingerprint",
]
