"""Speculative pre-resolution (counterpart: ``deppy_tpu/speculate/__init__.py:1-36``).

Production churn is push-shaped: one catalog publish fans out to
thousands of dependent clients who all re-ask within minutes, and the
first asker per clause-set family eats the cold solve while the card
sits mostly idle.  This package turns that slack into pre-solved
answers:

  * :mod:`.manager` — :class:`PublishDelta` (a parsed catalog publish:
    absolute per-bundle constraint updates and withdrawals) and
    :class:`SpeculationManager`, which retains recently served problem
    families, enumerates the cached fingerprints a publish touches via
    the :class:`deppy_tpu_torch.incremental.ClauseSetIndex` per-row
    keys, applies the delta to each retained family, and pre-solves the
    results through the scheduler's **idle-priority queue** — drained
    only when no live lane is queued, preempted by live traffic at every
    flush boundary.  Results land in the exact result cache and the
    delta index like ordinary solves, so under sustained publish+query
    load the churn p99 becomes a cache lookup.
  * The same machinery exposed read-only is the **what-if tier**
    (:meth:`SpeculationManager.preview`): resolve a *proposed* catalog
    change against the live index without serving or caching it.

``Scheduler(speculate="off")`` (or ``DEPPY_GPU_SPECULATE=off``)
constructs none of this.  The service endpoints
(``/v1/catalog/publish``, ``/v1/resolve/preview``) come with ROADMAP
A5.6.6, the ``publish`` CLI with A7.2.
"""

from .manager import (  # noqa: F401
    PublishDelta,
    PublishFormatError,
    SpeculationManager,
)
