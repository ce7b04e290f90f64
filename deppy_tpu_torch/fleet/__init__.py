"""The replica fleet with warm-state affinity routing (counterpart:
``deppy_tpu/fleet/__init__.py``).

N port ``Server`` processes behave like one warm process:

  * :mod:`.ring` — a consistent-hash ring over replica addresses, keyed
    by the request's FAMILY affinity (:func:`affinity_key` over the
    ordered variable identifiers, which a family's churn deltas share),
    so a family's whole churn stream concentrates on the replica
    holding its warm seeds;
  * :mod:`.router` — the :class:`Router` front-end: the service's HTTP
    surface, ``/v1/resolve`` routed per problem over the ring, health
    probes, the publish and preview fan-out, session routing, the drain
    handoff, the fleet's metrics, status and telemetry endpoints;
  * :mod:`.snapshot` — versioned, integrity-checked serialization of a
    scheduler's warm tier (clause-set index entries, exact-cache SAT
    seeds and, optionally, live sessions), split by owner for a handoff;
  * :mod:`.membership` — runtime joins (chunked warm-state streaming,
    then an atomic arc flip), drain-as-leave epoch bumps and
    epoch-versioned peer gossip;
  * :mod:`.policy` — the per-tenant SLO burn rate turned into
    ``scale_up``/``scale_down``/``rebalance`` recommendations.
"""

from .membership import (join_replica, membership_mode,  # noqa: F401
                         membership_view, reconcile)
from .policy import decide as policy_decide  # noqa: F401
from .ring import HashRing, affinity_key, doc_affinity_keys  # noqa: F401
from .router import Router  # noqa: F401
from .snapshot import (SNAPSHOT_VERSION, SnapshotFormatError,  # noqa: F401
                       export_warm_state, import_warm_state,
                       verify_snapshot)

__all__ = [
    "HashRing",
    "Router",
    "SNAPSHOT_VERSION",
    "SnapshotFormatError",
    "affinity_key",
    "doc_affinity_keys",
    "export_warm_state",
    "import_warm_state",
    "join_replica",
    "membership_mode",
    "membership_view",
    "policy_decide",
    "reconcile",
    "verify_snapshot",
]
