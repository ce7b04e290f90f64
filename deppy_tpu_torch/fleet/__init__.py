"""Warm-state handoff (counterpart: ``deppy_tpu/fleet/__init__.py``).

The pieces of the reference's replica fleet that the session tier
(:mod:`deppy_tpu_torch.sessions`) stands on:

  * :mod:`.ring` — :func:`affinity_key`, the family key over a
    problem's ordered variable identifiers;
  * :mod:`.snapshot` — versioned, checksummed serialization of a
    scheduler's warm tier (clause-set index entries, exact-cache SAT
    seeds) and, optionally, its live sessions, so a fresh scheduler
    inherits them.

The router, membership, policy, the hash ring and ``split_snapshot``
come with ROADMAP A5.6.7: the reference's ``__init__`` imports the
router, which imports the service, so this one exports only the
handoff surface until then.
"""

from .ring import affinity_key
from .snapshot import (SNAPSHOT_VERSION, SnapshotFormatError,
                       export_warm_state, import_warm_state,
                       verify_snapshot)

__all__ = [
    "SNAPSHOT_VERSION",
    "SnapshotFormatError",
    "affinity_key",
    "export_warm_state",
    "import_warm_state",
    "verify_snapshot",
]
