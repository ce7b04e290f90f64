"""The family affinity key (copy of ``deppy_tpu/fleet/ring.py:34-49``).

Warm state is FAMILY-scoped: the clause-set index buckets entries by
decode vocabulary (:func:`deppy_tpu_torch.incremental.clauseset.vocab_key`),
and a catalog churn delta keeps the family's variable identifiers while
changing its constraints.  The affinity key therefore hashes the ORDERED
variable-identifier list: identical for every delta of a family,
distinct across families, and computable from the request document
alone.  A session's key (:class:`deppy_tpu_torch.sessions.Session`) and
every entry of a warm-state snapshot (:mod:`.snapshot`) carry it, so the
same keys route here as in the reference.

Brought across: ``_SEP`` and :func:`affinity_key`.  Left out until the
router is ported (ROADMAP A5.6.7): the consistent-hash ring
(``HashRing``, ``_point``) and ``doc_affinity_keys``.
"""

from __future__ import annotations

import hashlib
from typing import Iterable

# Identifier-list separator: matches the canonical fingerprint's vocab
# encoding (sched/cache.py) so no identifier ambiguity ("a" + "bc" vs
# "ab" + "c") can alias two families onto one key.
_SEP = "\x1f"


def affinity_key(identifiers: Iterable[str]) -> str:
    """The family affinity key: hex digest over the ORDERED variable
    identifiers.  Order matters — the decode vocabulary is ordered, and
    two requests naming the same ids in different orders render
    different responses (they are different families)."""
    h = hashlib.sha256(_SEP.join(str(i) for i in identifiers).encode())
    return h.hexdigest()
