"""The consistent-hash affinity ring (copy of ``deppy_tpu/fleet/ring.py:1-119``).

**Affinity key.**  Warm state is FAMILY-scoped: the clause-set index
buckets entries by decode vocabulary
(:func:`deppy_tpu_torch.incremental.clauseset.vocab_key`), and a catalog
churn delta keeps the family's variable identifiers while changing its
constraints.  The affinity key therefore hashes the ORDERED
variable-identifier list: identical for every delta of a family,
distinct across families, and computable from the request document
alone (no encode on the router's hot path).  A session's key
(:class:`deppy_tpu_torch.sessions.Session`) and every entry of a
warm-state snapshot (:mod:`.snapshot`) carry it, so the same keys route
here as in the reference.

**Ring.**  Each replica owns ``vnodes`` points on a 64-bit ring (sha256
of ``"replica#i"``); a key routes to the first point clockwise from its
own hash.  Removing a replica (death, drain) reassigns only its arcs —
every other family keeps its replica, which is what preserves the
fleet's warm tier under membership churn.  ``route(key, exclude=...)``
walks past excluded owners, so the retry and handoff successor of a key
is its route with the failed replica excluded.  The points are the
reference's, so a port router and a reference router over the same
addresses route every key alike.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, List, Optional, Sequence, Tuple

DEFAULT_VNODES = 64

# Identifier-list separator: matches the canonical fingerprint's vocab
# encoding (sched/cache.py) so no identifier ambiguity ("a" + "bc" vs
# "ab" + "c") can alias two families onto one key.
_SEP = "\x1f"


def _point(token: str) -> int:
    return int.from_bytes(
        hashlib.sha256(token.encode()).digest()[:8], "big")


def affinity_key(identifiers: Iterable[str]) -> str:
    """The family affinity key: hex digest over the ORDERED variable
    identifiers.  Order matters — the decode vocabulary is ordered, and
    two requests naming the same ids in different orders render
    different responses (they are different families)."""
    h = hashlib.sha256(_SEP.join(str(i) for i in identifiers).encode())
    return h.hexdigest()


def doc_affinity_keys(doc) -> List[Optional[str]]:
    """Per-problem affinity keys of one ``/v1/resolve`` document
    (``{"variables": [...]}`` or ``{"problems": [...]}``), WITHOUT
    encoding: just the ``id`` fields in order.  A problem too malformed
    to name its ids keys ``None`` — the router still forwards it (to
    the ring's default arc) and the replica renders the same 400 a
    single server would."""
    if not isinstance(doc, dict):
        return [None]
    raw = doc.get("problems") if "problems" in doc else [doc]
    if not isinstance(raw, list):
        return [None]
    out: List[Optional[str]] = []
    for p in raw:
        try:
            out.append(affinity_key(v["id"] for v in p["variables"]))
        except (TypeError, KeyError):
            out.append(None)
    return out or [None]


class HashRing:
    """Immutable consistent-hash ring over replica addresses.

    Membership changes (drain, death) are expressed at route time via
    ``exclude`` rather than by rebuilding the ring: the surviving owner
    of a key under exclusion is then BY CONSTRUCTION the replica that
    inherits the excluded owner's arc for that key — the drain handoff
    and the retry-on-successor path use the same walk."""

    def __init__(self, replicas: Sequence[str],
                 vnodes: int = DEFAULT_VNODES):
        self.replicas: Tuple[str, ...] = tuple(dict.fromkeys(replicas))
        if not self.replicas:
            raise ValueError("HashRing requires at least one replica")
        self.vnodes = max(int(vnodes), 1)
        points: List[Tuple[int, str]] = []
        for rep in self.replicas:
            for i in range(self.vnodes):
                points.append((_point(f"{rep}#{i}"), rep))
        points.sort()
        self._points = points
        self._hashes = [p for p, _ in points]

    def route(self, key: Optional[str],
              exclude: Iterable[str] = ()) -> Optional[str]:
        """The replica owning ``key``, skipping ``exclude`` members;
        None when every replica is excluded.  ``key=None`` (a problem
        whose ids could not be read) routes to the ring's first arc —
        deterministic, so the byte-identity pins hold."""
        dead = frozenset(exclude)
        n = len(self._points)
        start = (bisect.bisect_right(self._hashes, _point(key))
                 % n if key is not None else 0)
        seen = set()
        for off in range(n):
            rep = self._points[(start + off) % n][1]
            if rep in dead or rep in seen:
                seen.add(rep)
                continue
            return rep
        return None

    def successor(self, key: Optional[str], owner: str,
                  exclude: Iterable[str] = ()) -> Optional[str]:
        """The replica inheriting ``key`` when ``owner`` is gone — its
        route with the owner (and any other exclusions) removed."""
        return self.route(key, exclude=set(exclude) | {owner})
