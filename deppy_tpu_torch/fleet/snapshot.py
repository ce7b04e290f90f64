"""Warm-state snapshot and handoff (copy of ``deppy_tpu/fleet/snapshot.py:41-203``).

A scheduler's warm tier is two in-process stores: the clause-set index
(zero-backtrack SAT models keyed by fingerprint — the warm-start seeds)
and the exact result cache.  This module serializes them into one
versioned, integrity-checked JSON document, so a fresh scheduler
inherits them instead of starting cold:

  * **index entries** round-trip at full fidelity (per-row multiset,
    vocabulary, model, cold-equivalent steps) — an imported entry plans
    warm starts exactly like the original;
  * **exact-cache seeds** carry definitive SAT solution dicts only.
    UNSAT cores hold live constraint objects and Incomplete entries are
    budget-relative; both re-solve cold once and re-enter the cache;
  * **sessions** (only when a :class:`deppy_tpu_torch.sessions.SessionStore`
    is exported): each live session's retained problem, assumption
    stack with its test-scope structure, remaining lease and private
    warm index.  The section is OPTIONAL: a session-free snapshot is
    byte-identical to one without the session tier.

Every entry carries its family ``affinity`` key
(:func:`deppy_tpu_torch.fleet.ring.affinity_key`).  The checksum is over
the canonical JSON of the payload — a truncated or bit-flipped handoff
is rejected loudly (:class:`SnapshotFormatError`) rather than silently
poisoning the inheritor's warm tier.  The document is the reference's
format, byte for byte: a snapshot taken by either package imports into
the other.

Left out until the router is ported (ROADMAP A5.6.7):
``split_snapshot``, which partitions a snapshot over the hash ring.
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Optional

from .ring import affinity_key

SNAPSHOT_VERSION = 1


class SnapshotFormatError(ValueError):
    """Malformed, version-skewed, or integrity-failed snapshot."""


def _checksum(payload: dict) -> str:
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def _seal(index_entries: List[dict], cache_seeds: List[dict],
          sessions: Optional[List[dict]] = None) -> dict:
    payload = {"version": SNAPSHOT_VERSION, "index": index_entries,
               "cache": cache_seeds}
    if sessions is not None:
        # Conditional key, checksummed when present: a session-free
        # export stays byte-identical to pre-session snapshots, and a
        # tampered sessions list fails verification like any other
        # section.
        payload["sessions"] = sessions
    return {**payload, "checksum": _checksum(payload)}


def index_entry_to_dict(entry) -> dict:
    """Serialize one clause-set-index entry (shared by the scheduler's
    shared index and each session's private index)."""
    return {
        "key": entry.key,
        "vocab_n": entry.vocab[0],
        "vocab_ids": list(entry.vocab[1]),
        "rows": [[list(k), n] for k, n in entry.rows.items()],
        "model": [int(b) for b in entry.model],
        "steps": entry.steps,
        "backtracks": entry.backtracks,
        "affinity": affinity_key(entry.vocab[1]),
    }


def import_index_entry(index, raw: dict) -> bool:
    """Deserialize + import one index entry; ``True`` when admitted
    (live state wins — a fresher local entry keeps its place).  Raises
    :class:`SnapshotFormatError` on a malformed entry."""
    import numpy as np

    try:
        from collections import Counter

        rows = Counter({tuple(k): int(n) for k, n in raw["rows"]})
        vocab = (int(raw["vocab_n"]),
                 tuple(str(i) for i in raw["vocab_ids"]))
        model = np.asarray(raw["model"], dtype=bool)
        return index.import_entry(
            str(raw["key"]), rows, vocab, model,
            int(raw["steps"]), int(raw["backtracks"]))
    except (KeyError, TypeError, ValueError) as e:
        raise SnapshotFormatError(
            f"malformed snapshot index entry: {e}") from e


def export_warm_state(scheduler, sessions=None) -> dict:
    """Serialize one scheduler's warm tier.  Works with either store
    absent (tier off): the corresponding section is just empty.  With a
    session store the live sessions ride along; without one
    the document is byte-identical to the pre-session format."""
    index_entries: List[dict] = []
    index = getattr(scheduler, "incremental", None)
    if index is not None:
        for entry in index.export_entries():
            index_entries.append(index_entry_to_dict(entry))
    cache_seeds: List[dict] = []
    cache = getattr(scheduler, "cache", None)
    if cache is not None:
        for key, budget, solution in cache.export_seeds():
            cache_seeds.append({
                "key": key,
                "budget": budget,
                "solution": solution,
                "affinity": affinity_key(solution.keys()),
            })
    session_entries = None
    if sessions is not None:
        session_entries = sessions.export_entries()
    return _seal(index_entries, cache_seeds, sessions=session_entries)


def verify_snapshot(doc) -> dict:
    """Validate shape, version, and checksum; returns ``doc``."""
    if not isinstance(doc, dict):
        raise SnapshotFormatError(
            f"snapshot must be an object, got {type(doc).__name__}")
    if doc.get("version") != SNAPSHOT_VERSION:
        raise SnapshotFormatError(
            f"unsupported snapshot version {doc.get('version')!r} "
            f"(this build speaks {SNAPSHOT_VERSION})")
    if not isinstance(doc.get("index"), list) \
            or not isinstance(doc.get("cache"), list):
        raise SnapshotFormatError(
            'snapshot requires "index" and "cache" lists')
    payload = {"version": doc["version"], "index": doc["index"],
               "cache": doc["cache"]}
    if "sessions" in doc:
        if not isinstance(doc["sessions"], list):
            raise SnapshotFormatError('"sessions" must be a list')
        payload["sessions"] = doc["sessions"]
    if doc.get("checksum") != _checksum(payload):
        raise SnapshotFormatError(
            "snapshot integrity check failed (checksum mismatch)")
    return doc


def import_warm_state(scheduler, doc, sessions=None) -> dict:
    """Merge a verified snapshot into ``scheduler``'s warm tier.

    Live state wins: an index key already present keeps its (at least
    as fresh) local entry, and the exact cache's own supersede rules
    apply to seeds.  A ``sessions`` section imports into the given
    session store (live session ids win; entries are dropped without
    one — a session-free inheritor still takes the index/cache).
    Returns the merge accounting the endpoint renders; the session
    keys appear only when the document carried the section, so
    pre-session snapshot responses stay byte-identical."""
    verify_snapshot(doc)
    index = getattr(scheduler, "incremental", None)
    idx_in = idx_skip = 0
    for raw in doc["index"]:
        if index is None:
            break
        if import_index_entry(index, raw):
            idx_in += 1
        else:
            idx_skip += 1
    cache = getattr(scheduler, "cache", None)
    seeds = 0
    for raw in doc["cache"]:
        if cache is None:
            break
        try:
            sol = raw["solution"]
            if not isinstance(sol, dict):
                raise TypeError('"solution" must be an object')
            cache.store(str(raw["key"]), int(raw["budget"]),
                        {str(k): bool(v) for k, v in sol.items()})
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotFormatError(
                f"malformed snapshot cache seed: {e}") from e
        seeds += 1
    out = {"index_imported": idx_in, "index_skipped": idx_skip,
           "cache_seeds": seeds}
    if "sessions" in doc:
        ses_in = ses_skip = 0
        for raw in doc["sessions"]:
            if sessions is None:
                ses_skip += 1
                continue
            if sessions.import_entry(raw):
                ses_in += 1
            else:
                ses_skip += 1
        out["sessions_imported"] = ses_in
        out["sessions_skipped"] = ses_skip
    return out
