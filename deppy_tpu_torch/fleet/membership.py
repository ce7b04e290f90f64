"""Elastic fleet membership (copy of ``deppy_tpu/fleet/membership.py:1-304``):
epoch-versioned ring changes with warm-state-first joins.

Membership is a first-class, **epoch-versioned** value, so the fleet can
reshape under load:

  * **Runtime join** (:func:`join_replica`, ``POST /fleet/join``): the
    router streams a new replica the warm state it will inherit from
    its arc predecessors — :func:`.snapshot.split_snapshot` against the
    *prospective* ring, re-sealed into bounded, individually checksummed
    chunks (:func:`iter_chunks`; fault point ``fleet.join_stream``), so
    a truncated transfer is rejected loudly and resends per chunk.
    Only once the whole stream lands does the **atomic arc flip** happen
    (fault point ``fleet.arc_flip``): the ring is rebuilt with the
    joiner under the router's lock and the epoch increments.  A failed
    stream leaves membership exactly as it was.
  * **Leave = drain**: ``Router.drain`` hands off warm state; in elastic
    mode the drained replica also leaves the ring and the epoch
    increments.  A port ``Server`` with ``fleet_router`` set announces
    itself on start and drains itself on ``shutdown``.
  * **Peer gossip** (:func:`membership_view` / :func:`reconcile`,
    ``POST /fleet/sync``): routers on a static peer list exchange
    epoch-versioned ring views.  The higher epoch wins wholesale;
    same-epoch divergence resolves by a deterministic tiebreak (member
    count, then a hash of the sorted member list).  ``dead`` verdicts
    merge only from a view at >= the local epoch.

The knobs are ``DEPPY_GPU_FLEET`` (``elastic``; ``static`` turns all of
this off: the join, sync and policy endpoints 404 and
``/fleet/replicas`` carries no epoch), ``DEPPY_GPU_FLEET_JOIN_CHUNK``
(64) and ``DEPPY_GPU_FLEET_JOIN_RETRIES`` (2), each parsed as the
reference parses its ``DEPPY_TPU_FLEET*`` (``config.env_str``,
``config.env_int(strict=False)``: a malformed integer reads the
default).  The ``--membership`` flag is ROADMAP A7.2.
"""

from __future__ import annotations

import hashlib
import json
from typing import Iterator, List, Tuple

from .. import config, faults, telemetry
from .ring import HashRing
from .snapshot import _seal, split_snapshot, verify_snapshot

DEFAULT_MEMBERSHIP = "elastic"
DEFAULT_JOIN_CHUNK = 64
DEFAULT_JOIN_RETRIES = 2

_STATIC = ("static", "off", "0", "false", "no")
_ELASTIC = ("elastic", "on", "1", "true", "yes")


def membership_mode(value=None) -> str:
    """Normalize the fleet membership mode ('elastic' | 'static')."""
    if value is None:
        value = config.env_str("DEPPY_GPU_FLEET") or DEFAULT_MEMBERSHIP
    mode = str(value).strip().lower() or DEFAULT_MEMBERSHIP
    if mode in _STATIC:
        return "static"
    if mode in _ELASTIC:
        return "elastic"
    raise ValueError(
        f"unknown fleet membership mode {value!r} "
        "(want 'elastic' or 'static'; DEPPY_GPU_FLEET)")


def _validate_address(address) -> str:
    if not isinstance(address, str) or ":" not in address:
        raise ValueError('join requires {"replica": "host:port"}')
    _, _, port = address.rpartition(":")
    try:
        int(port)
    except ValueError:
        raise ValueError(
            f"invalid replica address {address!r} (want host:port)") from None
    return address


def iter_chunks(shard: dict, chunk_entries: int) -> Iterator[dict]:
    """Split one sealed warm-state shard into bounded mini-snapshots.

    Each chunk is re-sealed (its own version + checksum over canonical
    JSON), so the joiner verifies every chunk independently — a
    truncated or corrupted chunk fails ITS import and re-sends whole,
    never poisoning the entries that already landed.
    """
    has_sessions = "sessions" in shard
    entries: List[Tuple[str, dict]] = (
        [("index", e) for e in shard.get("index") or []]
        + [("cache", e) for e in shard.get("cache") or []]
        + [("sessions", e) for e in shard.get("sessions") or []])
    step = max(int(chunk_entries), 1)
    for i in range(0, len(entries), step):
        part = entries[i:i + step]
        yield _seal([e for kind, e in part if kind == "index"],
                    [e for kind, e in part if kind == "cache"],
                    sessions=([e for kind, e in part
                               if kind == "sessions"]
                              if has_sessions else None))


def _deliver_chunk(router, address: str, chunk: dict, retries: int) -> None:
    """POST one sealed chunk to the joiner, resending on failure.

    Resumable by construction: ``import_warm_state`` is idempotent
    (live state wins), so a chunk whose POST failed mid-flight re-sends
    whole without double-importing what already landed.
    """
    payload = json.dumps(chunk).encode("utf-8")
    last = None
    for _ in range(max(int(retries), 0) + 1):
        try:
            # Scripted chunk-stream fault point: a rule here makes one
            # (or every) delivery fail without touching the transport.
            faults.inject("fleet.join_stream")
            status, body, _ = router.forward(
                address, "POST", "/debug/warmstate", payload,
                {"Content-Type": "application/json"})
        except (OSError, faults.InjectedFault) as exc:
            last = exc
            continue
        if status == 200:
            return
        last = OSError(
            f"joiner {address} rejected warm-state chunk "
            f"(HTTP {status}): {body[:200]!r}")
    raise OSError(
        f"join stream to {address} failed after "
        f"{max(int(retries), 0) + 1} attempt(s): {last}")


def join_replica(router, address: str) -> dict:
    """Admit ``address`` to the fleet: stream its inherited warm state,
    then atomically flip its arcs live.

    The prospective ring (current members + joiner) decides which
    entries move: for every live donor we fetch ``GET /debug/warmstate``
    (the snapshot export), keep the shard ``split_snapshot`` assigns
    to the joiner under the prospective ring — exactly the arcs the
    joiner steals — and stream it over in checksummed chunks.  Nothing
    about live membership mutates until every chunk has landed; the
    flip itself (ring swap + epoch bump) happens in one critical
    section, so no request ever routes to a half-warmed joiner.
    """
    from .router import _Replica

    if not router.elastic:
        raise ValueError(
            "fleet membership is static (DEPPY_GPU_FLEET=static): "
            "POST /fleet/join is disabled")
    address = _validate_address(address)
    with router._lock:
        members = list(router.ring.replicas)
        vnodes = router.ring.vnodes
        state = router._replicas.get(address)
        if address in members and state is not None and not state.drained:
            raise ValueError(f"replica {address} is already a fleet member")
        unroutable = set(router._unroutable_locked())
    prospective = HashRing(
        [m for m in members if m != address] + [address], vnodes=vnodes)
    chunk_entries = config.env_int(
        "DEPPY_GPU_FLEET_JOIN_CHUNK", DEFAULT_JOIN_CHUNK, strict=False)
    retries = config.env_int(
        "DEPPY_GPU_FLEET_JOIN_RETRIES", DEFAULT_JOIN_RETRIES, strict=False)
    donors = [m for m in members if m != address and m not in unroutable]
    chunks = entries = 0
    for donor in donors:
        status, body, _ = router.forward(donor, "GET", "/debug/warmstate",
                                         None)
        if status != 200:
            continue  # warm tier off on this donor: nothing to inherit
        snapshot = verify_snapshot(json.loads(body))
        shard = split_snapshot(
            snapshot, lambda aff: prospective.route(aff)).get(address)
        if shard is None:
            continue  # none of this donor's arcs move to the joiner
        for chunk in iter_chunks(shard, chunk_entries):
            _deliver_chunk(router, address, chunk, retries)
            chunks += 1
            entries += len(chunk["index"]) + len(chunk["cache"]) \
                + len(chunk.get("sessions") or [])
    # The atomic arc flip: membership mutates ONLY here, after the
    # whole stream landed.  A scripted fault at this point proves the
    # failure mode is "joiner never admitted", not "cold arcs live".
    faults.inject("fleet.arc_flip")
    with router._lock:
        router.ring = prospective
        state = router._replicas.get(address)
        if state is None:
            router._replicas[address] = _Replica(address)
        else:
            state.drained = False
            state.dead = False
            state.failures = 0
        router.epoch += 1
        epoch = router.epoch
    if router._c_joins is not None:
        router._c_joins.inc()
        router._c_join_chunks.inc(chunks)
    telemetry.default_registry().event(
        "fault", fault="fleet_join", replica=address, epoch=epoch,
        chunks=chunks, entries=entries, donors=len(donors))
    return {"replica": address, "epoch": epoch, "donors": len(donors),
            "chunks": chunks, "warm_entries": entries}


def membership_view(router) -> dict:
    """This router's epoch-versioned ring view, as gossiped to peers."""
    with router._lock:
        return {
            "epoch": router.epoch,
            "vnodes": router.ring.vnodes,
            "members": list(router.ring.replicas),
            "dead": sorted(a for a, st in router._replicas.items()
                           if st.dead and not st.drained),
            "drained": sorted(a for a, st in router._replicas.items()
                              if st.drained),
        }


def _tiebreak(members) -> Tuple[int, str]:
    """Deterministic same-epoch winner: more members, then member-set
    hash — both routers compute the same order, so a partitioned pair
    that each committed a different change converges without flapping.
    """
    canon = sorted(members)
    digest = hashlib.sha256("\x1f".join(canon).encode("utf-8")).hexdigest()
    return (len(canon), digest)


def reconcile(router, view) -> dict:
    """Merge a peer's membership view into this router; return ours.

    Adoption is wholesale and epoch-gated: a strictly newer epoch (or a
    same-epoch tiebreak winner with a different member set) replaces
    the ring, member table, and drained flags in one critical section.
    Health verdicts (``dead``) OR-merge only from a view at >= the
    local epoch — marking dead is safe (probes revive a live replica on
    the next success), but only within the same membership generation.
    """
    from .router import _Replica

    if not router.elastic:
        raise ValueError(
            "fleet membership is static (DEPPY_GPU_FLEET=static): "
            "POST /fleet/sync is disabled")
    if not isinstance(view, dict):
        raise ValueError("fleet sync view must be a JSON object")
    try:
        epoch = int(view["epoch"])
        members = [str(m) for m in view["members"]]
    except (KeyError, TypeError, ValueError):
        raise ValueError(
            'fleet sync view requires integer "epoch" and a '
            '"members" list') from None
    if not members:
        raise ValueError("fleet sync view names no members")
    adopted = False
    newly_dead: List[str] = []
    with router._lock:
        local = list(router.ring.replicas)
        wins = epoch > router.epoch or (
            epoch == router.epoch and set(members) != set(local)
            and _tiebreak(members) > _tiebreak(local))
        if wins:
            drained = {str(a) for a in view.get("drained") or []}
            router.ring = HashRing(members, vnodes=router.ring.vnodes)
            for m in members:
                if m not in router._replicas:
                    router._replicas[m] = _Replica(m)
            for addr, st in router._replicas.items():
                if addr in drained or addr not in members:
                    # Drained away (or removed) under the adopted
                    # epoch: retire it here too instead of probing a
                    # ghost.
                    st.drained = True
                elif st.drained:
                    st.drained = False  # re-joined under the newer epoch
            router.epoch = epoch
            adopted = True
        if epoch >= router.epoch:
            for addr in view.get("dead") or []:
                st = router._replicas.get(str(addr))
                if st is not None and not st.dead and not st.drained:
                    st.failures = max(st.failures, router.probe_failures)
                    st.dead = True
                    newly_dead.append(str(addr))
    reg = telemetry.default_registry()
    if adopted:
        reg.event("fault", fault="fleet_view_adopted", epoch=epoch,
                  members=sorted(members))
    for addr in newly_dead:
        router._c_transitions.inc(label="down")
        reg.event("fault", fault="fleet_replica_down", replica=addr,
                  via="peer_sync")
    return membership_view(router)
