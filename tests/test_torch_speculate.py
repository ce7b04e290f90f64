"""The port's speculation tier against the JAX package's.

The reference's ``tests/test_speculate.py`` shapes, on the CPU: the same
documents, parsed by each package's codec, go through
``deppy_tpu.speculate`` over ``deppy_tpu.sched.Scheduler`` and through
``deppy_tpu_torch.speculate`` over the port's scheduler.  Every
comparison is exact (the answers are discrete):

  * ``PublishDelta.from_doc`` / ``apply`` and ``PublishFormatError``;
  * ``ResultCache.peek`` / ``invalidate_keys``,
    ``ClauseSetIndex.affected_keys`` and ``plan(account=False)`` on a
    cache and an index fed the same stores;
  * the ``Server``-free classes of the reference's file on
    ``Scheduler(backend="host")`` in both packages — publish accounting,
    invalidation, dedupe, composition, the backlog cap, idle priority,
    shutdown, preview and ``affected_keys`` — with the accounting dicts
    and the rendered answers equal;
  * one publish, drain and re-ask on ``Scheduler(device="cpu")`` (the
    kernels' plain versions) against the reference's
    ``Scheduler(backend="tpu")``;
  * the publish-churn generators and a small replay against
    ``deppy_tpu.benchmarks.publish``;
  * the ``DEPPY_GPU_SPECULATE*`` knobs, read as the reference reads its
    ``DEPPY_TPU_SPECULATE*``.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import io as jio
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.benchmarks import publish as jpublish
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.incremental import ClauseSetIndex as JClauseSetIndex
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sched import ResultCache as JResultCache
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu.sched.cache import fingerprint as jfingerprint
from deppy_tpu.speculate import PublishDelta as JPublishDelta
from deppy_tpu.speculate import PublishFormatError as JPublishFormatError
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.incremental import ClauseSetIndex
from deppy_tpu_torch.models import catalog_family, round_delta
from deppy_tpu_torch.sat.constraints import Prohibited
from deppy_tpu_torch.sat.encode import encode
from deppy_tpu_torch.sched import ResultCache, Scheduler, fingerprint
from deppy_tpu_torch.speculate import PublishDelta, PublishFormatError
from deppy_tpu_torch.speculate.manager import (DEFAULT_FAMILY_CAPACITY,
                                               DEFAULT_PREVIEW_LIMIT,
                                               MAX_PREVIEW_LIMIT)

ROOT = Path(__file__).resolve().parents[1]
BUDGET = 1 << 24
# The reference's tiers the comparison keeps off on its side (the port's
# defaults race nothing without a measured row).
REF = dict(portfolio="off")
SIDES = {"reference": (jio, JPublishDelta, JScheduler),
         "port": (tio, PublishDelta, Scheduler)}


def within(seconds: float):
    """Fail the test when its body runs past ``seconds``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["err"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} ran past its {seconds} s limit")
            if "err" in box:
                raise box["err"]
        return run
    return deco


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each package's fault plan, breaker and default registry per test;
    the reference's escalation off; no speculation knob set."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    for name in ("DEPPY_GPU_SPECULATE", "DEPPY_GPU_SPECULATE_MAX_BACKLOG",
                 "DEPPY_TPU_SPECULATE", "DEPPY_TPU_SPECULATE_MAX_BACKLOG",
                 "DEPPY_GPU_INCREMENTAL"):
        monkeypatch.delenv(name, raising=False)
    prev_breakers = (jfaults.set_default_breaker(jfaults.CircuitBreaker()),
                     tfaults.set_default_breaker(tfaults.CircuitBreaker()))
    prev_plans = (jfaults.configure_plan(None), tfaults.configure_plan(None))
    prev = (jtelemetry.set_default_registry(jtelemetry.Registry()),
            ttelemetry.set_default_registry(ttelemetry.Registry()))
    yield
    jtelemetry.set_default_registry(prev[0])
    ttelemetry.set_default_registry(prev[1])
    jfaults.configure_plan(prev_plans[0])
    tfaults.configure_plan(prev_plans[1])
    jfaults.set_default_breaker(prev_breakers[0])
    tfaults.set_default_breaker(prev_breakers[1])


# ------------------------------------------------------------ documents


def catalog_doc(prefix: str, state: int = 0, bundles: int = 3,
                size: int = 5) -> dict:
    """The reference suite's bundle-catalog family
    (``tests/test_speculate.py:55-76``); ``state`` rotates bundle 1's
    mid-chain dependency so consecutive states are one-row deltas."""
    doc = []
    for b in range(bundles):
        for j in range(size):
            cons = []
            if j == 0:
                cons.append({"type": "mandatory"})
                cons.append({"type": "dependency",
                             "ids": [f"{prefix}b{b}v1"]})
            elif j < size - 2:
                tgt = j + 1
                if b == 1 and j == 1:
                    tgt = min(j + 1 + state, size - 1)
                cons.append({"type": "dependency",
                             "ids": [f"{prefix}b{b}v{tgt}",
                                     f"{prefix}b{b}v{min(j + 2, size - 1)}"]})
            doc.append({"id": f"{prefix}b{b}v{j}", "constraints": cons})
    return {"variables": doc}


def delta_doc(prefix: str, state: int, size: int = 5) -> dict:
    """The publish that moves ``catalog_doc`` from any state to
    ``state`` (absolute replacement of bundle 1's v1 row)."""
    tgt = min(2 + state, size - 1)
    return {"updates": [{
        "id": f"{prefix}b1v1",
        "constraints": [{"type": "dependency",
                         "ids": [f"{prefix}b1v{tgt}",
                                 f"{prefix}b1v{min(3, size - 1)}"]}]}]}


def parse(side: str, doc: dict) -> list:
    return SIDES[side][0].problems_from_document(doc)[0]


def delta(side: str, doc: dict):
    return SIDES[side][1].from_doc(doc)


def vars_doc(side: str, variables) -> list:
    io = SIDES[side][0]
    return [io.variable_to_dict(v) for v in variables]


def rendered(side: str, result) -> str:
    return json.dumps(SIDES[side][0].result_to_dict(result), sort_keys=True)


def scheduler(side: str, **kw):
    if side == "reference":
        return JScheduler(**{**REF, **kw})
    return Scheduler(**kw)


def _in_flight(sched) -> bool:
    """Pre-solves queued, or dequeued and not yet stored (a dispatch
    releases its lanes' keys after it stores them)."""
    with sched._cv:
        return bool(sched._spec_depth or sched._spec_keys)


def drain(sched, timeout: float = 20.0) -> None:
    """Until every pre-solve is stored (the reference's compile of a
    new shape outlasts any fixed settle beat)."""
    t0 = time.monotonic()
    while _in_flight(sched) and time.monotonic() - t0 < timeout:
        time.sleep(0.005)
    assert not _in_flight(sched)


def both(fn):
    """``fn(side)`` for the reference, then the port: (want, got)."""
    return fn("reference"), fn("port")


# ----------------------------------------------------------- PublishDelta


MALFORMED = [None, [], {"updates": "x"}, {"updates": [{"id": 3}]},
             {"updates": [], "removed": []},
             {"updates": [{"id": "a", "constraints": [{"type": "wat"}]}]},
             {"updates": [{"id": "a", "constraints": "x"}]},
             {"removed": [1]}]


@pytest.mark.parametrize("doc", MALFORMED,
                         ids=[f"doc{i}" for i in range(len(MALFORMED))])
def test_malformed_publish_documents_raise_alike(doc):
    """Each malformed document of ``tests/test_speculate.py:235-242``
    (and two more) raises ``PublishFormatError`` with the reference's
    message."""
    with pytest.raises(JPublishFormatError) as want:
        JPublishDelta.from_doc(doc)
    with pytest.raises(PublishFormatError) as got:
        PublishDelta.from_doc(doc)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("doc,changes", [
    (delta_doc("t.", 1), True),
    ({"removed": ["t.b2v4"]}, True),
    ({"removed": ["nope"]}, False),
    (delta_doc("t.", 0), False),
    ({"updates": [{"id": "t.b0v2"}], "removed": ["t.b1v3"]}, True),
], ids=["update", "withdraw", "absent", "already-applied", "both"])
def test_apply_equals_reference(doc, changes):
    """``from_doc`` then ``apply`` give the reference's variables (a
    withdrawn bundle as ``Prohibited``), or None alike."""
    base = catalog_doc("t.")
    want, got = both(lambda side: delta(side, doc).apply(parse(side, base)))
    assert (got is not None) == (want is not None) == changes
    if changes:
        assert vars_doc("port", got) == vars_doc("reference", want)
    d = PublishDelta.from_doc(doc)
    assert d.changed_identifiers() == JPublishDelta.from_doc(
        doc).changed_identifiers()
    for ident in d.removed:
        hit = [v for v in (got or ()) if v.identifier == ident]
        assert all(v.constraints == (Prohibited(),) for v in hit)


def test_preview_limits_are_the_reference_s():
    from deppy_tpu.speculate import manager as jmanager

    assert (DEFAULT_FAMILY_CAPACITY, DEFAULT_PREVIEW_LIMIT,
            MAX_PREVIEW_LIMIT) == (jmanager.DEFAULT_FAMILY_CAPACITY,
                                   jmanager.DEFAULT_PREVIEW_LIMIT,
                                   jmanager.MAX_PREVIEW_LIMIT) == (
        2048, 32, 128)


# ----------------------------------------------- cache and index surfaces


def _stored_problems(side: str):
    enc = jencode if side == "reference" else encode
    return [enc(parse(side, catalog_doc("c.", state=s, bundles=6, size=7)))
            for s in range(3)]


@within(60)
def test_peek_and_invalidate_keys_equal_reference():
    """``peek`` answers as ``lookup`` would without accounting or LRU
    touch; ``invalidate_keys`` evicts and counts on
    ``deppy_cache_invalidations_total``; both as the reference's."""
    def run(side):
        from deppy_tpu_torch.sat.errors import Incomplete as TIncomplete
        from deppy_tpu.sat.errors import Incomplete as JIncomplete

        reg = (jtelemetry if side == "reference" else ttelemetry).Registry()
        cache = (JResultCache if side == "reference" else ResultCache)(
            8, registry=reg)
        fp = jfingerprint if side == "reference" else fingerprint
        keys = [fp(p) for p in _stored_problems(side)]
        cache.store(keys[0], 100, {"a": True})
        cache.store(keys[1], 100, {"b": False})
        cache.store(keys[2], 100,
                    (JIncomplete if side == "reference" else TIncomplete)())
        before = reg.snapshot()
        peeks = [cache.peek(k, b) for k in keys for b in (50, 100, 200)]
        peeks.append(cache.peek("absent", 100))
        assert reg.snapshot() == before  # no accounting
        order = list(cache._entries)
        n = cache.invalidate_keys([keys[1], "absent", keys[1], keys[2]])
        snap = reg.snapshot()
        return (keys, peeks, order, n, list(cache._entries), len(cache),
                snap.get("deppy_cache_invalidations_total"),
                snap.get("deppy_cache_hit_ratio"),
                cache.peek(keys[1], 100), (JResultCache if side == "reference"
                                           else ResultCache)(
                    0, registry=reg).peek(keys[0], 100))
    want, got = both(run)
    assert got == want
    assert got[3] == 2 and got[6] == 2


@within(60)
def test_affected_keys_and_read_only_plan_equal_reference():
    """``affected_keys`` enumerates the same keys in the same order (most
    recently stored first); ``plan(account=False)`` returns the plan of
    ``account=True`` and leaves the counters and spans as they were."""
    def run(side):
        mod = jtelemetry if side == "reference" else ttelemetry
        reg = mod.Registry()
        index = (JClauseSetIndex if side == "reference" else ClauseSetIndex)(
            registry=reg)
        fp = jfingerprint if side == "reference" else fingerprint
        probs = _stored_problems(side)
        for p in probs[:2]:
            index.store(fp(p), p, np.zeros(p.n_vars, dtype=bool), steps=10,
                        backtracks=0)
        out = [index.affected_keys(ids) for ids in (
            {"c.b1v1"}, {"c.b0v0", "c.b2v3"}, {"no-such"}, set(),
            {"c.b1v4"})]
        snap0, spans0 = reg.snapshot(), len(reg.recent_spans())
        ro = index.plan(probs[2], fp(probs[2]), BUDGET, account=False)
        assert reg.snapshot() == snap0
        assert len(reg.recent_spans()) == spans0
        rw = index.plan(probs[2], fp(probs[2]), BUDGET)
        assert len(reg.recent_spans()) == spans0 + 1
        assert ro is not None and rw is not None
        plans = [(p.klass, p.entry_key, p.cone.tolist(),
                  p.warm_assign.tolist(), p.cone_fraction)
                 for p in (ro, rw)]
        assert plans[0] == plans[1]
        return out, plans[0], index.hit_ratio()
    want, got = both(run)
    assert got == want
    assert got[0][0] and got[0][2] == [] and got[0][3] == []


@pytest.mark.parametrize("case", ["rows", "vocab-only"])
def test_affected_keys_cases_of_the_reference(case):
    """``TestAffectedKeys``: rows touching a changed identifier
    enumerate, newest first; an identifier in the vocabulary that no row
    touches does not."""
    def run(side):
        reg = (jtelemetry if side == "reference" else ttelemetry).Registry()
        index = (JClauseSetIndex if side == "reference" else ClauseSetIndex)(
            registry=reg)
        fp = jfingerprint if side == "reference" else fingerprint
        enc = jencode if side == "reference" else encode
        if case == "rows":
            ps = [enc(parse(side, catalog_doc("t11.", state=s)))
                  for s in (0, 1)]
            asks = ({"t11.b1v1"}, {"no-such-bundle"}, set())
        else:
            ps = [enc(parse(side, {"variables": [
                {"id": "a", "constraints": [{"type": "mandatory"}]},
                {"id": "loner"}]}))]
            asks = ({"a"}, {"loner"})
        for p in ps:
            index.store(fp(p), p, np.zeros(p.n_vars, dtype=bool), steps=1,
                        backtracks=0)
        return [fp(p) for p in ps], [index.affected_keys(a) for a in asks]
    want, got = both(run)
    assert got == want
    keys, hits = got
    if case == "rows":
        assert hits[0] == [keys[1], keys[0]] and hits[1:] == [[], []]
    else:
        assert hits == [[keys[0]], []]


# ------------------------------------------- the tier on the host scheduler


@within(120)
def test_publish_presolves_and_reask_is_a_pure_cache_hit():
    """``test_publish_presolves_and_reask_is_pure_cache_hit``: the
    publish's accounting, the re-ask (0 steps, no report, no dispatch)
    and its answer equal the reference's and a cold solve's."""
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            base = parse(side, catalog_doc("t1."))
            s.submit([base])
            d = delta(side, delta_doc("t1.", 1))
            out = s.speculate.publish(d)
            drain(s)
            new_vars = d.apply(base)
            before = s._c_dispatches.value
            st: dict = {}
            (res,) = s.submit([new_vars], stats=st)
            hit = (st["steps"], st["report"],
                   s._c_dispatches.value - before)
            cold = scheduler(side, backend="host", cache_size=0,
                             incremental="off", speculate="off")
            (ref,) = cold.submit([new_vars])
            assert rendered(side, res) == rendered(side, ref)
            return out, hit, rendered(side, res), s._c_flushes.value
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    out, hit, _, flushes = got
    assert out["affected"] >= 1 and out["queued"] >= 1
    assert hit == (0, None, 0) and flushes.get("spec", 0) >= 1


@within(60)
def test_publish_invalidates_retracted_exact_entries():
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            base = parse(side, catalog_doc("t2."))
            s.submit([base])
            enc = jencode if side == "reference" else encode
            fp = jfingerprint if side == "reference" else fingerprint
            old = fp(enc(base))
            assert s.cache.peek(old, BUDGET)
            inv0 = s.cache._invalidations.value
            out = s.speculate.publish(delta(side, delta_doc("t2.", 1)))
            return (out, s.cache.peek(old, BUDGET),
                    s.cache._invalidations.value - inv0)
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    out, still, n = got
    assert out["invalidated"] >= 1 and not still and n == out["invalidated"]


@within(120)
def test_idempotent_republish_keeps_hot_entries():
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            base = parse(side, catalog_doc("t16."))
            s.submit([base])
            d = delta(side, delta_doc("t16.", 1))
            first = s.speculate.publish(d)
            drain(s)
            new_vars = d.apply(base)
            s.submit([new_vars])
            enc = jencode if side == "reference" else encode
            fp = jfingerprint if side == "reference" else fingerprint
            key = fp(enc(new_vars))
            again = s.speculate.publish(d)
            kept = s.cache.peek(key, BUDGET)
            drain(s)
            st: dict = {}
            (res,) = s.submit([new_vars], stats=st)
            return first, again, kept, st["steps"], rendered(side, res)
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    assert got[1]["unchanged"] >= 1 and got[2] and got[3] == 0


@within(120)
def test_duplicate_publish_burst_dedupes_against_backlog():
    def run(side):
        s = scheduler(side, backend="host", max_fill=1)
        s.start()
        try:
            jobs = [parse(side, catalog_doc(f"t17x{k}.", bundles=4, size=7))
                    for k in range(8)]
            first = s.submit_speculative(jobs)
            second = s.submit_speculative(jobs)
            drain(s, timeout=60.0)
            third = s.submit_speculative(jobs)  # all cached now
            return first, second, third
        finally:
            s.stop()
    want, got = both(run)
    assert got == want == ((8, 0), (0, 0), (0, 0))


@within(120)
def test_back_to_back_publishes_compose():
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            base = parse(side, catalog_doc("t19."))
            s.submit([base])
            d1 = delta(side, delta_doc("t19.", 1))
            d2 = delta(side, {"updates": [{
                "id": "t19.b2v1",
                "constraints": [{"type": "dependency",
                                 "ids": ["t19.b2v3", "t19.b2v2"]}]}]})
            outs = [s.speculate.publish(d1)]
            drain(s)
            outs.append(s.speculate.publish(d2))
            drain(s)
            final = d2.apply(d1.apply(base))
            st: dict = {}
            (res,) = s.submit([list(final)], stats=st)
            return outs, st["steps"], rendered(side, res)
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    assert got[1] == 0 and json.loads(got[2])["status"] == "sat"


@pytest.mark.parametrize("cap", [0, 2, 3])
@within(60)
def test_backlog_cap_drops_and_counts(cap):
    """Lanes past ``speculate_max_backlog`` drop, as the reference's, and
    the manager counts what ``publish`` queued and dropped."""
    def run(side):
        s = scheduler(side, backend="host", speculate_max_backlog=cap)
        s.start()
        try:
            fams = [parse(side, catalog_doc(f"t4{k}.")) for k in range(4)]
            direct = s.submit_speculative(fams)
            drain(s)
            for f in fams:
                s.submit([f])
            d = delta(side, {"updates": [
                {"id": f"t4{k}.b1v1", "constraints": []}
                for k in range(4)]})
            out = s.speculate.publish(d)
            drain(s)
            snap = s._registry.snapshot()
            return (direct, out, snap.get("deppy_speculate_presolves_total"),
                    snap.get("deppy_speculate_dropped_total"),
                    snap.get("deppy_speculate_backlog"))
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    direct, out, presolves, dropped, backlog = got
    assert direct == (min(cap, 4), 4 - min(cap, 4))
    assert (presolves, dropped, backlog) == (out["queued"], out["dropped"],
                                             0)


@within(60)
def test_unstarted_scheduler_drops_every_presolve():
    """A pre-solve never dispatches inline on a publisher's thread: with
    the loop not running every lane drops."""
    def run(side):
        s = scheduler(side, backend="host")
        jobs = [parse(side, catalog_doc(f"t20x{k}.")) for k in range(3)]
        return s.submit_speculative(jobs), s.speculative_depth()
    want, got = both(run)
    assert got == want == ((0, 3), 0)


@within(60)
def test_malformed_family_is_a_counted_drop():
    """A family that does not encode is dropped with the
    ``speculate_encode_failed`` fault event; one with unresolved
    references is dropped without one."""
    def run(side):
        tel = jtelemetry if side == "reference" else ttelemetry
        events = []
        reg = tel.default_registry()
        fwd = events.append
        reg.add_forwarder(fwd)
        s = scheduler(side, backend="host")
        s.start()
        try:
            io = SIDES[side][0]
            dup = parse(side, catalog_doc("t21.")) * 2
            dangling = io.problems_from_document({"variables": [
                {"id": "a", "constraints": [
                    {"type": "dependency", "ids": ["ghost"]}]}]})[0]
            good = parse(side, catalog_doc("t21g."))
            out = s.submit_speculative([dup, dangling, good])
            drain(s)
        finally:
            s.stop()
            reg.remove_forwarder(fwd)
        return out, [(e.get("fault"), e.get("error")) for e in events
                     if e.get("kind") == "fault"]
    want, got = both(run)
    assert got == want
    assert got[0] == (1, 2)
    assert got[1] == [("speculate_encode_failed", "DuplicateIdentifier")]


# --------------------------------------------------- idle priority / shutdown


@within(180)
def test_live_lane_preempts_sustained_speculative_backlog():
    """A live submit completes while a speculative backlog is still
    queued, in both packages: the backlog never starves live traffic."""
    for side in SIDES:
        s = scheduler(side, backend="host", max_fill=2, max_wait_ms=1.0)
        s.start()
        try:
            jobs = ([parse(side, catalog_doc("t5.", state=st, bundles=4,
                                             size=7)) for st in range(1, 4)]
                    + [parse(side, catalog_doc(f"t5x{k}.", bundles=4,
                                               size=7)) for k in range(12)])
            queued, _ = s.submit_speculative(jobs)
            assert queued == len(jobs)
            t0 = time.perf_counter()
            (res,) = s.submit([parse(side, catalog_doc("t5live."))])
            live_s = time.perf_counter() - t0
            assert isinstance(res, dict)
            assert s.speculative_depth() > 0, side
            assert live_s < 5.0
            drain(s, timeout=60.0)
        finally:
            s.stop()


@within(60)
def test_spec_flush_reason_counted():
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            s.submit_speculative([parse(side, catalog_doc("t6."))])
            drain(s)
            return s._c_flushes.value.get("spec", 0)
        finally:
            s.stop()
    want, got = both(run)
    assert got == want == 1


@within(120)
def test_shutdown_discards_backlog_and_counts_it():
    """A stop with pre-solves queued returns promptly, empties the
    backlog and its gauge, releases the in-flight keys, and every lane
    queued is either solved or counted dropped, as in the reference."""
    for side in SIDES:
        s = scheduler(side, backend="host", max_fill=1)
        s.start()
        jobs = [parse(side, catalog_doc(f"t7x{k}.", bundles=4, size=7))
                for k in range(10)]
        queued, _ = s.submit_speculative(jobs)
        t0 = time.perf_counter()
        s.stop()
        assert time.perf_counter() - t0 < 10.0
        snap = s._registry.snapshot()
        assert s.speculative_depth() == 0 and not s._spec_keys
        assert snap.get("deppy_speculate_backlog") == 0
        solved = s._c_flushes.value.get("spec", 0)
        assert solved + snap.get("deppy_speculate_dropped_total", 0) \
            == queued, side


# ------------------------------------------------------------ what-if tier


@within(120)
def test_preview_resolves_without_serving_or_caching():
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            base = parse(side, catalog_doc("t9."))
            s.submit([base])
            drain(s)
            sizes = (len(s.cache), len(s.incremental),
                     s.incremental.hit_ratio(), s._registry.snapshot().get(
                         "deppy_incremental_delta_total"))
            d = delta(side, delta_doc("t9.", 2))
            entries = s.speculate.preview(d)
            assert (len(s.cache), len(s.incremental),
                    s.incremental.hit_ratio(), s._registry.snapshot().get(
                        "deppy_incremental_delta_total")) == sizes
            (served,) = s.submit([d.apply(base)])
            return ([(e["fingerprint"], e["delta_class"],
                      rendered(side, e["result"])) for e in entries],
                    rendered(side, served),
                    s._registry.snapshot().get(
                        "deppy_speculate_previews_total"))
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    entries, served, n = got
    assert entries and n == len(entries)
    assert served in [e[2] for e in entries]


@pytest.mark.parametrize("limit", [None, 1, 0, 500])
@within(120)
def test_preview_limit(limit):
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            for st in range(3):
                s.submit([parse(side, catalog_doc("t10.", state=st))])
            entries = s.speculate.preview(delta(side, delta_doc("t10.", 4)),
                                          limit=limit)
            return [(e["fingerprint"], e["delta_class"],
                     rendered(side, e["result"])) for e in entries]
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    # State 2 already carries the proposal's row: two families change.
    assert len(got) == {None: 2, 1: 1, 0: 0, 500: 2}[limit]


@within(60)
def test_preview_of_an_unsat_proposal():
    """A withdrawal that leaves a mandatory bundle unsatisfiable previews
    as the reference's core."""
    def run(side):
        s = scheduler(side, backend="host")
        s.start()
        try:
            s.submit([parse(side, catalog_doc("t22."))])
            entries = s.speculate.preview(delta(side,
                                                {"removed": ["t22.b0v1"]}))
            return [rendered(side, e["result"]) for e in entries]
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    assert [json.loads(r)["status"] for r in got] == ["unsat"]


# --------------------------------------------------------------- tier off


@within(120)
def test_off_matches_on_responses_and_builds_no_tier():
    def run(side):
        tel = jtelemetry if side == "reference" else ttelemetry
        on = scheduler(side, backend="host")
        off = scheduler(side, backend="host", speculate="off",
                        registry=tel.Registry())
        assert off.speculate is None and off._g_spec_depth is None
        assert "deppy_speculate_backlog" not in off._registry.snapshot()
        on.start()
        off.start()
        try:
            out = []
            for st in (0, 1, 0, 2):
                vs = parse(side, catalog_doc("t8.", state=st))
                (a,) = on.submit([vs])
                (b,) = off.submit([vs])
                assert rendered(side, a) == rendered(side, b)
                out.append(rendered(side, a))
            out.append(off.submit_speculative(
                [parse(side, catalog_doc("t8."))]))
            return out
        finally:
            on.stop()
            off.stop()
    want, got = both(run)
    assert got == want
    assert got[-1] == (0, 1)


@pytest.mark.parametrize("env,value,backlog", [
    ("SPECULATE", "off", None), ("SPECULATE", "No", None),
    ("SPECULATE", "on", 2048), ("SPECULATE_MAX_BACKLOG", "7", 7),
    ("SPECULATE_MAX_BACKLOG", "7.9", 7), ("SPECULATE_MAX_BACKLOG", "-3", 0),
    ("SPECULATE_MAX_BACKLOG", "junk", 2048),
], ids=["off", "No", "on", "backlog-7", "backlog-float", "backlog-neg",
        "backlog-junk"])
@within(60)
def test_knobs_read_as_the_reference_reads_its_own(env, value, backlog,
                                                    monkeypatch):
    """``DEPPY_GPU_SPECULATE`` (its off spellings) and
    ``DEPPY_GPU_SPECULATE_MAX_BACKLOG`` (float then int, a bad value
    keeps the default) as the reference's ``DEPPY_TPU_*``."""
    monkeypatch.setenv(f"DEPPY_GPU_{env}", value)
    monkeypatch.setenv(f"DEPPY_TPU_{env}", value)
    mine = Scheduler(backend="host")
    ref = JScheduler(backend="host", **REF)
    got = (None if mine.speculate is None else mine.spec_max_backlog)
    want = (None if ref.speculate is None else ref.spec_max_backlog)
    assert got == want == backlog
    # An argument beats the knob, in both.
    if backlog is not None:
        assert Scheduler(backend="host",
                         speculate_max_backlog=3).spec_max_backlog == 3


# ------------------------------------------------- the device scheduler


@within(300)
def test_device_scheduler_publish_equals_reference():
    """One publish, drain and re-ask on ``Scheduler(device="cpu")`` (the
    kernels' plain versions) against the reference's device scheduler:
    the accounting, the idle flushes, the re-asks (pure hits) and their
    answers equal, and equal a cold solve; a withdrawal round's UNSAT
    pre-solves are cached too."""
    def run(side):
        if side == "reference":
            s = JScheduler(backend="tpu", **REF)
        else:
            s = Scheduler(device="cpu")
        s.start()
        try:
            fams = _publish_families(side, 2)
            for f in fams:
                s.submit([f])
            outs, answers = [], []
            for d in (_round(side, 0),
                      delta(side, {"removed": ["p.b0v1"]})):
                outs.append(s.speculate.publish(d))
                drain(s, timeout=120.0)
                for i, f in enumerate(fams):
                    fams[i] = list(d.apply(f))
                    st: dict = {}
                    (res,) = s.submit([fams[i]], stats=st)
                    answers.append((st["steps"], st["report"] is None,
                                    rendered(side, res)))
            return outs, answers, s._c_flushes.value.get("spec", 0)
        finally:
            s.stop()
    want, got = both(run)
    assert got == want
    outs, answers, spec = got
    # Withdrawn, b0v1 no longer tells the two families apart: one key.
    assert [o["queued"] for o in outs] == [2, 1] and spec >= 2
    assert all(a[0] == 0 and a[1] for a in answers)
    assert [json.loads(a[2])["status"] for a in answers] == \
        ["sat", "sat", "unsat", "unsat"]


def _publish_families(side: str, n: int, n_bundles: int = 2,
                      bundle_size: int = 8):
    if side == "reference":
        return [jpublish.catalog_family("p", f, n_bundles, bundle_size)
                for f in range(n)]
    return [catalog_family("p", f, n_bundles, bundle_size)
            for f in range(n)]


def _round(side: str, rnd: int, n_bundles: int = 2, bundle_size: int = 8):
    if side == "reference":
        return jpublish.round_delta("p", rnd, n_bundles, bundle_size)
    return round_delta("p", rnd, n_bundles, bundle_size)


# ------------------------------------------------------------ the workload


@pytest.mark.parametrize("family,rnd,n_bundles,bundle_size", [
    (0, 0, 8, 16), (5, 3, 8, 16), (255, 7, 8, 16), (3, 9, 4, 8),
    (1, 2, 2, 6)])
def test_generators_equal_the_reference(family, rnd, n_bundles,
                                        bundle_size):
    want_vs = jpublish.catalog_family("g", family, n_bundles, bundle_size)
    got_vs = catalog_family("g", family, n_bundles, bundle_size)
    assert vars_doc("port", got_vs) == vars_doc("reference", want_vs)
    jd = jpublish.round_delta("g", rnd, n_bundles, bundle_size)
    td = round_delta("g", rnd, n_bundles, bundle_size)
    assert td.changed_identifiers() == jd.changed_identifiers()
    assert vars_doc("port", td.apply(got_vs)) == \
        vars_doc("reference", jd.apply(want_vs))
    assert len(got_vs) == n_bundles * bundle_size


def _replay(phase: str, speculate: bool, n_families: int, rounds: int,
            n_bundles: int, bundle_size: int) -> dict:
    """``deppy_tpu/benchmarks/publish.py:102-153`` on the port: warm-up
    queries, then rounds of publish (on only), drain and re-asks."""
    sched = Scheduler(backend="host", speculate="on" if speculate else "off")
    sched.start()
    try:
        families = [catalog_family(phase, f, n_bundles, bundle_size)
                    for f in range(n_families)]
        for fam in families:
            sched.submit([fam])
        hits, out = 0, []
        for rnd in range(rounds):
            d = round_delta(phase, rnd, n_bundles, bundle_size)
            if speculate:
                sched.speculate.publish(d)
                drain(sched)
            for f in range(n_families):
                applied = d.apply(families[f])
                if applied is not None:
                    families[f] = list(applied)
                st: dict = {}
                (res,) = sched.submit([families[f]], stats=st)
                hits += st["steps"] == 0 and st["report"] is None
                out.append(tio.result_to_dict(res))
        return {"rendered": out, "hit_ratio": round(hits / len(out), 4)}
    finally:
        sched.stop()


@pytest.mark.parametrize("speculate", [True, False], ids=["on", "off"])
@within(240)
def test_small_replay_equals_the_reference_s(speculate, monkeypatch):
    """4 families, 2 rounds, 4 bundles of 8: the rendered responses and
    the hit ratio equal ``deppy_tpu.benchmarks.publish.replay``'s."""
    monkeypatch.setattr(jpublish, "DRAIN_SETTLE_S", 0.1)
    want = jpublish.replay("r", speculate, 4, 2, 4, 8)
    got = _replay("r", speculate, 4, 2, 4, 8)
    assert got["rendered"] == want["rendered"]
    assert got["hit_ratio"] == want["hit_ratio"]
    assert got["hit_ratio"] == (1.0 if speculate else 0.0)


def test_fresh_process_publish_loads_no_jax():
    """A publish, its drain and a preview on the CPU scheduler import
    nothing of JAX or deppy_tpu."""
    code = textwrap.dedent("""
        import sys, time
        before = set(sys.modules)
        from deppy_tpu_torch.models import catalog_family, round_delta
        from deppy_tpu_torch.sched import Scheduler
        sched = Scheduler(device="cpu")
        sched.start()
        try:
            fams = [catalog_family("f", i, 2, 6) for i in range(2)]
            for f in fams:
                sched.submit([f])
            d = round_delta("f", 0, 2, 6)
            out = sched.speculate.publish(d)
            while sched.speculative_depth():
                time.sleep(0.01)
            preview = sched.speculate.preview(round_delta("f", 1, 2, 6))
        finally:
            sched.stop()
        assert out["queued"] == 2 and len(preview) == 2, (out, preview)
        new = set(sys.modules) - before
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "deppy_tpu"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
