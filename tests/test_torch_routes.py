"""The port's route-health plane against the JAX package's.

The cases of ``tests/test_routes.py`` on both packages with the same
inputs, on the CPU: ``deppy_tpu.routes`` beside ``deppy_tpu_torch.routes``
(the regret ledger, the staleness watcher, the shadow sampler, the
defaults store's writer, the online registry, the plane and the offline
report), each fed the same events or rows, with snapshots, emitted
events (their ``ts`` aside) and rendered metric lines equal; the
adversarial learned-row differential on the port's CPU scheduler; a
deterministic shadow dispatch and a scripted shadow fault on both
packages' CPU schedulers; the ``route_wave`` generator against the
reference bench's; and the ``DEPPY_GPU_ROUTE_*`` knobs, read as the
reference reads its ``DEPPY_TPU_ROUTE_*``.

Every comparison is exact, except a shadow ``route`` event's ``wall_s``
(a wall clock) and a ``route_stale`` verdict's ``age_s`` (seconds since
the row's stamp, read at different instants).

The reference's fleet rollups (``TestFleetRollups``) come with ROADMAP
A5.6.5 and A5.6.7, its ``deppy routes`` CLI cases with A7.2.
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

import pytest

from deppy_tpu import faults as jfaults
from deppy_tpu import io as jio
from deppy_tpu import routes as jroutes
from deppy_tpu import sat as jsat
from deppy_tpu import telemetry as jtelemetry
from deppy_tpu.benchmarks import routes as jbench
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import defaults_store as jstore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.engine import registry as jregistry
from deppy_tpu.models import random_instance as jrandom
from deppy_tpu.routes import report as jreport
from deppy_tpu.routes.learn import OnlineRouteRegistry as JLearner
from deppy_tpu.routes.ledger import RegretLedger as JLedger
from deppy_tpu.routes.shadow import ShadowSampler as JSampler
from deppy_tpu.routes.staleness import StalenessWatcher as JWatcher
from deppy_tpu.sched import Scheduler as JScheduler
from deppy_tpu.sched import scheduler as jsched_mod
from deppy_tpu_torch import faults as tfaults
from deppy_tpu_torch import io as tio
from deppy_tpu_torch import routes as troutes
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch import telemetry as ttelemetry
from deppy_tpu_torch.engine import defaults as tstore
from deppy_tpu_torch.engine import registry as tregistry
from deppy_tpu_torch.models import random_instance as trandom
from deppy_tpu_torch.models import route_wave
from deppy_tpu_torch.routes import report as treport
from deppy_tpu_torch.routes.learn import OnlineRouteRegistry as TLearner
from deppy_tpu_torch.routes.ledger import RegretLedger as TLedger
from deppy_tpu_torch.routes.shadow import ShadowSampler as TSampler
from deppy_tpu_torch.routes.staleness import StalenessWatcher as TWatcher
from deppy_tpu_torch.sched import Scheduler as TScheduler
from deppy_tpu_torch.sched import scheduler as tsched_mod

ROOT = Path(__file__).resolve().parents[1]
STALE_TS = 1000.0  # 1970: older than any max age
SIDES = {
    "reference": dict(
        routes=jroutes, ledger=JLedger, watcher=JWatcher, sampler=JSampler,
        learner=JLearner, registry=jregistry, store=jstore, report=jreport,
        telemetry=jtelemetry, faults=jfaults, io=jio, sat=jsat,
        random=jrandom),
    "port": dict(
        routes=troutes, ledger=TLedger, watcher=TWatcher, sampler=TSampler,
        learner=TLearner, registry=tregistry, store=tstore, report=treport,
        telemetry=ttelemetry, faults=tfaults, io=tio, sat=tsat,
        random=trandom),
}
KNOB_NAMES = ("ROUTE_LEARN", "ROUTE_DECAY", "ROUTE_MAX_AGE_S",
              "ROUTE_SHADOW_RATE", "ROUTE_MIN_SAMPLES", "ROUTE_REGISTRY")


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
def fresh_state(monkeypatch, tmp_path):
    """Each package's fault plan, breaker and default registry; no route
    knob set; no measured rows (an empty registry file on both sides);
    inline host lanes; the overlays and planes cleared after."""
    monkeypatch.setattr(jdriver, "STAGE1_STEPS", 0)
    for name in KNOB_NAMES:
        monkeypatch.delenv(f"DEPPY_GPU_{name}", raising=False)
        monkeypatch.delenv(f"DEPPY_TPU_{name}", raising=False)
    monkeypatch.setenv("DEPPY_GPU_HOST_WORKERS", "0")
    monkeypatch.setenv("DEPPY_TPU_HOST_WORKERS", "0")
    install_rows(monkeypatch, tmp_path / "none.json")
    prev_breakers = (jfaults.set_default_breaker(jfaults.CircuitBreaker()),
                     tfaults.set_default_breaker(tfaults.CircuitBreaker()))
    prev_plans = (jfaults.configure_plan(None), tfaults.configure_plan(None))
    prev = (jtelemetry.set_default_registry(jtelemetry.Registry()),
            ttelemetry.set_default_registry(ttelemetry.Registry()))
    yield
    for side in SIDES.values():
        side["routes"].stop_plane()
    jregistry.set_route_overlay({})
    for device in ("cpu", "cuda"):
        tregistry.set_route_overlay({}, device)
    jsched_mod._join_race_threads()
    tsched_mod._join_race_threads()
    tstore.reload_measured_defaults()
    jtelemetry.set_default_registry(prev[0])
    ttelemetry.set_default_registry(prev[1])
    jfaults.configure_plan(prev_plans[0])
    tfaults.configure_plan(prev_plans[1])
    jfaults.set_default_breaker(prev_breakers[0])
    tfaults.set_default_breaker(prev_breakers[1])


def install_rows(monkeypatch, path: Path) -> None:
    """Point both packages' measured-defaults readers at ``path``: the
    reference's memoized module path and its store's env knob, and the
    port's ``DEPPY_GPU_MEASURED_DEFAULTS``."""
    monkeypatch.setenv("DEPPY_TPU_MEASURED_DEFAULTS", str(path))
    monkeypatch.setattr(jcore, "_MEASURED_DEFAULTS_PATH", str(path))
    monkeypatch.setattr(jcore, "_MEASURED_DEFAULTS", None)
    monkeypatch.setenv("DEPPY_GPU_MEASURED_DEFAULTS", str(path))
    tstore.reload_measured_defaults()


def both(fn):
    """``fn(side)`` for the reference, then the port: (want, got)."""
    return fn("reference"), fn("port")


def capture(registry):
    events = []
    registry.add_forwarder(events.append)
    return events


def strip(events, *drop):
    """Events without their ``ts`` (and ``drop``'s fields)."""
    return [{k: v for k, v in e.items() if k not in ("ts",) + drop}
            for e in events]


def _race(cls="m", winner="host", default="device", lanes=4,
          wall=0.04, losers=None, **extra):
    """The reference suite's race event (``tests/test_routes.py:46-55``)."""
    ev = {"kind": "race", "size_class_name": cls, "winner": winner,
          "canonical": "device", "default": default,
          "entrants": ["device", "host"], "lanes": lanes,
          "cancelled": [], "win_margin_s": 0.01, "checked": None,
          "wall_s": wall}
    ev["losers"] = losers if losers is not None else []
    ev.update(extra)
    return ev


def _shadow(cls="m", backend="device", lanes=1, wall=0.1, ok=True,
            **extra):
    return {"kind": "route", "phase": "shadow", "size_class_name": cls,
            "backend": backend, "lanes": lanes, "wall_s": wall, "ok": ok,
            **extra}


# ------------------------------------------------------- regret ledger


def _ledger_state(side: str, events, decay=None, replica=None) -> dict:
    led = SIDES[side]["ledger"](decay=decay)
    for ev in events:
        led.fold(ev)
    return dict(estimates=led.estimates(), snapshot=led.snapshot(),
                shadow=led.shadow_counts(),
                lines=led.render_metric_lines(replica=replica))


def test_ledger_uncensored_loser_feeds_estimate_and_regret():
    evs = [_race(winner="host", default="device", wall=0.01, lanes=1,
                 losers=[{"backend": "device", "wall_s": 0.05,
                          "censored": False}])]
    want, got = both(lambda s: _ledger_state(s, evs, decay=0.5))
    assert got == want
    assert got["estimates"]["m"]["host"]["us_per_lane"] == 10000.0
    assert got["estimates"]["m"]["device"]["us_per_lane"] == 50000.0
    assert got["snapshot"]["m"]["regret_s"] == {"device": 0.04}
    assert got["snapshot"]["m"]["win_share"] == {"host": 1.0}


def test_ledger_censored_loser_never_feeds_an_estimate():
    evs = [_race(losers=[{"backend": "device", "wall_s": 0.011,
                          "censored": True}])]
    want, got = both(lambda s: _ledger_state(s, evs))
    assert got == want
    est = got["estimates"]["m"]
    assert est["device"]["us_per_lane"] is None
    assert est["device"]["censored"] == 1
    assert got["snapshot"]["m"]["regret_s"] == {}


def test_ledger_censored_default_falls_back_to_decayed_estimate():
    evs = [_shadow(wall=0.1),
           _race(winner="host", default="device", wall=0.02, lanes=1,
                 losers=[{"backend": "device", "wall_s": 0.021,
                          "censored": True}])]
    want, got = both(lambda s: _ledger_state(s, evs, decay=1.0))
    assert got == want
    assert got["snapshot"]["m"]["regret_s"]["device"] == pytest.approx(0.08)


def test_ledger_failed_shadow_counts_without_estimating():
    evs = [_shadow(backend="grad_relax", lanes=2, wall=0.5, ok=False,
                   error="Boom")]
    want, got = both(lambda s: _ledger_state(s, evs))
    assert got == want
    assert got["shadow"] == {"grad_relax": {"dispatches": 1, "failed": 1}}
    assert "grad_relax" not in got["estimates"].get("m", {})


def test_ledger_no_winner_and_resubmit_markers_fold_cleanly():
    evs = [{"kind": "race", "size_class_name": "m",
            "entrants": ["device", "host"], "lanes": 2,
            "default": "device", "winner": None},
           {"kind": "race", "size_class_name": "m", "resubmitted": 2}]
    want, got = both(lambda s: _ledger_state(s, evs))
    assert got == want
    assert got["snapshot"]["m"]["races"] == 0
    assert got["snapshot"]["m"]["no_winner"] == 1


def test_ledger_render_families_only_when_fed():
    assert TLedger().render_metric_lines() == \
        JLedger().render_metric_lines() == []
    evs = [_race(losers=[{"backend": "device", "wall_s": 0.09,
                          "censored": False}]),
           _shadow(backend="host", wall=0.02)]
    want, got = both(lambda s: _ledger_state(s, evs, replica="r1"))
    assert got == want
    text = "\n".join(got["lines"])
    for family in ("deppy_route_regret_seconds_total",
                   "deppy_route_win_share",
                   "deppy_route_shadow_dispatches_total"):
        assert family in text
    assert 'replica="r1"' in text


# ---------------------------------------------------------- staleness


def _watch(side: str, rows_doc, ops, max_age_s=None):
    """A watcher on ``rows_doc`` fed ``ops`` (a class name observes it,
    ``("fresh", cls)`` marks it fresh, ``("reload", doc)`` re-reads the
    registry): the reasons, the ``route_stale`` events, the status, the
    gauge lines and the count."""
    t = SIDES[side]["telemetry"]
    reg = t.Registry()
    events = capture(reg)
    w = SIDES[side]["watcher"](platform="cpu", registry=reg,
                               rows_doc=rows_doc, box="here",
                               max_age_s=max_age_s)
    reasons = []
    for op in ops:
        if isinstance(op, tuple):
            if op[0] == "fresh":
                w.mark_fresh(op[1])
            else:
                w.reload(op[1])
            continue
        reasons.append(w.observe(op))
    status = {c: {k: v for k, v in s.items() if k != "age_s"}
              for c, s in w.status().items()}
    return dict(reasons=reasons, events=strip(events, "age_s"),
                status=status, lines=w.render_metric_lines(replica="r"),
                count=w.stale_count())


def test_staleness_missing_row_flags_once_per_crossing():
    want, got = both(lambda s: _watch(s, {}, ["m", "m"]))
    assert got == want
    assert got["reasons"] == ["missing", "missing"]
    assert [e["reason"] for e in got["events"]] == ["missing"]
    assert got["events"][0]["size_class_name"] == "m"
    assert got["count"] == 1


def test_staleness_stale_then_fresh_then_stale_re_arms():
    doc = {"cpu": {"portfolio": "host,device",
                   "evidence": {"portfolio": {"ts": STALE_TS,
                                              "box": "here"}}}}
    want, got = both(lambda s: _watch(s, doc, ["m", ("fresh", "m"), "m"],
                                      max_age_s=60.0))
    assert got == want
    assert got["reasons"] == ["stale", None]
    assert got["count"] == 0
    assert [e["reason"] for e in got["events"]] == ["stale"]


def test_staleness_foreign_box_and_no_provenance():
    now = time.time()
    doc = {"cpu": {"portfolio.m": "host,device",
                   "portfolio.l": "device,host",
                   "evidence": {"portfolio.m": {"ts": now,
                                                "box": "elsewhere"}}}}
    want, got = both(lambda s: _watch(s, doc, ["m", "l"],
                                      max_age_s=3600.0))
    assert got == want
    assert got["reasons"] == ["foreign_box", "no_provenance"]
    assert {e["size_class_name"]: e["reason"] for e in got["events"]} == \
        {"m": "foreign_box", "l": "no_provenance"}
    assert got["count"] == 2


def test_staleness_reason_change_is_a_new_crossing():
    stale = {"cpu": {"portfolio": "host,device",
                     "evidence": {"portfolio": {"ts": STALE_TS,
                                                "box": "here"}}}}
    want, got = both(lambda s: _watch(s, {}, ["m", ("reload", stale), "m"]))
    assert got == want
    assert got["reasons"] == ["missing", "stale"]
    assert [e["reason"] for e in got["events"]] == ["missing", "stale"]


def test_staleness_fresh_row_never_flags():
    doc = {"cpu": {"portfolio": "host,device",
                   "evidence": {"portfolio": {"ts": time.time(),
                                              "box": "here"}}}}
    want, got = both(lambda s: _watch(s, doc, ["m"], max_age_s=3600.0))
    assert got == want
    assert got["reasons"] == [None]
    assert got["events"] == [] and got["count"] == 0


# ------------------------------------------------------ shadow sampler


def _sampler(side: str, rate, calls, device="cpu"):
    kw = {} if side == "reference" else {"device": device}
    s = SIDES[side]["sampler"](rate=rate, **kw)
    picks = [s.pick(cls, exclude=ex) for cls, ex in calls]
    return dict(interval=s.interval, picks=picks,
                field=s.candidates("m", exclude=["device"]))


def test_sampler_deterministic_interval_and_rotation():
    calls = [("m", ["device"])] * 6
    want, got = both(lambda s: _sampler(s, 0.5, calls))
    assert got == want
    picks = got["picks"]
    assert picks[1] is picks[3] is picks[5] is None
    chosen = [p for p in picks if p is not None]
    assert len(chosen) == 3 and "device" not in chosen
    assert set(chosen) <= set(got["field"])
    if len(got["field"]) > 1:
        assert len(set(chosen[:2])) == 2  # rotation, not repetition


def test_sampler_rate_zero_never_picks():
    want, got = both(lambda s: _sampler(s, 0.0, [("m", [])]))
    assert got == want
    assert got["interval"] == 0 and got["picks"] == [None]


def test_sampler_full_exclusion_yields_none():
    everyone = list(tregistry.specs())
    assert everyone == list(jregistry.specs())
    want, got = both(lambda s: _sampler(s, 1.0, [("m", everyone)]))
    assert got == want and got["picks"] == [None]


def test_sampler_per_class_counters_are_independent():
    want, got = both(lambda s: _sampler(s, 0.5, [("m", []), ("l", []),
                                                  ("m", []), ("l", [])]))
    assert got == want
    assert got["picks"][0] is not None and got["picks"][1] is not None
    assert got["picks"][2] is None and got["picks"][3] is None


# ------------------------------------------------------ defaults store


def _stamps(doc: dict) -> dict:
    """A registry document with its stamps' ``ts`` and ``box`` reduced
    to their presence."""
    out = json.loads(json.dumps(doc))
    for entry in out.values():
        for stamp in (entry.get("evidence") or {}).values():
            assert stamp.pop("ts") > 0 and stamp.pop("box")
    return out


def test_store_merge_preserves_siblings_and_stamps_provenance(tmp_path):
    def run(side):
        st = SIDES[side]["store"]
        p = str(tmp_path / f"{side}.json")
        st.merge_rows("cpu", {"portfolio": "host,device"},
                      evidence={"platform": "cpu"}, path=p)
        st.merge_rows("cpu", {"bcp": "watched"}, path=p)
        st.merge_rows("gpu", {"portfolio.s": "device,host"},
                      evidence={"samples": 4, "ts": STALE_TS}, path=p)
        return dict(doc=_stamps(st.read_rows(p)),
                    stamp=st.provenance("cpu", "portfolio", path=p),
                    sibling=st.provenance("cpu", "bcp", path=p),
                    gpu=st.provenance("gpu", "portfolio.s", path=p),
                    none=st.provenance("cpu", "nope", path=p),
                    text=Path(p).read_text().splitlines()[0])
    want, got = both(run)
    for d in (want, got):
        for k in ("stamp", "sibling"):
            assert d[k].pop("ts") > 0 and d[k].pop("box")
    assert got == want
    assert got["doc"]["cpu"]["portfolio"] == "host,device"
    assert got["doc"]["cpu"]["bcp"] == "watched"
    assert got["stamp"] == {"platform": "cpu"}
    assert got["sibling"] == {}  # the second merge stamped only its key
    assert got["gpu"]["ts"] == STALE_TS and got["none"] is None


def test_store_concurrent_writers_compose_under_the_flock(tmp_path):
    p = str(tmp_path / "measured.json")
    errors = []

    def write(store, key, val):
        try:
            for _ in range(10):
                store.merge_rows("cpu", {key: val}, path=p)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    # The port's writer and the reference's share the lock file's
    # protocol, so they compose on one registry too.
    threads = [threading.Thread(target=write,
                                args=(tstore if i % 2 else jstore,
                                      f"k{i}", f"v{i}"))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    doc = tstore.read_rows(p)["cpu"]
    assert {doc[f"k{i}"] for i in range(4)} == {f"v{i}" for i in range(4)}
    assert set(doc["evidence"]) == {f"k{i}" for i in range(4)}


def test_store_corrupt_registry_reads_empty(tmp_path):
    p = tmp_path / "measured.json"
    for bad in ("{not json", "[1, 2]"):
        p.write_text(bad)
        assert tstore.read_rows(str(p)) == jstore.read_rows(str(p)) == {}
        assert tstore.provenance("cpu", "portfolio", path=str(p)) is None


# ------------------------------------------------------------ learning


class _FakeLedger:
    def __init__(self, est):
        self._est = est

    def estimates(self):
        return self._est


def _learner(side: str, est, min_samples=2, watcher=None):
    t = SIDES[side]["telemetry"]
    reg = t.Registry()
    events = capture(reg)
    learner = SIDES[side]["learner"](
        _FakeLedger(est), min_samples=min_samples, platform="cpu",
        registry=reg, watcher=watcher)
    return learner, events


def test_learn_adopts_when_measurement_beats_served_head():
    est = {"m": {"host": {"us_per_lane": 50.0, "samples": 4},
                 "device": {"us_per_lane": 900.0, "samples": 4}}}

    def run(side):
        learner, events = _learner(side, est)
        row = learner.consider("m")
        overlay = SIDES[side]["registry"].route_overlay()
        ranked = SIDES[side]["registry"].ranked("m")
        again = learner.consider("m")
        return dict(row=row, overlay=overlay, ranked=ranked, again=again,
                    events=strip(events), lines=learner.render_metric_lines(),
                    adopted=learner.adopted())
    want, got = both(run)
    assert got == want
    assert got["row"] == "host,device"
    assert got["overlay"] == {"portfolio.m": "host,device"}
    assert got["ranked"] == (["host", "device"], True)
    assert [e["source"] for e in got["events"]] == ["live"]
    assert got["events"][0]["est_us_per_lane"]["host"] == 50.0
    assert got["again"] is None


def test_learn_agreeing_measurement_never_churns():
    served, _ = tregistry.ranked("m")
    assert served == jregistry.ranked("m")[0]
    est = {"m": {served[0]: {"us_per_lane": 10.0, "samples": 9},
                 "host": {"us_per_lane": 99.0, "samples": 9}}}

    def run(side):
        learner, events = _learner(side, est)
        return (learner.consider("m"),
                SIDES[side]["registry"].route_overlay(), strip(events))
    want, got = both(run)
    assert got == want == (None, {}, [])


def test_learn_min_samples_gates_eligibility():
    est = {"m": {"host": {"us_per_lane": 50.0, "samples": 1},
                 "device": {"us_per_lane": 900.0, "samples": 9}}}

    def run(side):
        learner, _ = _learner(side, est, min_samples=4)
        return learner.consider("m"), learner.min_samples
    want, got = both(run)
    assert got == want == (None, 4)


def test_learn_adopt_validates_rows_and_marks_fresh():
    def run(side):
        t = SIDES[side]["telemetry"]
        watcher = SIDES[side]["watcher"](platform="cpu",
                                         registry=t.Registry(),
                                         rows_doc={}, box="here")
        watcher.observe("m")
        before = watcher.stale_count()
        learner, events = _learner(side, {}, watcher=watcher)
        applied = learner.adopt(
            {"portfolio.m": "host, device, nonsense",
             "portfolio.x": "onlyone",
             "not_a_portfolio_key": "host,device",
             "portfolio.l": 7},
            source="gossip", origin="peer:1")
        return dict(before=before, applied=applied,
                    after=watcher.stale_count(), events=strip(events))
    want, got = both(run)
    assert got == want
    assert got["applied"] == {"portfolio.m": "host,device"}
    assert (got["before"], got["after"]) == (1, 0)
    assert got["events"][0]["origin"] == "peer:1"


def test_learn_gossip_ingress_requires_a_learning_plane():
    def run(side):
        r = SIDES[side]["routes"]
        reg = SIDES[side]["registry"]
        out = [r.adopt_remote({"portfolio.m": "host,device"})]
        plane = r.start_plane(None, mode="observe")
        out.append((plane is not None, plane.learner is None,
                    r.adopt_remote({"portfolio.m": "host,device"})))
        r.stop_plane()
        r.start_plane(None, mode="on")
        out.append(r.adopt_remote({"portfolio.m": "host,device"},
                                  origin="peer:9"))
        out.append(reg.route_overlay())
        r.stop_plane()
        # Plane shutdown clears its adopted rows from the overlay.
        out.append(reg.route_overlay())
        return out
    want, got = both(run)
    assert got == want
    assert got == [{}, (True, True, {}), {"portfolio.m": "host,device"},
                   {"portfolio.m": "host,device"}, {}]


def test_overlay_rows_are_kept_per_platform():
    """A row learned by a CPU scheduler's plane reorders that platform's
    ranking only: a card scheduler in the same process races as before
    (the reference has one platform a process, so this is the port's
    own)."""
    frozen = tregistry.ranked("m", "cuda")
    learner = TLearner(_FakeLedger({"m": {
        "host": {"us_per_lane": 50.0, "samples": 4},
        "device": {"us_per_lane": 900.0, "samples": 4}}}),
        min_samples=2, registry=ttelemetry.Registry(), device="cpu")
    assert learner.platform == "cpu"
    assert learner.consider("m") == "host,device"
    assert tregistry.route_overlay("cpu") == {"portfolio.m": "host,device"}
    assert tregistry.ranked("m", "cpu") == (["host", "device"], True)
    assert tregistry.route_overlay("cuda") == {}
    assert tregistry.ranked("m", "cuda") == frozen
    tregistry.set_route_overlay({"portfolio.m": "grad_relax,host"}, "cuda")
    assert tregistry.ranked("m", "cuda") == (["grad_relax", "host"], True)
    assert tregistry.ranked("m", "cpu") == (["host", "device"], True)


# ------------------------------------------------------- plane + modes


def test_plane_resolve_mode_ladder():
    for raw in ("off", "0", "no", "false", "", "on", "learn", "1", "yes",
                "observe", "anything-else", " ON "):
        assert troutes.resolve_mode(raw) == jroutes.resolve_mode(raw)
    assert [troutes.resolve_mode(m) for m in ("off", "learn", "x")] == \
        ["off", "on", "observe"]
    assert troutes.MODES == jroutes.MODES


def test_plane_mode_off_constructs_nothing():
    for r in (jroutes, troutes):
        assert r.start_plane(None, mode="off") is None
        assert r.active_plane() is None
        assert r.render_metric_lines() == []


def test_plane_forwarder_never_raises():
    for side in SIDES.values():
        plane = side["routes"].RoutePlane(
            mode="on", registry=side["telemetry"].Registry())
        plane.ledger.fold = lambda ev: 1 / 0
        plane({"kind": "race", "size_class_name": "m"})  # must swallow
        plane.learner.consider = lambda cls: 1 / 0
        plane({"kind": "route", "size_class_name": "m"})


def test_plane_observe_mode_folds_races_from_the_registry():
    def run(side):
        reg = SIDES[side]["telemetry"].Registry()
        plane = SIDES[side]["routes"].RoutePlane(mode="observe",
                                                 registry=reg)
        plane.install()
        try:
            reg.event(**{k: v for k, v in _race().items()
                         if k != "kind"}, kind="race")
            reg.event(**{k: v for k, v in _shadow().items()
                         if k != "kind"}, kind="route")
            reg.event("fault", fault="other")
            return plane.snapshot(), plane.render_metric_lines()
        finally:
            plane.close()
    want, got = both(run)
    assert got == want
    snap = got[0]
    assert snap["classes"]["m"]["races"] == 1
    assert snap["mode"] == "observe" and "learned" not in snap


# ------------------------------------------------------- offline report


REPORT_EVENTS = [
    dict(_race(winner="host", default="device", wall=0.01, lanes=1,
               losers=[{"backend": "device", "wall_s": 0.05,
                        "censored": False}]),
         ts=1.0, platform="cpu"),
    {"ts": 2.0, "kind": "route_stale", "reason": "stale",
     "size_class_name": "m", "key": "portfolio", "age_s": 999.0,
     "row": "device,host", "platform": "cpu"},
    {"ts": 3.0, "kind": "route", "phase": "shadow",
     "size_class_name": "m", "backend": "grad_relax", "lanes": 1,
     "wall_s": 0.002, "ok": True},
    {"ts": 4.0, "kind": "route_learned", "key": "portfolio.m",
     "row": "host,device", "size_class_name": "m",
     "source": "live", "platform": "cpu",
     "est_us_per_lane": {"host": 10000.0, "device": 50000.0}},
]


def _report(side: str, events, **kw):
    rep = SIDES[side]["report"]
    doc = rep.build_report(iter(events), **kw)
    return doc, rep.render_text(doc)


def test_report_reconstructs_the_table():
    want, got = both(lambda s: _report(s, REPORT_EVENTS))
    assert got == want
    doc = got[0]
    m = doc["classes"]["m"]
    assert m["races"] == 1 and m["regret_s"] == {"device": 0.04}
    assert m["learned"]["row"] == "host,device"
    assert m["stale"] is None  # the adoption supersedes the flag
    assert doc["totals"] == {"races": 1, "regret_s": 0.04,
                             "stale_classes": 0, "learned_rows": 1}
    assert doc["shadow"]["grad_relax"]["dispatches"] == 1


def test_report_stale_without_adoption_stays_flagged():
    want, got = both(lambda s: _report(s, REPORT_EVENTS[:3]))
    assert got == want
    assert got[0]["classes"]["m"]["stale"]["reason"] == "stale"
    assert got[0]["totals"]["stale_classes"] == 1


def test_report_registry_provenance_joins():
    rows_doc = {"cpu": {"portfolio": "device,host", "evidence": {
        "portfolio": {"ts": 1000.0, "box": "elsewhere"}}}}
    want, got = both(lambda s: _report(s, REPORT_EVENTS[:2],
                                       rows_doc=rows_doc))
    assert got == want
    reg = got[0]["classes"]["m"]["registry"]
    assert reg["row"] == "device,host"
    assert reg["evidence"]["box"] == "elsewhere"
    empty = both(lambda s: _report(s, [None, {"kind": "other"}]))
    assert empty[0] == empty[1]


# ---------------------------------- adversarial learned rows (scheduler)


def _requests(side: str):
    m = SIDES[side]["sat"]

    def chain(d):
        vs = [m.variable("a0", m.mandatory(), m.dependency("a1"))]
        vs += [m.variable(f"a{i}", m.dependency(f"a{i + 1}"))
               for i in range(1, d - 1)]
        vs.append(m.variable(f"a{d - 1}"))
        return vs

    reqs = [chain(24), chain(48)]
    reqs += [SIDES[side]["random"](length=12, seed=s) for s in range(3)]
    reqs.append([m.variable("u0", m.mandatory(), m.dependency("u1")),
                 m.variable("u1", m.prohibited())])
    return reqs


def _scheduler(side: str, **kw):
    if side == "reference":
        return JScheduler(backend="auto", **kw)
    return TScheduler(device="cpu", backend="auto", **kw)


def _render(side: str, results):
    io = SIDES[side]["io"]
    return [json.dumps(io.result_to_dict(r), sort_keys=True)
            for r in results]


@within(300)
def test_worst_row_everywhere_changes_speed_never_answers():
    """The worst-first learned row on every class, raced with every
    non-canonical win checked: the answers of the unraced scheduler,
    equal to the reference's under the same overlay."""
    def run(side):
        reqs = _requests(side)
        baseline = _render(side, _scheduler(side, portfolio="off")
                           .submit(reqs))
        static = list(SIDES[side]["registry"].specs())
        worst_first = ",".join(reversed(
            [n for n in static if n in ("device", "host", "grad_relax")]))
        # The port keeps overlay rows per platform; its scheduler serves
        # on the CPU.
        on = {"device": "cpu"} if side == "port" else {}
        SIDES[side]["registry"].set_route_overlay(
            {f"portfolio.{c}": worst_first
             for c in ("xs", "s", "m", "l", "xl")}, **on)
        try:
            raced = _render(side, _scheduler(
                side, portfolio="on", portfolio_sample_check=1.0)
                .submit(reqs))
        finally:
            SIDES[side]["registry"].set_route_overlay({}, **on)
        return worst_first, baseline, raced
    want, got = both(run)
    assert got[0] == want[0] == "grad_relax,host,device"
    assert got[2] == got[1] == want[1] == want[2]


@within(120)
def test_learn_off_scheduler_registers_no_route_families():
    reg = ttelemetry.Registry()
    sched = TScheduler(device="cpu", backend="auto", portfolio="off",
                       registry=reg)
    sched.submit(_requests("port")[:2])
    assert troutes.resolve_mode() == "off"
    assert troutes.start_plane(sched) is None
    assert sched._route_plane is None
    assert not any(k.startswith("deppy_route") for k in reg.snapshot())
    assert not any(k.startswith("deppy_route")
                   for k in ttelemetry.default_registry().snapshot())
    assert troutes.render_metric_lines() == []


# ------------------------------------------------ shadow dispatches


WAVES = 3
WAVE = (12, 3)  # depth, lanes


class _Shadows:
    """The scheduler's ``submit_shadow`` calls and the ``route`` events
    of the default registry, so a caller can wait until every accepted
    probe has reported."""

    def __init__(self, side: str, sched):
        self.calls = []
        self.events = []
        orig = sched.submit_shadow

        def submit_shadow(backend, cls, problems, max_steps=None):
            ok = orig(backend, cls, problems, max_steps=max_steps)
            self.calls.append((backend, cls, len(problems), ok))
            return ok

        sched.submit_shadow = submit_shadow
        SIDES[side]["telemetry"].default_registry().add_forwarder(
            lambda e: self.events.append(e)
            if e.get("kind") in ("route", "route_stale") else None)

    def routes(self):
        return [e for e in self.events if e["kind"] == "route"]

    def wait(self, timeout: float = 120.0) -> None:
        t0 = time.monotonic()
        while (len(self.routes()) < sum(c[3] for c in self.calls)
               and time.monotonic() - t0 < timeout):
            time.sleep(0.005)
        assert len(self.routes()) == sum(c[3] for c in self.calls)


def _stale_row(monkeypatch, tmp_path):
    path = tmp_path / "stale.json"
    tstore.merge_rows("cpu", {"portfolio": "host,grad_relax,device"},
                      evidence={"ts": STALE_TS, "samples": 4},
                      path=str(path))
    install_rows(monkeypatch, path)


def _shadow_run(side: str, plane: bool, waves: int = WAVES):
    """``waves`` route waves, one submit each, on a host-backend
    scheduler (racing off) with an ``observe`` plane at shadow rate 1.0
    when ``plane``; each wave's probe reports before the next wave."""
    if side == "reference":
        sched = JScheduler(backend="host", portfolio="off")
    else:
        sched = TScheduler(device="cpu", backend="host", portfolio="off")
    sched.start()
    shadows = _Shadows(side, sched)
    try:
        if plane:
            p = SIDES[side]["routes"].start_plane(sched, mode="observe",
                                                  shadow_rate=1.0)
            assert p is not None and sched._route_plane is p
        rendered = []
        for i in range(waves):
            if side == "reference":
                wave = jbench._wave_vars(*WAVE, f"w{i}", unsat=(i % 4 != 1))
            else:
                wave = route_wave(*WAVE, f"w{i}", unsat=(i % 4 != 1))
            rendered += _render(side, sched.submit(wave))
            shadows.wait()
        snap = (SIDES[side]["routes"].active_plane().snapshot()
                if plane else None)
        return dict(rendered=rendered, calls=shadows.calls,
                    routes=strip(shadows.routes(), "wall_s"),
                    stale=strip([e for e in shadows.events
                                 if e["kind"] == "route_stale"], "age_s"),
                    cache=sorted(sched.cache._entries),
                    index=sorted(sched.incremental._entries),
                    shadow=None if snap is None else snap["shadow"])
    finally:
        SIDES[side]["routes"].stop_plane()
        sched.stop()


@within(600)
def test_shadow_dispatch_equals_the_reference(monkeypatch, tmp_path):
    """A stale ``host,grad_relax,device`` row: the serving pair is host
    and grad_relax, so the first probe measures the head (host, which no
    race measures), and every later one the non-serving ``device``.  The
    picks, the ``route`` events (but ``wall_s``) and the answers equal the
    reference's; the responses, cache and index equal the plane off's."""
    _stale_row(monkeypatch, tmp_path)
    want = _shadow_run("reference", True)
    got = _shadow_run("port", True)
    assert [c[0] for c in got["calls"]] == ["host", "device", "device"]
    assert got["calls"] == want["calls"]
    assert all(c[1:] == ("xs", WAVE[1], True) for c in got["calls"])
    assert got["routes"] == want["routes"]
    assert all(e["ok"] and e["error"] is None and e["phase"] == "shadow"
               for e in got["routes"])
    assert got["stale"] == want["stale"]
    assert [e["reason"] for e in got["stale"]] == ["stale"]
    assert got["shadow"] == want["shadow"] == {
        "device": {"dispatches": 2, "failed": 0},
        "host": {"dispatches": 1, "failed": 0}}
    assert got["rendered"] == want["rendered"]
    for side, on in (("reference", want), ("port", got)):
        off = _shadow_run(side, False)
        assert off["calls"] == [] and off["routes"] == []
        assert (on["rendered"], on["cache"], on["index"]) == \
            (off["rendered"], off["cache"], off["index"])
    assert len(got["cache"]) == WAVES * WAVE[1]


@within(300)
def test_shadow_fault_is_an_event_and_the_loop_serves_on(monkeypatch,
                                                          tmp_path):
    """An error plan on ``sched.shadow.device``: each device probe is an
    ``ok: false`` route event with the reference's ``error``, counted on
    ``deppy_faults_injected_total`` and never as a driver failure, and
    the loop keeps serving."""
    _stale_row(monkeypatch, tmp_path)
    plan = [{"point": "sched.shadow.device", "kind": "error", "times": -1}]

    def run(side):
        f = SIDES[side]["faults"]
        f.configure_plan(f.FaultPlan.from_doc(plan))
        out = _shadow_run(side, True)
        snap = SIDES[side]["telemetry"].default_registry().snapshot()
        out["injected"] = snap.get("deppy_faults_injected_total")
        out["failures"] = snap.get("deppy_fault_failures_total", 0)
        return out
    want, got = both(run)
    assert got["routes"] == want["routes"]
    assert [(e["backend"], e["ok"], e["error"]) for e in got["routes"]] == [
        ("host", True, None), ("device", False, "InjectedFault"),
        ("device", False, "InjectedFault")]
    assert got["shadow"] == want["shadow"] == {
        "device": {"dispatches": 2, "failed": 2},
        "host": {"dispatches": 1, "failed": 0}}
    assert got["injected"] == want["injected"] == {"sched.shadow.device": 2}
    assert got["failures"] == 0
    assert got["rendered"] == want["rendered"]
    assert len(got["rendered"]) == WAVES * WAVE[1]


@within(120)
def test_submit_shadow_drops_when_stopped_or_full():
    """``submit_shadow`` returns False with the loop not running and past
    the idle backlog cap, as the reference's does; an accepted probe
    rides the idle queue and leaves the live path alone."""
    def run(side):
        if side == "reference":
            sched = JScheduler(backend="host", portfolio="off",
                               speculate_max_backlog=3)
        else:
            sched = TScheduler(device="cpu", backend="host",
                               portfolio="off", speculate_max_backlog=3)
        probs = [SIDES[side]["sat"].encode(v)
                 for v in (route_wave(6, 4, "b") if side == "port"
                           else jbench._wave_vars(6, 4, "b"))]
        out = [sched.submit_shadow("host", "xs", probs[:2])]
        sched.start()
        shadows = _Shadows(side, sched)
        try:
            out.append(sched.submit_shadow("host", "xs", probs))
            out.append(sched.submit_shadow("host", "xs", probs[:3]))
            shadows.wait()
            out.append(strip(shadows.routes(), "wall_s"))
            out.append(sched.speculative_depth())
        finally:
            sched.stop()
        out.append(sched.submit_shadow("host", "xs", probs[:1]))
        return out

    want, got = both(run)
    assert got == want
    assert got[0] is False and got[1] is False and got[2] is True
    assert [e["lanes"] for e in got[3]] == [3] and got[4] == 0
    assert got[5] is False


# ------------------------------------------------------------ workload


@pytest.mark.parametrize("depth,lanes,tag,unsat", [
    (40, 6, "w0", True), (40, 6, "w1", False), (3, 1, "x", True),
    (12, 3, "t", False)])
def test_route_wave_equals_the_reference_s(depth, lanes, tag, unsat):
    got = [[tio.variable_to_dict(v) for v in vs]
           for vs in route_wave(depth, lanes, tag, unsat=unsat)]
    want = [[jio.variable_to_dict(v) for v in vs]
            for vs in jbench._wave_vars(depth, lanes, tag, unsat=unsat)]
    assert got == want
    assert len(got) == lanes and all(len(vs) == depth for vs in got)


# --------------------------------------------------------------- knobs


KNOB_CASES = [
    ("ROUTE_LEARN", v) for v in (None, "off", "No", "on", "learn",
                                 "observe", "weird", " ")] + [
    ("ROUTE_DECAY", v) for v in (None, "0.5", "junk", "5", "0", " ")] + [
    ("ROUTE_MAX_AGE_S", v) for v in (None, "60", "junk", "-1")] + [
    ("ROUTE_SHADOW_RATE", v) for v in (None, "0.5", "0", "-1", "junk",
                                       "3", "0.3")] + [
    ("ROUTE_MIN_SAMPLES", v) for v in (None, "3", "7.9", "0", "junk",
                                       " 5 ")] + [
    ("ROUTE_REGISTRY", v) for v in (None, "/tmp/x.json", "  ")]


def _knob(side: str, name: str):
    r = SIDES[side]
    reg = r["telemetry"].Registry()
    if name == "ROUTE_LEARN":
        return r["routes"].resolve_mode()
    if name == "ROUTE_DECAY":
        return r["routes"].RoutePlane(mode="observe",
                                      registry=reg).ledger.decay
    if name == "ROUTE_MAX_AGE_S":
        return r["watcher"](platform="cpu", registry=reg,
                            rows_doc={}).max_age_s
    if name == "ROUTE_SHADOW_RATE":
        return r["sampler"]().interval
    learner = r["learner"](None, platform="cpu", registry=reg)
    if name == "ROUTE_MIN_SAMPLES":
        return learner.min_samples
    return learner.registry_path


@pytest.mark.parametrize("name,value", KNOB_CASES,
                         ids=[f"{n}-{v!r}" for n, v in KNOB_CASES])
def test_knobs_read_as_the_reference_reads_its_own(name, value,
                                                   monkeypatch):
    if value is not None:
        monkeypatch.setenv(f"DEPPY_GPU_{name}", value)
        monkeypatch.setenv(f"DEPPY_TPU_{name}", value)
    assert _knob("port", name) == _knob("reference", name)


# ---------------------------------------------------------- isolation


def test_fresh_process_route_plane_loads_no_jax():
    """A plane armed on the CPU scheduler, its shadow probes and a
    learner's adoption import nothing of JAX or deppy_tpu."""
    code = textwrap.dedent("""
        import os, sys, tempfile, time
        before = set(sys.modules)
        os.environ["DEPPY_GPU_HOST_WORKERS"] = "0"
        os.environ["DEPPY_GPU_MEASURED_DEFAULTS"] = os.path.join(
            tempfile.mkdtemp(), "none.json")
        from deppy_tpu_torch import routes
        from deppy_tpu_torch.models import route_wave
        from deppy_tpu_torch.sched import Scheduler
        sched = Scheduler(device="cpu", backend="host", portfolio="off")
        sched.start()
        try:
            plane = routes.start_plane(sched, mode="on", shadow_rate=1.0,
                                       min_samples=1)
            for i in range(2):
                sched.submit(route_wave(8, 2, f"w{i}"))
                t0 = time.time()
                while (sum(v["dispatches"]
                           for v in plane.snapshot()["shadow"].values())
                       < i + 1 and time.time() - t0 < 60):
                    time.sleep(0.01)
            snap = plane.snapshot()
            lines = routes.render_metric_lines()
        finally:
            routes.stop_plane()
            sched.stop()
        assert sum(v["dispatches"] for v in snap["shadow"].values()) == 2, snap
        assert any("deppy_route_stale_classes" in l for l in lines), lines
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
