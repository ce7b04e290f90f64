"""The speculative core sweep (A10): the port against the JAX package.

The sweep runs every single-drop deletion probe of ONE giant UNSAT
problem as lanes: stage 1 a fixpoint a probe
(``core.batched_probe_fixpoint``, kernel 7 on the card), stage 2 a DPLL a
probe that propagation left open and one certifying probe
(``core.batched_probe``, kernel 8), then hands the core back, or None and
the host sweep answers.  On the CPU the port runs the plain versions; the
JAX package runs its vmapped XLA probes.  Flags, status, steps, masks, the
None cases, and the solve's outcome, core and steps must be equal, with
no tolerance.  Inputs are the reference's ``_unsat_instances()``
(tests/test_host_core_routing.py:23-54) and
``giant_pinned_conflict(40, 4)``.  The reference's own cases of the sweep
(test_host_core_routing.py:104-201, test_mosaic_lowering.py:205-224,
test_revalidate_wiring.py:338-366, test_driver_paths.py:75-95) are ported
at the end.  Knobs are set on the module attributes of both drivers.
"""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest
import torch

from deppy_tpu import sat as jsat
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import giant_pinned_conflict as jgiant
from deppy_tpu.models import random_instance as jrandom
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu.sat.host import HostEngine as JHostEngine
from deppy_tpu_torch import models as tm
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine import _build, cuda_probe, defaults, spec_core_ab
from deppy_tpu_torch.engine import core as tcore
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.sat import host as thost
from deppy_tpu_torch.sat.encode import encode as tencode

CPU = torch.device("cpu")
BIG = 1 << 24


def _hand(S):
    return [
        [S.variable("a", S.mandatory(), S.prohibited()), S.variable("b")],
        [S.variable("a", S.mandatory(), S.conflict("b")),
         S.variable("b", S.mandatory()),
         S.variable("c", S.dependency("b"))],
        # Two disjoint cores: the deletion order decides which survives,
        # so the sweep's certifying probe is SAT and it returns None.
        _disjoint(S),
    ]


def _disjoint(S):
    return [S.variable("a", S.mandatory(), S.prohibited()),
            S.variable("b", S.mandatory(), S.conflict("c")),
            S.variable("c", S.mandatory()),
            S.variable("d", S.dependency("c"))]


@functools.lru_cache(maxsize=None)
def _instances():
    """[(name, JAX problem, port problem)]: the reference's UNSAT set (its
    four random instances are SAT, so the hand three), then
    ``giant_pinned_conflict(40, 4)`` (175 constraints, core [172, 173,
    174])."""
    out = [(f"hand{i}", jencode(j), tencode(t))
           for i, (j, t) in enumerate(zip(_hand(jsat), _hand(tsat)))]
    for seed in (3, 7, 11, 19):
        jp = jencode(jrandom(length=32, seed=seed))
        try:
            JHostEngine(jp).solve()
        except jsat.NotSatisfiable:
            out.append((f"random{seed}", jp,
                        tencode(tm.random_instance(length=32, seed=seed))))
        except Exception:
            pass
    out.append(("pinned40", jencode(jgiant(40, 4, seed=0)),
                tencode(tm.giant_pinned_conflict(40, 4, seed=0))))
    assert len(out) >= 4
    return out


NAMES = ["hand0", "hand1", "hand2", "pinned40"]


def _pair(name):
    (jp, tp), = [(j, t) for n, j, t in _instances() if n == name]
    return jp, tp


def _jax_pt(p):
    """The reference's full-space planes of one problem, as its sweep
    derives them (driver.py:692-699)."""
    d = jdriver._Dims([p], 1)
    pts = jdriver._put_compact(jdriver.pad_stack([p], d, 1, pack=False))
    pts = jdriver._derive_planes(pts, d, full=True, red=False)
    return d, jax.tree_util.tree_map(lambda a: a[0], pts)


def _port_pt(p):
    d = tdriver._Dims([p], 1)
    pts = tdriver._upload(tdriver.pad_stack([p], d, 1), CPU)
    pts = tcore.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=False, full=True)
    return d, tcore.lane(pts, 0)


def _masks(n, NCON, drops, extra=()):
    """Single-drop activation masks of ``drops``, then ``extra`` masks."""
    idx = np.arange(NCON)
    rows = [(idx < n) & (idx != j) for j in drops] + list(extra)
    return np.stack(rows).astype(bool)


@pytest.fixture
def host_calls(monkeypatch):
    """Counts the port's host-engine core sweeps."""
    calls = []
    real = thost.HostEngine.unsat_core_mask

    def counted(self):
        calls.append(self.p.n_cons)
        return real(self)

    monkeypatch.setattr(thost.HostEngine, "unsat_core_mask", counted)
    return calls


def _both(monkeypatch, name, value):
    monkeypatch.setattr(jdriver, name, value)
    monkeypatch.setattr(tdriver, name, value)


# ------------------------------------------------------- the probe functions


@pytest.mark.parametrize("name", NAMES)
def test_probe_fixpoint_matches_jax(name):
    """Stage 1, lane for lane, tail lanes (j >= n_cons: the full set)
    included."""
    jp, tp = _pair(name)
    jd, jpt = _jax_pt(jp)
    td, tpt = _port_pt(tp)
    P = tdriver._bucket(tp.n_cons)
    drops = np.arange(P, dtype=np.int32)
    want = np.asarray(jcore.batched_probe_fixpoint(jd.V, jd.NCON)(
        jpt, drops))
    got = tcore.batched_probe_fixpoint(tpt, torch.from_numpy(drops),
                                       NCON=td.NCON)
    np.testing.assert_array_equal(got.numpy(), want)
    via = cuda_probe.batched_probe_fixpoint(tpt, torch.from_numpy(drops),
                                            NCON=td.NCON)
    np.testing.assert_array_equal(via.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("budget", [BIG, 5])
def test_probe_dpll_matches_jax(name, budget):
    """Stage 2 and the verification probe, lane for lane: status and
    steps of single-drop masks, the full set, the empty set (a pad lane)
    and the core alone, under a generous and a tight budget."""
    jp, tp = _pair(name)
    jd, jpt = _jax_pt(jp)
    td, tpt = _port_pt(tp)
    n = tp.n_cons
    drops = range(n) if n < 64 else [0, 50, 100, 171, 172, 173, 174]
    full = np.arange(td.NCON) < n
    core_only = full.copy()
    if name == "pinned40":
        core_only[:172] = False
    masks = _masks(n, td.NCON, drops,
                   [full, np.zeros(td.NCON, bool), core_only])
    ws, wn = jax.device_get(jcore.batched_probe(jd.V, jd.NCON, jd.NV)(
        jpt, masks, np.int32(budget)))
    gs, gn = tcore.batched_probe(tpt, torch.from_numpy(masks), budget,
                                 NCON=td.NCON)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


# ---------------------------------------------------------------- the sweep


@pytest.mark.parametrize("name,remaining,cap", [
    *[(n, BIG, 1 << 15) for n in NAMES[:-1]],
    ("hand1", 1, 1 << 15), ("hand1", 3, 1 << 15), ("hand2", 5, 1 << 15),
    # pinned40's sweep spends 769 steps: exactly enough, short in stage 2,
    # and its stage-2 lanes capped out.
    ("pinned40", 769, 1 << 15), ("pinned40", 300, 1 << 15),
    ("pinned40", BIG, 50),
])
def test_speculative_core_mask_matches_jax(name, remaining, cap,
                                           monkeypatch):
    """(mask, steps) of the sweep, its None cases (the disjoint cores,
    a budget spent in stage 1, in stage 2 or by the verification, lanes
    capped out at SPEC_CORE_CAP) included."""
    jp, tp = _pair(name)
    _both(monkeypatch, "SPEC_CORE_CAP", cap)
    wm, ws = jdriver._speculative_core_mask(jp, remaining)
    gm, gs = tdriver._speculative_core_mask(tp, remaining, "cpu")
    assert gs == ws
    assert (gm is None) == (wm is None)
    if wm is not None:
        np.testing.assert_array_equal(gm, wm)
    if name == "pinned40" and remaining == 769:
        assert np.flatnonzero(gm).tolist() == [172, 173, 174] and gs == 769


def _lanes_equal(problems, want, got):
    for p, a, b in zip(problems, want, got):
        assert b.outcome == int(a.outcome)
        np.testing.assert_array_equal(b.installed.numpy()[: p.n_vars],
                                      np.asarray(a.installed)[: p.n_vars])
        np.testing.assert_array_equal(b.core.numpy()[: p.n_cons],
                                      np.asarray(a.core)[: p.n_cons])
        assert b.steps == int(a.steps)
        assert b.trace_n == int(a.trace_n)


@pytest.mark.parametrize("max_steps", [None, 3])
def test_solve_with_sweep_on_matches_jax(monkeypatch, host_calls,
                                         max_steps):
    """``solve_problems`` of one problem (the monolith route) with
    SPEC_CORE "1" and its core host-routed: outcome, core and steps as
    the JAX driver's, under a generous budget and one the sweep
    exceeds."""
    _both(monkeypatch, "SPEC_CORE", "1")
    _both(monkeypatch, "HOST_CORE_NCONS", 0)
    jp, tp = _pair("hand1")
    want = jdriver.solve_problems([jp], max_steps=max_steps)
    got = tdriver.solve_problems([tp], max_steps=max_steps, device="cpu")
    _lanes_equal([jp], want, got)
    assert host_calls == []


def test_monolith_batch_with_sweep_matches_jax(monkeypatch, host_calls):
    """``split_phases=False`` runs a batch through the monolith route,
    where every host-routed core takes the sweep first: each instance
    under HOST_CORE_NCONS 0, lane for lane as the JAX driver's.  The
    sweep answers all but the disjoint cores, where the host sweep
    does."""
    _both(monkeypatch, "SPEC_CORE", "1")
    _both(monkeypatch, "HOST_CORE_NCONS", 0)
    jp = [_pair(n)[0] for n in NAMES]
    tp = [_pair(n)[1] for n in NAMES]
    want = jdriver.solve_problems(jp, split_phases=False)
    got = tdriver.solve_problems(tp, split_phases=False, device="cpu")
    _lanes_equal(jp, want, got)
    assert np.flatnonzero(got[-1].core.numpy()).tolist() == [172, 173, 174]
    assert host_calls == [_pair("hand2")[1].n_cons]
    # The split route keeps the host sweep (driver.py:1124): with two SAT
    # siblings the UNSAT lanes are half the batch, and every one goes to
    # the host.
    host_calls.clear()
    sats = [tencode(tm.random_instance(length=32, seed=s)) for s in (0, 1)]
    split = tdriver.solve_problems(tp + sats, device="cpu")
    assert host_calls == [p.n_cons for p in tp]
    for a, b in zip(got, split):
        assert a.outcome == b.outcome
        np.testing.assert_array_equal(a.core.numpy(), b.core.numpy())


# ------------------------------------------- the reference's cases, ported


def test_speculative_core_matches_spec(monkeypatch):
    """test_host_core_routing.py:104-121: the sweep is observably the
    host sweep on every instance (the disjoint cores fall back)."""
    monkeypatch.setattr(tdriver, "HOST_CORE_NCONS", 0)
    for name, _, p in _instances()[:-1]:
        monkeypatch.setattr(tdriver, "SPEC_CORE", "1")
        (a,) = tdriver.solve_problems([p], device="cpu")
        monkeypatch.setattr(tdriver, "SPEC_CORE", "0")
        (b,) = tdriver.solve_problems([p], device="cpu")
        assert a.outcome == b.outcome == tcore.UNSAT
        np.testing.assert_array_equal(a.core.numpy(), b.core.numpy())


def test_speculative_core_falls_back_on_order_dependence():
    """test_host_core_routing.py:124-136."""
    mask, steps = tdriver._speculative_core_mask(tencode(_disjoint(tsat)),
                                                 BIG, "cpu")
    assert mask is None
    assert steps > 0


def test_speculative_core_exhausted_budget():
    """test_host_core_routing.py:139-144."""
    p = tencode(_hand(tsat)[0])
    assert tdriver._speculative_core_mask(p, 0, "cpu") == (None, 0)


def test_speculative_search_launches_are_budget_capped(monkeypatch):
    """test_host_core_routing.py:147-177: every stage-2 and verification
    launch gets at most SPEC_CORE_CAP steps."""
    seen = []
    orig = tcore.batched_probe

    def capture(pt, masks, budget, **kw):
        seen.append(int(budget))
        return orig(pt, masks, budget, **kw)

    monkeypatch.setattr(tcore, "batched_probe", capture)
    p = tencode([
        tsat.variable("a", tsat.mandatory(), tsat.dependency("b", "c")),
        tsat.variable("b", tsat.conflict("c")),
        tsat.variable("c", tsat.mandatory()),
        tsat.variable("d", tsat.mandatory(), tsat.prohibited()),
    ])
    tdriver._speculative_core_mask(p, BIG, "cpu")
    assert seen, "expected at least one search-stage launch"
    assert all(b <= tdriver.SPEC_CORE_CAP for b in seen)


@pytest.fixture
def registry(tmp_path, monkeypatch):
    """An empty measured-defaults registry for this test."""
    path = tmp_path / "measured_defaults.json"
    monkeypatch.setenv("DEPPY_GPU_MEASURED_DEFAULTS", str(path))
    defaults.reload_measured_defaults()
    yield path
    monkeypatch.undo()
    defaults.reload_measured_defaults()


def test_spec_core_auto_defaults_off(monkeypatch, registry):
    """test_host_core_routing.py:192-201: "auto" is off without a
    measured row; "1" forces it on."""
    monkeypatch.setattr(tdriver, "SPEC_CORE", "auto")
    assert tdriver._spec_core_enabled() is False
    assert tdriver._spec_core_enabled("cpu") is False
    monkeypatch.setattr(tdriver, "SPEC_CORE", "1")
    assert tdriver._spec_core_enabled() is True


def test_measured_default_resolves_spec_core(monkeypatch, registry):
    """test_mosaic_lowering.py:205-224: a measured "on" row turns "auto"
    on for its platform only; "0" overrides it."""
    registry.write_text(json.dumps({"gpu": {"spec_core": "on",
                                            "evidence": {}}}))
    defaults.reload_measured_defaults()
    monkeypatch.setattr(tdriver, "SPEC_CORE", "auto")
    assert tdriver._spec_core_enabled("cuda")
    assert tdriver._spec_core_enabled(torch.device("cuda", 0))
    assert not tdriver._spec_core_enabled("cpu")
    monkeypatch.setattr(tdriver, "SPEC_CORE", "0")
    assert not tdriver._spec_core_enabled("cuda")
    # "on" is not a value the driver reads: it is off.
    monkeypatch.setattr(tdriver, "SPEC_CORE", "on")
    assert not tdriver._spec_core_enabled("cuda")


def test_auto_row_drives_the_sweep(monkeypatch, registry, host_calls):
    """With a measured "on" row for the CPU platform, "auto" sweeps a
    ``device="cpu"`` solve's giant core on the probes."""
    registry.write_text(json.dumps({"cpu": {"spec_core": "on"}}))
    defaults.reload_measured_defaults()
    monkeypatch.setattr(tdriver, "SPEC_CORE", "auto")
    monkeypatch.setattr(tdriver, "HOST_CORE_NCONS", 0)
    (r,) = tdriver.solve_problems([_pair("hand1")[1]], device="cpu")
    assert r.outcome == tcore.UNSAT and host_calls == []


@pytest.mark.parametrize("rec,row", [
    ({"verdict": "ok", "off_s": 8.6, "on_s": 2.9}, "on"),
    ({"verdict": "ok", "off_s": 2.1, "on_s": 27.6}, "off"),
    ({"verdict": "CORE-DIVERGENCE", "off_s": 2.0, "on_s": 1.0}, None),
    ({"verdict": "ok", "off_s": None, "on_s": 1.0}, None),
])
def test_spec_core_verdict_records(rec, row, tmp_path, registry):
    """test_revalidate_wiring.py:338-359: a win records "on", an agreeing
    loss "off", a divergence nothing; the evidence carries both times."""
    path = tmp_path / "rows.json"
    assert spec_core_ab.record(rec, str(path)) == row
    if row is None:
        assert not path.exists()
        return
    data = json.loads(path.read_text())
    assert data["gpu"]["spec_core"] == row
    ev = data["gpu"]["evidence"]["spec_core"]
    assert ev["spec_core_on_s"] == rec["on_s"]
    assert ev["spec_core_off_s"] == rec["off_s"]


def test_spec_core_ab_smoke_shape_never_records(tmp_path, registry,
                                                capsys):
    """test_revalidate_wiring.py:362-366: the A/B at a tiny shape on the
    CPU agrees and records nothing."""
    path = tmp_path / "rows.json"
    rc = spec_core_ab.main(["--packages", "8", "--versions", "2",
                            "--device", "cpu", "--record", "--registry",
                            str(path)])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert out[0]["verdict"] == "ok" and out[0]["cores_agree"]
    assert out[0]["off_s"] > 0 and out[0]["on_s"] > 0
    assert out[1]["recorded"] is None
    assert not path.exists()
    assert tdriver.SPEC_CORE == "auto"


def test_spec_core_ab_sat_is_no_agreement():
    """The SAT sentinel on both arms is a divergence."""
    s = spec_core_ab.SAT_SENTINEL
    assert spec_core_ab.verdict(s, s, 1.0, 0.5)["verdict"] == \
        "CORE-DIVERGENCE"
    assert spec_core_ab.verdict("x", "y", 1.0, 0.5)["cores_agree"] is False


def _outcomes(res):
    return [int(r.outcome) for r in res]


def test_chunked_split_matches_monolith(monkeypatch):
    """test_driver_paths.py:75-86: the split route over several chunks and
    the monolith route give the same answers, and the JAX driver's."""
    _both(monkeypatch, "MAX_LANES", 8)
    jp = [jencode(jrandom(length=16, seed=s, p_conflict=0.2))
          for s in range(20)]
    tp = [tencode(tm.random_instance(length=16, seed=s, p_conflict=0.2))
          for s in range(20)]
    split = tdriver.solve_problems(tp, split_phases=True, device="cpu")
    mono = tdriver.solve_problems(tp, split_phases=False, device="cpu")
    assert _outcomes(split) == _outcomes(mono)
    for a, b in zip(split, mono):
        assert (a.core == b.core).all()
    _lanes_equal(jp, jdriver.solve_problems(jp, split_phases=False), mono)


def test_bucketing_off_keeps_one_group(monkeypatch):
    """``bucketing=False`` (driver.py:1951) dispatches a heterogeneous
    batch as one group; the answers are the bucketed ones."""
    groups = []
    real = tdriver._solve_split

    def counted(problems, *a, **kw):
        groups.append(len(problems))
        return real(problems, *a, **kw)

    monkeypatch.setattr(tdriver, "_solve_split", counted)
    tp = [tencode(tm.random_instance(length=n, seed=s))
          for s in range(16) for n in (8, 48)]
    bucketed = tdriver.solve_problems(tp, device="cpu")
    assert len(groups) > 1
    groups.clear()
    whole = tdriver.solve_problems(tp, bucketing=False, device="cpu")
    assert groups == [len(tp)]
    _lanes_equal(tp, bucketed, whole)


def test_unsat_heavy_batch_matches_host(monkeypatch):
    """test_driver_paths.py:89-95 and on: an all-UNSAT batch on the split
    route reproduces the host engine's cores."""
    monkeypatch.setattr(tdriver, "MAX_LANES", 8)

    def unsat_vars(seed):
        return [tsat.variable("a", tsat.mandatory(), tsat.dependency("b")),
                tsat.variable("b", tsat.conflict("a")),
                tsat.variable(f"pad{seed}")]

    problems = [tencode(unsat_vars(s)) for s in range(12)]
    results = tdriver.solve_problems(problems, split_phases=True,
                                     device="cpu")
    for p, r in zip(problems, results):
        assert r.outcome == tcore.UNSAT
        want = thost.HostEngine(p).unsat_core_mask()
        np.testing.assert_array_equal(r.core.numpy()[: p.n_cons], want)


# ------------------------------------------------------------ tree defects


def test_probe_defect_raises_and_never_falls_back(monkeypatch, host_calls):
    """A probe kernel that cannot launch raises through the driver and
    the facade; the host sweep never answers in its place."""
    def broken(*a, **kw):
        raise _build.KernelLaunchError("probe_fixpoint launch refused")

    monkeypatch.setattr(tcore, "batched_probe_fixpoint", broken)
    monkeypatch.setattr(tdriver, "SPEC_CORE", "1")
    monkeypatch.setattr(tdriver, "HOST_CORE_NCONS", 0)
    with pytest.raises(_build.KernelLaunchError):
        tdriver.solve_problems([_pair("hand1")[1]], device="cpu")
    with pytest.raises(_build.KernelLaunchError):
        tsat.Solver(_hand(tsat)[1], device="cpu").solve()
    assert host_calls == []


def test_probe_wrappers_refuse_bad_arguments():
    """The wrappers' contract errors (of ``driver.TREE_DEFECTS``)."""
    td, pt = _port_pt(_pair("hand1")[1])
    with pytest.raises(TypeError):
        cuda_probe.batched_probe_fixpoint(
            pt, torch.arange(4, dtype=torch.int64), NCON=td.NCON)
    with pytest.raises(ValueError):
        cuda_probe.batched_probe(
            pt, torch.ones((2, td.NCON + 1), dtype=torch.bool), 10,
            NCON=td.NCON)
    with pytest.raises(ValueError):
        cuda_probe.batched_probe_fixpoint(
            tdriver._upload(tdriver.pad_stack([_pair("hand1")[1]], td, 1),
                            CPU),
            torch.arange(4, dtype=torch.int32), NCON=td.NCON)
    assert issubclass(_build.KernelLaunchError, tdriver.TREE_DEFECTS)


def test_sweep_launches_only_the_lanes_it_reads(monkeypatch):
    """The launches hold no tail or pad lane: stage 1's cover the
    ``n_cons`` drops once in the reference's chunks, stage 2's the open
    probes, the verification one lane; the answer and steps stay the
    reference's."""
    lanes = []
    for name in ("batched_probe_fixpoint", "batched_probe"):
        orig = getattr(tcore, name)

        def spy(pt, x, *a, _orig=orig, _name=name, **kw):
            lanes.append((_name, x.shape[0]))
            return _orig(pt, x, *a, **kw)

        monkeypatch.setattr(tcore, name, spy)
    monkeypatch.setattr(tdriver, "PROBE_LANES", 64)
    jp, tp = _pair("pinned40")
    monkeypatch.setattr(jdriver, "PROBE_LANES", 64)
    want = jdriver._speculative_core_mask(jp, BIG)
    mask, steps = tdriver._speculative_core_mask(tp, BIG, "cpu")
    np.testing.assert_array_equal(mask, want[0])
    assert steps == want[1] == 769
    n = tp.n_cons
    fp = [q for k, q in lanes if k == "batched_probe_fixpoint"]
    dp = [q for k, q in lanes if k == "batched_probe"]
    assert fp == [64, 64, n - 128]
    assert dp == [3, 1]
