"""The watched clause bank of the port against the JAX package, on the CPU.

* the numpy banks (``max_occurrence``, ``max_card_membership``,
  ``occ_from_clauses_np``, ``card_occ_np``) against
  ``deppy_tpu.engine.clause_bank``'s, byte for byte, on the families
  ``chip_smoke.py`` runs and on random instances;
* ``derive_banks`` (torch ops on the batch's device) against the numpy
  build in the reduced and the full space, dummies for a space not asked
  for, and ``bank_ready``; the driver's ``_Dims.Ob``/``Oc`` and
  ``_bank_cap`` against the reference's;
* the plain ``watched_fixpoint`` against the reference's from mid-search
  partial states, in both spaces, with and without an extras bound, and
  kernel 1's wrapper under the watched arm (its plain version here) on
  the same states: the conflict flag always, t/f where there is no
  conflict;
* the phase wrappers under ``impl="watched"`` against
  ``core.batched_search`` / ``batched_minimize_gated`` / ``batched_core``
  under ``set_bcp_impl("watched")``;
* whole solves under watched against the JAX driver (outcome, installed,
  core, steps, backtracks), and once with ``BANK_OCC_CAP`` forced to 1 on
  both sides: the dummy banks, where no watched fixpoint runs.

Every comparison is exact (tolerance 0): the outputs are integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deppy_tpu.engine import clause_bank as jbank
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu import models as jmodels
from deppy_tpu.models import (gvk_conflict_catalog, pinned_tenant_catalog,
                              random_instance, version_pinned_chains)
from deppy_tpu.sat.encode import encode
from deppy_tpu_torch import models as tm
from deppy_tpu_torch.engine import clause_bank as tbank
from deppy_tpu_torch.engine import convert, cuda_bcp, cuda_search
from deppy_tpu_torch.engine import core as tcore
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.sat.encode import encode as tencode

BUDGET = 1 << 20


@pytest.fixture(autouse=True)
def _restore_impls():
    yield
    jcore.set_bcp_impl("auto")
    tcore.set_bcp_impl("auto")


FAMILIES = {
    "random": ("random_instance", (28,)),
    "gvk": ("gvk_conflict_catalog", (20, 4, 10)),
    "chains": ("version_pinned_chains", (20, 3)),
    "tenant": ("pinned_tenant_catalog", ()),
    "operatorhub": ("operatorhub_catalog", (40, 5)),
}


def _problems(family, n=3, port=False):
    """``n`` seeded problems of ``family``, encoded by the JAX package or
    by the port."""
    name, args = FAMILIES[family]
    models, enc = (tm, tencode) if port else (jmodels, encode)
    return [enc(getattr(models, name)(*args, seed=s)) for s in range(n)]


# --------------------------------------------------------------------------
# the banks


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_numpy_banks_match_reference(family):
    for p in _problems(family):
        assert tbank.max_occurrence(p.clauses) == jbank.max_occurrence(
            p.clauses)
        assert tbank.max_card_membership(p.card_ids) == \
            jbank.max_card_membership(p.card_ids)
        O = max(jbank.max_occurrence(p.clauses), 1)
        Oc = max(jbank.max_card_membership(p.card_ids), 1)
        V = p.n_vars + p.n_cons
        for n_vars in (None, p.n_vars):
            rows = V if n_vars is None else p.n_vars
            got = tbank.occ_from_clauses_np(p.clauses, rows, O, n_vars)
            want = jbank.occ_from_clauses_np(p.clauses, rows, O, n_vars)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tbank.card_occ_np(p.card_ids, p.n_vars, Oc),
            jbank.card_occ_np(p.card_ids, p.n_vars, Oc))
    assert tbank.max_occurrence(np.zeros((2, 2), np.int32)) == 0
    assert tbank.max_card_membership(np.full((2, 2), -1, np.int32)) == 0


def _padded(problems):
    d = jdriver._Dims(problems, len(problems))
    return d, jdriver.pad_stack(problems, d, d.B, pack=True)


@pytest.mark.parametrize("family", ["random", "tenant", "operatorhub"])
def test_derive_banks_match_numpy_build(family):
    problems = _problems(family, 4)
    d, host = _padded(problems)
    assert d.Ob <= jdriver._bank_cap(d)  # the numpy build made real banks
    tpts = convert.problem_tensors_from_numpy(host)
    got = tbank.derive_banks(tpts.clauses, tpts.card_ids, tpts.n_vars, V=d.V,
                             NV=d.NV, Ob=d.Ob, Oc=d.Oc, red=True, full=True)
    names = ("occ_pos", "occ_neg", "occ_pos_r", "occ_neg_r", "card_occ")
    for name, x in zip(names, got):
        assert x.dtype == torch.int32, name
        np.testing.assert_array_equal(x.numpy(), getattr(host, name),
                                      err_msg=name)
    # A space not asked for comes back as [B, 1, 1] dummies.
    for red, full in ((True, False), (False, True)):
        part = tbank.derive_banks(tpts.clauses, tpts.card_ids, tpts.n_vars,
                                  V=d.V, NV=d.NV, Ob=d.Ob, Oc=d.Oc, red=red,
                                  full=full)
        for name, x in zip(names, part):
            asked = name == "card_occ" or (red if name.endswith("_r")
                                           else full)
            if asked:
                np.testing.assert_array_equal(x.numpy(),
                                              getattr(host, name))
            else:
                assert x.shape == (d.B, 1, 1) and bool((x == -1).all())
                assert not tbank.bank_ready(x)
    assert tbank.bank_ready(got[0]) and tbank.bank_ready(got[2])


def test_bank_ready_and_dims_match_reference(monkeypatch):
    assert not tbank.bank_ready(torch.full((1, 1), -1, dtype=torch.int32))
    assert not tbank.bank_ready(torch.full((3, 1, 1), -1, dtype=torch.int32))
    assert tbank.bank_ready(torch.full((8, 4), -1, dtype=torch.int32))
    for family in sorted(FAMILIES):
        jd = jdriver._Dims(_problems(family), 3)
        td = tdriver._Dims(_problems(family, port=True), 3)
        assert (td.Ob, td.Oc) == (jd.Ob, jd.Oc), family
        assert tdriver._bank_cap(td) == jdriver._bank_cap(jd), family
    monkeypatch.setattr(tdriver, "BANK_OCC_CAP", 3)
    assert tdriver._bank_cap(td) == 3


def test_pad_stack_ships_dummy_banks():
    tp = [tencode(tm.random_instance(length=12, seed=s)) for s in range(2)]
    d = tdriver._Dims(tp, 2)
    pts = tdriver.pad_stack(tp, d, 4)
    for name in ("occ_pos", "occ_neg", "occ_pos_r", "occ_neg_r",
                 "card_occ"):
        x = getattr(pts, name)
        assert x.shape == (4, 1, 1) and (x == -1).all()


# --------------------------------------------------------------------------
# the fixpoint


_REF_WATCHED = jax.jit(jbank.watched_fixpoint, static_argnames=("red",))


def _states(problems, host, d, red: bool, extras: bool, seed: int):
    """Per lane the inputs of one fixpoint from a mid-search partial
    state (the base assignment with a few problem variables set), in the
    reduced or the full space, with an extras bound when asked."""
    rng = np.random.default_rng(seed)
    V = d.NV if red else d.V
    W = d.Wr if red else d.Wv
    out = []
    for b, p in enumerate(problems):
        pt = jcore.ProblemTensors(*[jnp.asarray(x[b]) for x in host])
        if red:
            base = np.array(jcore._base_assignment_red(pt, d.NV))
        else:
            base = np.array(jcore._base_assignment(pt, d.V, d.NCON))
        k = int(rng.integers(0, 6))
        for v in rng.choice(p.n_vars, size=min(k, p.n_vars), replace=False):
            base[v] = rng.choice([jcore.TRUE, jcore.FALSE])
        t0 = np.array(jcore.pack_mask(jnp.asarray(base == jcore.TRUE), W))
        f0 = np.array(jcore.pack_mask(jnp.asarray(base == jcore.FALSE), W))
        mm = np.zeros(V, bool)
        mw = 0
        if extras:
            pick = rng.choice(p.n_vars, size=min(4, p.n_vars), replace=False)
            mm[pick] = True
            mw = int(rng.integers(0, 3))
        mb = np.array(jcore.pack_mask(jnp.asarray(mm), W))
        if red:
            planes = (host.pos_bits_r[b], host.neg_bits_r[b],
                      host.card_member_bits_r[b])
            act = host.card_valid[b] != 0
            occ = (host.occ_pos_r[b], host.occ_neg_r[b])
        else:
            planes = (host.pos_bits[b], host.neg_bits[b],
                      host.card_member_bits[b])
            act = ((host.card_act_bits[b] & t0) != 0).any(axis=1)
            occ = (host.occ_pos[b], host.occ_neg[b])
        out.append(dict(planes=planes, act=act, occ=occ, t0=t0, f0=f0,
                        mb=mb, mw=mw))
    return out


def _reference(host, b, s, red):
    c, t, f = _REF_WATCHED(
        jnp.asarray(host.clauses[b]), jnp.int32(host.n_vars[b]),
        jnp.asarray(s["occ"][0]), jnp.asarray(s["occ"][1]),
        jnp.asarray(host.card_occ[b]), *map(jnp.asarray, s["planes"]),
        jnp.asarray(s["act"])[:, None], jnp.asarray(host.card_n[b])[:, None],
        jnp.asarray(s["mb"]), jnp.int32(s["mw"]), jnp.asarray(s["t0"]),
        jnp.asarray(s["f0"]), jnp.bool_(True), red=red)
    return bool(c), np.asarray(t)[0], np.asarray(f)[0]


@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("red", [True, False])
def test_watched_fixpoint_matches_reference(red, extras):
    problems = ([encode(random_instance(length=24, seed=s)) for s in range(6)]
                + [encode(gvk_conflict_catalog(8, 3, 4, seed=s))
                   for s in range(3)]
                + [encode(version_pinned_chains(6, 3, seed=s))
                   for s in range(3)])
    d, host = _padded(problems)
    tpts = convert.problem_tensors_from_numpy(host)
    conflicts = 0
    for seed in range(3):
        states = _states(problems, host, d, red, extras, 11 * seed + red)
        work = dict(tbank.plain_work)
        got_lanes = []
        for b, s in enumerate(states):
            want = _reference(host, b, s, red)
            got = tbank.watched_fixpoint(
                tpts.clauses[b], tpts.n_vars[b], *map(torch.as_tensor,
                                                      s["occ"]),
                tpts.card_occ[b], *map(torch.as_tensor, s["planes"]),
                torch.as_tensor(s["act"]), tpts.card_n[b],
                torch.as_tensor(s["mb"][0]), s["mw"],
                torch.as_tensor(s["t0"][0]), torch.as_tensor(s["f0"][0]),
                True, red)
            assert got[0] == want[0], (seed, b)
            if not want[0]:
                np.testing.assert_array_equal(got[1].numpy(), want[1])
                np.testing.assert_array_equal(got[2].numpy(), want[2])
            conflicts += want[0]
            got_lanes.append(got)
        done = {k: tbank.plain_work[k] - work[k] for k in work}
        # Every visited row holds the literal its pop falsified.
        assert done["pops"] > 0 and done["lits"] >= done["rows"] > 0
        # Kernel 1's wrapper under the watched arm (its plain version on
        # the CPU) on the same states, as one batch.
        n = len(problems)

        def col(key, i=None):
            xs = [s[key] if i is None else s[key][i] for s in states]
            return torch.as_tensor(np.stack(xs).astype(np.int32))

        planes = [col("planes", i) for i in range(3)]
        occ_p, occ_n = (tpts.occ_pos_r, tpts.occ_neg_r) if red else (
            tpts.occ_pos, tpts.occ_neg)
        arm = cuda_bcp.Arm("watched", tpts.clauses[:n], tpts.card_ids[:n],
                           tpts.n_vars[:n], occ_p[:n], occ_n[:n],
                           tpts.card_occ[:n], red=red)
        out = cuda_bcp.bcp_fixpoint(
            *planes, col("act"), tpts.card_n[:n], col("mb")[:, 0],
            torch.tensor([s["mw"] for s in states], dtype=torch.int32),
            col("t0")[:, 0], col("f0")[:, 0],
            torch.ones(n, dtype=torch.int32), impl="watched", arm=arm)
        for b, got in enumerate(got_lanes):
            assert bool(out[0][b]) == got[0]
            assert torch.equal(out[1][b], got[1])
            assert torch.equal(out[2][b], got[2])
    assert 0 < conflicts < 3 * len(problems)


# --------------------------------------------------------------------------
# the phases and whole solves


def _random_problems():
    return [encode(random_instance(length=16, seed=s)) for s in range(4)] + [
        encode(random_instance(length=12, seed=s, p_mandatory=0.5,
                               p_conflict=0.5, n_conflict=3))
        for s in range(4)]


def _assert_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(convert.to_numpy(b), np.asarray(a),
                                      err_msg=f"output {i}")


def test_phases_plain_match_jax_watched():
    """Phases 1, 2 and 3 chained under watched: every lane against the
    JAX programs under ``set_bcp_impl("watched")``; the reduced banks
    serve phases 1-2, the full ones phase 3."""
    jcore.set_bcp_impl("watched")
    problems = _random_problems()
    d, host = _padded(problems)
    en = np.arange(d.B) < len(problems)
    jpts = jcore.ProblemTensors(*[jnp.asarray(x) for x in host])
    tpts = convert.problem_tensors_from_numpy(host)
    ten = torch.as_tensor(en)
    pops = tbank.plain_work["pops"]

    p1 = jcore.batched_search(d.V, d.NCON, d.NV, 0)(
        jpts, jnp.int32(BUDGET), jnp.asarray(en))
    got1 = cuda_search.batched_search_fused(tpts, BUDGET, ten,
                                            impl="watched")
    _assert_equal([p1[0], p1[1], p1[2], p1[3], p1[5]],
                  [got1[0], got1[1], got1[2], got1[3], got1[5]])
    assert tbank.plain_work["pops"] > pops

    result, guessed, model, steps = got1[0], got1[1], got1[2], got1[3]
    want2 = jcore.batched_minimize_gated(d.V, d.NCON, d.NV)(
        jpts, p1[0], p1[2], p1[1], jnp.int32(BUDGET), p1[3], jnp.asarray(en))
    got2 = cuda_search.batched_minimize_fused(
        tpts, result, model, guessed, BUDGET, steps, ten, impl="watched")
    _assert_equal(want2, got2)

    gate = en & (np.asarray(p1[0]) == jcore.UNSAT)
    assert gate.any()
    want3 = jcore.batched_core(d.V, d.NCON, d.NV)(
        jpts, jnp.int32(BUDGET), p1[3], jnp.asarray(gate))
    got3 = cuda_search.batched_core_fused(
        tpts, BUDGET, steps, torch.as_tensor(gate), NCON=d.NCON,
        impl="watched")
    _assert_equal(want3, got3)


def _solve_pairs():
    """(JAX problems, port problems): random instances, conflict-heavy
    ones, and 2 UNSAT pinned-tenant catalogs."""
    pairs = [(random_instance(length=20, seed=s),
              tm.random_instance(length=20, seed=s)) for s in range(4)]
    pairs += [(random_instance(length=16, seed=s, p_mandatory=0.5,
                               p_conflict=0.5, n_conflict=4),
               tm.random_instance(length=16, seed=s, p_mandatory=0.5,
                                  p_conflict=0.5, n_conflict=4))
              for s in range(4)]
    pairs += [(pinned_tenant_catalog(seed=s), tm.pinned_tenant_catalog(seed=s))
              for s in (1, 2)]
    return ([encode(a) for a, _ in pairs], [tencode(b) for _, b in pairs])


def _lanes_equal(jp, a_res, b_res):
    for p, a, b in zip(jp, a_res, b_res):
        assert int(b.outcome) == int(a.outcome)
        np.testing.assert_array_equal(np.asarray(b.installed)[: p.n_vars],
                                      np.asarray(a.installed)[: p.n_vars])
        np.testing.assert_array_equal(np.asarray(b.core)[: p.n_cons],
                                      np.asarray(a.core)[: p.n_cons])
        assert int(b.steps) == int(a.steps)
        assert int(b.trace_n) == int(a.trace_n)


@pytest.mark.parametrize("cap", [0, 1])
def test_watched_solves_match_jax(monkeypatch, cap):
    """Whole solves under watched, on real banks (``cap`` 0: the size
    class's cap) and on dummy banks (``BANK_OCC_CAP`` 1 on both sides),
    where every fixpoint is the dense rounds and no pop is made."""
    monkeypatch.setattr(jdriver, "BANK_OCC_CAP", cap)
    monkeypatch.setattr(tdriver, "BANK_OCC_CAP", cap)
    jp, tp = _solve_pairs()
    jcore.set_bcp_impl("watched")
    want = jdriver.solve_problems(jp)
    tcore.set_bcp_impl("watched")
    pops = tbank.plain_work["pops"]
    got = tdriver.solve_problems(tp, device="cpu")
    _lanes_equal(jp, want, got)
    assert {int(a.outcome) for a in want} == {jcore.SAT, jcore.UNSAT}
    assert (tbank.plain_work["pops"] > pops) == (cap == 0)
