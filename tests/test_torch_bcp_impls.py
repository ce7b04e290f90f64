"""Every BCP impl of the port against the JAX package, on the CPU.

The reference takes six impl names (``deppy_tpu/engine/core.py:488-508``);
so does the port.  These tests hold each through the port's plain versions
(the CUDA kernels' arms are held against them on the card by
``chip_smoke.py``):

* ``set_bcp_impl`` takes every name of ``_BCP_IMPLS`` and raises
  ``ValueError`` on any other; ``auto`` resolves to ``bits``;
* the hand-built cases of ``tests/test_bcp_impls.py`` (a unit chain, a
  conflict, AtMost forcing and overflow, the extras bound), through
  ``core.planes_fixpoint`` under ``gather``, ``bits``, ``pallas``,
  ``blockwise`` and ``watched``: the expected literals, and the JAX
  package's planes under the same impl;
* kernel 1's wrapper (``cuda_bcp.bcp_fixpoint``, its plain version here)
  under the gather and watched arms and the pallas impl's dense full
  space, from random partial states, against ``core.planes_fixpoint``
  of the JAX package under the same impl; and the impls against each
  other, gather the spec (``tests/test_bcp_impls.py:190-210``);
* the shape rule: every watched and gather launch of kernels 1, 4 and 5
  goes to the block team, pallas keeps the dense rounds' rule;
* the phase wrappers under ``impl="gather"`` and ``"pallas"`` against
  ``core.batched_search`` / ``batched_minimize_gated`` /
  ``batched_core`` under the same ``set_bcp_impl``;
* whole solves under every impl against the JAX driver (outcome,
  installed, core, steps, backtracks), the duplicate-identifier cases of
  ``tests/test_bcp_impls.py:141-188`` among them.

Every comparison is exact (tolerance 0).  The gather rounds count per
occurrence and the others per variable; the encoder gives set semantics,
so on encoded problems they agree.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deppy_tpu import sat as jsat
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import pinned_tenant_catalog, random_instance
from deppy_tpu.sat.encode import encode
from deppy_tpu_torch import models as tm
from deppy_tpu_torch import sat as tsat
from deppy_tpu_torch.engine import convert, cuda_bcp, cuda_search, teams
from deppy_tpu_torch.engine import core as tcore
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.sat.encode import encode as tencode

BUDGET = 1 << 20
IMPLS = ["gather", "bits", "pallas", "blockwise", "watched"]


@pytest.fixture(autouse=True)
def _restore_impls():
    yield
    jcore.set_bcp_impl("auto")
    tcore.set_bcp_impl("auto")


def test_set_bcp_impl_takes_every_reference_name():
    assert tcore._BCP_IMPLS == jcore._BCP_IMPLS
    assert tcore.resolved_impl() == "bits"
    for name in tcore._BCP_IMPLS:
        tcore.set_bcp_impl(name)
        want = "bits" if name == "auto" else name
        assert tcore.resolved_impl() == want
        assert tcore.phases_reduced() == (want in ("bits", "watched"))
    for bad in ("nope", "Bits", "", "warp"):
        with pytest.raises(ValueError):
            tcore.set_bcp_impl(bad)
    assert tcore.resolved_impl() == "watched"


# --------------------------------------------------------------------------
# the fixpoint, one problem at a time


def _lane(problems, d, host, b):
    return (jcore.ProblemTensors(*[jnp.asarray(x[b]) for x in host]),
            tcore.lane(convert.problem_tensors_from_numpy(host), b))


def _jax_fixpoint(jpt, d, t, f, mb, mw, impl):
    jcore.set_bcp_impl(impl)
    c, t2, f2 = jcore.planes_fixpoint(
        jpt, jnp.asarray(t)[None], jnp.asarray(f)[None],
        jnp.asarray(mb)[None], jnp.int32(mw), jnp.bool_(True), d.V)
    return bool(c), np.asarray(t2)[0], np.asarray(f2)[0]


def _port_fixpoint(tpt, t, f, mb, mw, impl):
    c, t2, f2 = tcore.planes_fixpoint(
        tpt, torch.as_tensor(t), torch.as_tensor(f), torch.as_tensor(mb), mw,
        True, red=False, block_rows=2048 if impl == "blockwise" else 0,
        impl=impl)
    return c, t2.numpy(), f2.numpy()


def _pack(mask, W):
    return np.array(jcore.pack_mask(jnp.asarray(mask), W))[0]


def _case_unit_chain():
    vs = [jsat.variable("a", jsat.mandatory(), jsat.dependency("b")),
          jsat.variable("b", jsat.dependency("c")), jsat.variable("c")]
    return vs, {"a": jcore.TRUE}, (), 0, {"b": True, "c": True}


def _case_conflict():
    vs = [jsat.variable("a", jsat.mandatory(), jsat.conflict("b")),
          jsat.variable("b")]
    return vs, {"a": jcore.TRUE, "b": jcore.TRUE}, (), 0, None


def _case_atmost_forces():
    vs = [jsat.variable("a", jsat.at_most(1, "b", "c")), jsat.variable("b"),
          jsat.variable("c")]
    return vs, {"b": jcore.TRUE}, (), 0, {"c": False}


def _case_atmost_overflow():
    vs = [jsat.variable("a", jsat.at_most(1, "b", "c")), jsat.variable("b"),
          jsat.variable("c")]
    return vs, {"b": jcore.TRUE, "c": jcore.TRUE}, (), 0, None


def _case_min_bound(w):
    def case():
        vs = [jsat.variable("a", jsat.mandatory()), jsat.variable("b")]
        return vs, {"b": jcore.TRUE}, ("b",), w, None if w == 0 else {}
    return case


def _case_min_saturation():
    vs = [jsat.variable("a", jsat.mandatory()), jsat.variable("b"),
          jsat.variable("c")]
    return vs, {"b": jcore.TRUE}, ("b", "c"), 1, {"c": False}


CASES = {
    "unit_chain": _case_unit_chain,
    "conflict": _case_conflict,
    "atmost_forces": _case_atmost_forces,
    "atmost_overflow": _case_atmost_overflow,
    "min_bound_0": _case_min_bound(0),
    "min_bound_1": _case_min_bound(1),
    "min_saturation": _case_min_saturation,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_built_cases_under_every_impl(case):
    """``expect`` None: a conflict; else no conflict and each named
    variable true or false."""
    vs, assume, min_ids, min_w, expect = CASES[case]()
    p = encode(vs)
    d = jdriver._Dims([p], 1)
    host = jdriver.pad_stack([p], d, 1, pack=True)
    jpt, tpt = _lane([p], d, host, 0)
    base = np.array(jcore._base_assignment(jpt, d.V, d.NCON))
    for ident, val in assume.items():
        base[p.id_to_index[ident]] = val
    mm = np.zeros(d.V, bool)
    for ident in min_ids:
        mm[p.id_to_index[ident]] = True
    t = _pack(base == jcore.TRUE, d.Wv)
    f = _pack(base == jcore.FALSE, d.Wv)
    mb = _pack(mm, d.Wv)
    for impl in IMPLS:
        got = _port_fixpoint(tpt, t, f, mb, min_w, impl)
        want = _jax_fixpoint(jpt, d, t, f, mb, min_w, impl)
        assert got[0] == want[0] == (expect is None), impl
        if expect is None:
            continue
        np.testing.assert_array_equal(got[1], want[1], err_msg=impl)
        np.testing.assert_array_equal(got[2], want[2], err_msg=impl)
        for ident, on in expect.items():
            v = p.id_to_index[ident]
            plane = got[1] if on else got[2]
            assert (int(plane[v // 32]) >> (v % 32)) & 1, (impl, ident)


def _random_states(seed):
    """A padded batch of random instances and, per lane, a random partial
    state with an extras bound on the odd lanes."""
    rng = np.random.default_rng(seed)
    problems = [encode(random_instance(length=24, seed=4 * seed + i))
                for i in range(6)]
    d = jdriver._Dims(problems, len(problems))
    host = jdriver.pad_stack(problems, d, len(problems), pack=True)
    states = []
    for b, p in enumerate(problems):
        jpt = jcore.ProblemTensors(*[jnp.asarray(x[b]) for x in host])
        base = np.array(jcore._base_assignment(jpt, d.V, d.NCON))
        k = int(rng.integers(0, 5))
        for v in rng.choice(p.n_vars, size=k, replace=False):
            base[v] = rng.choice([jcore.TRUE, jcore.FALSE])
        mm = np.zeros(d.V, bool)
        mw = 0
        if b % 2:
            mm[rng.choice(p.n_vars, size=min(3, p.n_vars),
                          replace=False)] = True
            mw = int(rng.integers(0, 2))
        states.append((_pack(base == jcore.TRUE, d.Wv),
                       _pack(base == jcore.FALSE, d.Wv), _pack(mm, d.Wv),
                       mw))
    return problems, d, host, states


@pytest.mark.parametrize("seed", range(2))
def test_kernel_1_arms_match_jax(seed):
    """Kernel 1's wrapper under each new impl on one batch of random
    partial states (no entry overlap: the kernel has no such check)
    against the JAX package's fixpoint under the same impl, and the
    impls against gather."""
    problems, d, host, states = _random_states(seed)
    tpts = convert.problem_tensors_from_numpy(host)
    n = len(problems)
    t0, f0, mb = (torch.as_tensor(np.stack([s[i] for s in states]))
                  for i in range(3))
    mw = torch.tensor([s[3] for s in states], dtype=torch.int32)
    act = cuda_search.full_activity(tpts, tcore.planes_to_assign(
        t0, f0, d.V)).to(torch.int32)
    planes = (tpts.pos_bits, tpts.neg_bits, tpts.card_member_bits)
    arms = {"gather": cuda_bcp.Arm("gather", tpts.clauses, tpts.card_ids,
                                   tpts.n_vars),
            "watched": cuda_bcp.Arm("watched", tpts.clauses, tpts.card_ids,
                                    tpts.n_vars, tpts.occ_pos, tpts.occ_neg,
                                    tpts.card_occ),
            "pallas": None}
    outs = {}
    for impl, arm in arms.items():
        outs[impl] = cuda_bcp.bcp_fixpoint(
            *planes, act, tpts.card_n, mb, mw, t0, f0,
            torch.ones(n, dtype=torch.int32), impl=impl, arm=arm)
        for b in range(n):
            jpt = jcore.ProblemTensors(*[jnp.asarray(x[b]) for x in host])
            want = _jax_fixpoint(jpt, d, *states[b], impl)
            assert bool(outs[impl][0][b]) == want[0], (impl, b)
            if not want[0]:
                np.testing.assert_array_equal(outs[impl][1][b].numpy(),
                                              want[1])
                np.testing.assert_array_equal(outs[impl][2][b].numpy(),
                                              want[2])
    ok = outs["gather"][0] == 0
    for impl in ("pallas", "watched"):
        assert torch.equal(outs[impl][0], outs["gather"][0])
        assert torch.equal(outs[impl][1][ok], outs["gather"][1][ok])
        assert torch.equal(outs[impl][2][ok], outs["gather"][2][ok])


def test_team_rule_sends_watched_and_gather_to_the_block_team():
    C, NA, W, NV = 64, 4, 2, 32
    for impl in ("watched", "gather", "blockwise"):
        for kernel in ("bcp", "minimize", "core"):
            NCON = 32 if kernel == "core" else 0
            assert teams.plan(kernel, 0, C, NA, W, NV, NCON, None,
                              impl) == ("block", False)
            with pytest.raises(ValueError, match=impl):
                teams.plan(kernel, 0, C, NA, W, NV, NCON, "warp", impl)
    for impl in ("bits", "pallas"):
        assert teams.plan("bcp", 0, C, NA, W, 0, 0, None, impl)[0] == "warp"
        assert teams.team(0, W, 1024, impl) == "warp"
    assert teams.team(0, W, 1024) == "warp"


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


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_phases_plain_match_jax(impl):
    """Phases 1, 2 and 3 chained under ``impl`` (full space): every lane
    against the JAX programs under the same ``set_bcp_impl``."""
    jcore.set_bcp_impl(impl)
    problems = _random_problems()
    d = jdriver._Dims(problems, len(problems))
    host = jdriver.pad_stack(problems, d, d.B, pack=True)
    en = np.arange(d.B) < len(problems)
    jpts = jcore.ProblemTensors(*[jnp.asarray(x) for x in host])
    tpts = convert.problem_tensors_from_numpy(host)
    ten = torch.as_tensor(en)
    kw = dict(impl=impl, NCON=d.NCON)
    rounds = tcore.plain_rounds

    p1 = jcore.batched_search(d.V, d.NCON, d.NV, 0)(
        jpts, jnp.int32(BUDGET), jnp.asarray(en))
    got1 = cuda_search.batched_search_fused(tpts, BUDGET, ten, **kw)
    _assert_equal([p1[0], np.asarray(p1[1])[:, :d.NV],
                   np.asarray(p1[2])[:, :d.NV], p1[3], p1[5]],
                  [got1[0], got1[1], got1[2], got1[3], got1[5]])
    assert tcore.plain_rounds > rounds

    result, guessed, model, steps = got1[0], got1[1], got1[2], got1[3]
    want2 = jcore.batched_minimize_gated(d.V, d.NCON, d.NV)(
        jpts, p1[0], p1[2], p1[1], jnp.int32(BUDGET), p1[3], jnp.asarray(en))
    got2 = cuda_search.batched_minimize_fused(
        tpts, result, model, guessed, BUDGET, steps, ten, **kw)
    _assert_equal(want2, got2)

    gate = en & (np.asarray(p1[0]) == jcore.UNSAT)
    assert gate.any()
    want3 = jcore.batched_core(d.V, d.NCON, d.NV)(
        jpts, jnp.int32(BUDGET), p1[3], jnp.asarray(gate))
    got3 = cuda_search.batched_core_fused(
        tpts, BUDGET, steps, torch.as_tensor(gate), **kw)
    _assert_equal(want3, got3)


def test_gather_reads_no_plane():
    """Under gather the phase wrappers read the raw rows alone: the
    same outputs on ``[B, rows, 1]`` placeholder planes."""
    problems = _random_problems()[4:]
    d = jdriver._Dims(problems, len(problems))
    host = jdriver.pad_stack(problems, d, d.B, pack=True)
    tpts = convert.problem_tensors_from_numpy(host)
    bare = tpts._replace(**{
        name: torch.zeros(getattr(tpts, name).shape[:2] + (1,),
                          dtype=torch.int32)
        for name in ("pos_bits", "neg_bits", "card_member_bits",
                     "card_act_bits", "pos_bits_r", "neg_bits_r",
                     "card_member_bits_r")})
    en = torch.arange(d.B) < len(problems)
    kw = dict(impl="gather", NCON=d.NCON)
    want = cuda_search.batched_search_fused(tpts, BUDGET, en, **kw)
    got = cuda_search.batched_search_fused(bare, BUDGET, en, **kw)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def _degenerate():
    """tests/test_bcp_impls.py:141-188: duplicate AtMost members, a
    self-conflict, duplicate dependency targets."""
    def build(s):
        return [
            [s.variable("a", s.at_most(1, "b", "b")),
             s.variable("b", s.mandatory())],
            [s.variable("a", s.mandatory(), s.conflict("a"))],
            [s.variable("a", s.mandatory(), s.dependency("b", "b", "c")),
             s.variable("b"), s.variable("c")],
        ]
    return build(jsat), build(tsat)


def _solve_pairs():
    """(JAX problems, port problems): random instances, conflict-heavy
    ones and 2 UNSAT pinned-tenant catalogs."""
    pairs = [(random_instance(length=16, seed=s),
              tm.random_instance(length=16, seed=s)) for s in range(4)]
    pairs += [(random_instance(length=12, seed=s, p_mandatory=0.5,
                               p_conflict=0.5, n_conflict=3),
               tm.random_instance(length=12, seed=s, p_mandatory=0.5,
                                  p_conflict=0.5, n_conflict=3))
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


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_solves_match_jax(impl):
    jp, tp = _solve_pairs()
    jcore.set_bcp_impl(impl)
    want = jdriver.solve_problems(jp)
    tcore.set_bcp_impl(impl)
    got = tdriver.solve_problems(tp, device="cpu")
    _lanes_equal(jp, want, got)
    assert {int(a.outcome) for a in want} == {jcore.SAT, jcore.UNSAT}


@pytest.mark.parametrize("impl", IMPLS)
def test_degenerate_duplicates_match_jax(impl):
    jvs, tvs = _degenerate()
    jp = [encode(a) for a in jvs]
    jcore.set_bcp_impl(impl)
    want = jdriver.solve_problems(jp)
    tcore.set_bcp_impl(impl)
    got = tdriver.solve_problems([tencode(b) for b in tvs], device="cpu")
    _lanes_equal(jp, want, got)
    assert [int(r.outcome) for r in want] == [jcore.SAT, jcore.UNSAT,
                                              jcore.SAT]
    b_index = jp[2].id_to_index
    assert bool(got[2].installed[b_index["b"]])
    assert not bool(got[2].installed[b_index["c"]])


def test_every_impl_gives_the_bits_answers():
    _, tp = _solve_pairs()
    answers = {}
    for impl in IMPLS:
        tcore.set_bcp_impl(impl)
        answers[impl] = [(r.outcome, r.installed.tolist(), r.core.tolist(),
                          r.steps, r.trace_n)
                         for r in tdriver.solve_problems(tp, device="cpu")]
    for impl in IMPLS:
        assert answers[impl] == answers["bits"], impl
