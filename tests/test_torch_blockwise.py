"""The blockwise BCP impl of the port against the JAX package, on the CPU.

* ``cuda_blockwise.bcp_fixpoint`` (its plain version here) against
  ``pallas_blockwise.bcp_fixpoint`` in interpret mode, at block_rows 1, 2,
  3 and 8, on the cases of ``tests/test_pallas_blockwise.py`` (a 24-link
  cross-block chain, a conflict, row padding) and on lanes of
  ``gvk_conflict_catalog`` and ``version_pinned_chains`` (AtMost rows,
  which ride block 0) under an extras bound: the conflict flag always,
  and t/f where there is no conflict;
* the phase wrappers under ``impl="blockwise"`` (full plane space) against
  ``core.batched_search`` / ``batched_minimize_gated`` / ``batched_core``
  under ``set_bcp_impl("blockwise")``;
* whole solves: ``driver.solve_problems`` on ``device="cpu"`` against the
  JAX driver, both under blockwise with 4-row blocks (outcome, installed,
  core, steps, backtracks), and the port's blockwise answers against its
  bits answers.

Every comparison is exact (tolerance 0): the outputs are integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deppy_tpu import sat as jsat
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.engine import pallas_blockwise
from deppy_tpu.models import (gvk_conflict_catalog, pinned_tenant_catalog,
                              random_instance, version_pinned_chains)
from deppy_tpu.sat.encode import encode
from deppy_tpu_torch import models as tm
from deppy_tpu_torch.engine import convert, cuda_blockwise, cuda_search
from deppy_tpu_torch.engine import core as tcore
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.sat.encode import encode as tencode

BUDGET = 1 << 20


@pytest.fixture(autouse=True)
def _restore_impls():
    yield
    jcore.set_bcp_impl("auto")
    tcore.set_bcp_impl("auto")


# --------------------------------------------------------------------------
# the standalone fixpoint


def _chain():
    n = 24
    vs = [jsat.variable("a0", jsat.mandatory(), jsat.dependency("a1"))]
    vs += [jsat.variable(f"a{i}", jsat.dependency(f"a{i + 1}"))
           for i in range(1, n - 1)]
    return [vs + [jsat.variable(f"a{n - 1}")]]


def _conflict():
    return [[jsat.variable("a", jsat.mandatory(), jsat.dependency("b")),
             jsat.variable("b", jsat.conflict("c")),
             jsat.variable("c", jsat.mandatory())]]


def _padding():
    return [[jsat.variable("a", jsat.mandatory(), jsat.dependency("b")),
             jsat.variable("b")]]


def _gvk():
    return [gvk_conflict_catalog(8, 3, 4, seed=s) for s in range(8)]


def _chains():
    return [version_pinned_chains(6, 3, seed=s) for s in range(4)]


CASES = {"chain": _chain, "conflict": _conflict, "padding": _padding,
         "gvk": _gvk, "chains": _chains}


def _fixpoint_inputs(problems, with_extras: bool):
    """Per lane the full-space inputs of one fixpoint from the anchors:
    (pos, neg, mem, card_active, card_n, min_bits, min_w, t0, f0) as
    numpy, the extras bound over the first problem variables when asked."""
    d = jdriver._Dims(problems, len(problems))
    pts = jdriver.pad_stack(problems, d, len(problems), pack=True)
    lanes = []
    for b, p in enumerate(problems):
        pt = jcore.ProblemTensors(*[jnp.asarray(x[b]) for x in pts])
        base = jcore._apply_anchors(
            pt, jcore._base_assignment(pt, d.V, d.NCON), d.V)
        t0 = np.asarray(jcore.pack_mask(base == jcore.TRUE, d.Wv))[0]
        f0 = np.asarray(jcore.pack_mask(base == jcore.FALSE, d.Wv))[0]
        act = np.asarray(((pt.card_act_bits & jnp.asarray(t0)[None]) != 0)
                         .any(axis=1)).astype(np.int32)
        extras = np.arange(d.V) < (min(p.n_vars, 6) if with_extras else 0)
        mb = np.asarray(jcore.pack_mask(jnp.asarray(extras), d.Wv))[0]
        lanes.append((pts.pos_bits[b], pts.neg_bits[b],
                      pts.card_member_bits[b], act, pts.card_n[b], mb,
                      np.int32(1 if with_extras else 0), t0, f0))
    return lanes


@pytest.mark.parametrize("block_rows", [1, 2, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fixpoint_plain_matches_pallas_blockwise(case, block_rows):
    problems = [encode(vs) for vs in CASES[case]()]
    lanes = _fixpoint_inputs(problems, with_extras=case in ("gvk", "chains"))
    want = []
    for pos, neg, mem, act, card_n, mb, mw, t0, f0 in lanes:
        c, t, f = pallas_blockwise.bcp_fixpoint(
            jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mem),
            jnp.asarray(act != 0)[:, None], jnp.asarray(card_n)[:, None],
            jnp.asarray(mb)[None], jnp.int32(mw), jnp.asarray(t0)[None],
            jnp.asarray(f0)[None], enabled=True, block_rows=block_rows)
        want.append((bool(c), np.asarray(t)[0], np.asarray(f)[0]))
    cols = [torch.as_tensor(np.stack(x).astype(np.int32))
            for x in zip(*lanes)]
    en = torch.ones(len(lanes), dtype=torch.int32)
    sweeps = tcore.plain_sweeps
    got = cuda_blockwise.bcp_fixpoint(*cols, en, block_rows=block_rows)
    sweeps = tcore.plain_sweeps - sweeps
    for b, (c, t, f) in enumerate(want):
        assert bool(got[0][b]) == c, b
        if not c:
            np.testing.assert_array_equal(got[1][b].numpy(), t)
            np.testing.assert_array_equal(got[2][b].numpy(), f)
    if case == "conflict":
        assert want[0][0]
    if case == "chain" and block_rows < 8:
        # The chain's links run against row order: more than one sweep.
        assert sweeps > 1


def test_fixpoint_disabled_lane_runs_nothing():
    problems = [encode(vs) for vs in _chain()]
    lane = _fixpoint_inputs(problems, with_extras=False)[0]
    cols = [torch.as_tensor(np.array(x, np.int32))[None] for x in lane]
    r0, s0 = tcore.plain_rounds, tcore.plain_sweeps
    c, t, f = cuda_blockwise.bcp_fixpoint(
        *cols, torch.zeros(1, dtype=torch.int32), block_rows=2)
    assert (tcore.plain_rounds, tcore.plain_sweeps) == (r0, s0)
    assert int(c[0]) == 0
    assert torch.equal(t, cols[7]) and torch.equal(f, cols[8])


def test_tile_rows_caps_to_shared_memory():
    assert cuda_blockwise.tile_rows(2048, 8192, 768, 1024) == 32
    assert cuda_blockwise.tile_rows(2048, 256, 12, 32) == 256
    assert cuda_blockwise.tile_rows(7, 256, 12, 32) == 7
    with pytest.raises(ValueError):
        cuda_blockwise.tile_rows(1, 8, 1 << 15, 1)


# --------------------------------------------------------------------------
# the phase kernels under blockwise


def _random_problems():
    return [encode(random_instance(length=16, seed=s)) for s in range(4)] + [
        encode(random_instance(length=12, seed=s, p_mandatory=0.5,
                               p_conflict=0.5, n_conflict=3))
        for s in range(4)]


def _batch(problems):
    d = jdriver._Dims(problems, len(problems))
    pts = jdriver.pad_stack(problems, d, d.B, pack=True)
    en = np.arange(d.B) < len(problems)
    jpts = jcore.ProblemTensors(*[jnp.asarray(x) for x in pts])
    return d, jpts, convert.problem_tensors_from_numpy(pts), en


def _assert_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(convert.to_numpy(b), np.asarray(a),
                                      err_msg=f"output {i}")


@pytest.mark.parametrize("block_rows", [2, 5])
def test_phases_plain_match_jax_blockwise(monkeypatch, block_rows):
    """Phases 1, 2 and 3 chained under blockwise: every lane against the
    JAX programs under ``set_bcp_impl("blockwise")`` with blocks of the
    same height."""
    monkeypatch.setattr(pallas_blockwise, "BLOCK_ROWS", block_rows)
    jcore.set_bcp_impl("blockwise")
    problems = _random_problems()
    d, jpts, tpts, en = _batch(problems)
    kw = dict(impl="blockwise", block_rows=block_rows, NCON=d.NCON)
    ten = torch.as_tensor(en)

    p1 = jcore.batched_search(d.V, d.NCON, d.NV, 0)(
        jpts, jnp.int32(BUDGET), jnp.asarray(en))
    got1 = cuda_search.batched_search_fused(tpts, BUDGET, ten, **kw)
    # The full space's guessed set and model are [V]; the port's [NV].
    _assert_equal([p1[0], np.asarray(p1[1])[:, :d.NV],
                   np.asarray(p1[2])[:, :d.NV], p1[3], p1[5]],
                  [got1[0], got1[1], got1[2], got1[3], got1[5]])

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
        tpts, BUDGET, steps, torch.as_tensor(gate), NCON=d.NCON,
        impl="blockwise", block_rows=block_rows)
    _assert_equal(want3, got3)


def test_phase_wrappers_reject_other_impls():
    problems = _random_problems()[:1]
    d, _, tpts, en = _batch(problems)
    with pytest.raises(ValueError):
        cuda_search.batched_search_fused(tpts, BUDGET, torch.as_tensor(en),
                                         impl="watched", NCON=d.NCON)
    with pytest.raises(ValueError):  # the full space needs NCON
        cuda_search.batched_search_fused(tpts, BUDGET, torch.as_tensor(en),
                                         impl="blockwise")


# --------------------------------------------------------------------------
# whole solves


def _solve_pairs():
    """(JAX problems, port problems): the 8 problems of
    test_pallas_blockwise.py's full-solve differential and 2 UNSAT
    pinned-tenant catalogs."""
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


def _lanes_equal(jp, a_res, b_res, steps=True):
    for p, a, b in zip(jp, a_res, b_res):
        assert int(b.outcome) == int(a.outcome)
        np.testing.assert_array_equal(np.asarray(b.installed)[: p.n_vars],
                                      np.asarray(a.installed)[: p.n_vars])
        np.testing.assert_array_equal(np.asarray(b.core)[: p.n_cons],
                                      np.asarray(a.core)[: p.n_cons])
        if steps:
            assert int(b.steps) == int(a.steps)
            assert int(b.trace_n) == int(a.trace_n)


def test_blockwise_solves_match_jax_blockwise(monkeypatch):
    monkeypatch.setattr(pallas_blockwise, "BLOCK_ROWS", 4)
    monkeypatch.setattr(cuda_blockwise, "BLOCK_ROWS", 4)
    jp, tp = _solve_pairs()
    jcore.set_bcp_impl("blockwise")
    want = jdriver.solve_problems(jp)
    tcore.set_bcp_impl("blockwise")
    got = tdriver.solve_problems(tp, device="cpu")
    _lanes_equal(jp, want, got)
    outcomes = {int(a.outcome) for a in want}
    assert outcomes == {jcore.SAT, jcore.UNSAT}
    assert int(want[-1].outcome) == jcore.UNSAT


def test_blockwise_answers_equal_bits_answers(monkeypatch):
    monkeypatch.setattr(cuda_blockwise, "BLOCK_ROWS", 8)
    jp, tp = _solve_pairs()
    tcore.set_bcp_impl("bits")
    bits = tdriver.solve_problems(tp, device="cpu")
    tcore.set_bcp_impl("blockwise")
    blockwise = tdriver.solve_problems(tp, device="cpu")
    _lanes_equal(tp, bits, blockwise)


# --------------------------------------------------------------------------
# impl selection


def test_impl_selection():
    assert tcore.resolved_impl() == "bits" and tcore.phases_reduced()
    tcore.set_bcp_impl("blockwise")
    assert tcore.resolved_impl() == "blockwise"
    assert not tcore.phases_reduced()
    tcore.set_bcp_impl("bits")
    assert tcore.phases_reduced()
    for name in ("gather", "pallas", "watched"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcore.set_bcp_impl(name)
    with pytest.raises(ValueError):
        tcore.set_bcp_impl("nope")
    assert tcore.resolved_impl() == "bits"
