"""The blockwise BCP impl of the port against the JAX package, on the CPU.

* ``cuda_blockwise.bcp_fixpoint_plain`` (dense planes) and the wrapper
  ``cuda_blockwise.bcp_fixpoint`` (compact clause and AtMost tensors, its
  plain version here) against ``pallas_blockwise.bcp_fixpoint`` in
  interpret mode, at block_rows 1, 2, 3 and 8 and at the tile the
  wrapper's ``tile_rows`` rule picks, on the cases of
  ``tests/test_pallas_blockwise.py`` (a 24-link cross-block chain, a
  conflict, row padding) and on lanes of ``gvk_conflict_catalog`` and
  ``version_pinned_chains`` (AtMost rows, which ride block 0) under an
  extras bound: the conflict flag always, and t/f where there is no
  conflict;
* the kernel's compact rows (``cuda_blockwise.compact_rows``) rebuilt
  into planes against ``core.derive_planes`` on every family
  ``chip_smoke.py`` runs, and on rows with a repeated literal and with
  both x and ~x; the rows a solve builds once, cut by lane and checked
  against the batch they are given with; the placement rule; the search
  wrapper's AtMost activity from ``card_act`` against ``card_act_bits``;
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
    (pos, neg, mem, card_active, card_n, min_bits, min_w, t0, f0, clauses,
    card_ids) as numpy, the extras bound over the first problem variables
    when asked."""
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
                      np.int32(1 if with_extras else 0), t0, f0,
                      pts.clauses[b], pts.card_ids[b]))
    return lanes


def _pallas_fixpoints(lanes, block_rows):
    """(conflict, t, f) per lane from the Pallas kernel in interpret mode."""
    want = []
    for pos, neg, mem, act, card_n, mb, mw, t0, f0, _, _ in lanes:
        c, t, f = pallas_blockwise.bcp_fixpoint(
            jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mem),
            jnp.asarray(act != 0)[:, None], jnp.asarray(card_n)[:, None],
            jnp.asarray(mb)[None], jnp.int32(mw), jnp.asarray(t0)[None],
            jnp.asarray(f0)[None], enabled=True, block_rows=block_rows)
        want.append((bool(c), np.asarray(t)[0], np.asarray(f)[0]))
    return want


def _assert_fixpoints(want, got):
    for b, (c, t, f) in enumerate(want):
        assert bool(got[0][b]) == c, b
        if not c:
            np.testing.assert_array_equal(got[1][b].numpy(), t)
            np.testing.assert_array_equal(got[2][b].numpy(), f)


def _columns(lanes):
    """The lanes' inputs stacked into int32 tensors, then the wrapper's
    compact argument list (clauses, card_ids, card_active, card_n,
    min_bits, min_w, t0, f0, en)."""
    cols = [torch.as_tensor(np.stack(x).astype(np.int32))
            for x in zip(*lanes)]
    en = torch.ones(len(lanes), dtype=torch.int32)
    return cols, [cols[9], cols[10], *cols[3:9], en]


@pytest.mark.parametrize("block_rows", [1, 2, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fixpoint_plain_matches_pallas_blockwise(case, block_rows):
    problems = [encode(vs) for vs in CASES[case]()]
    lanes = _fixpoint_inputs(problems, with_extras=case in ("gvk", "chains"))
    want = _pallas_fixpoints(lanes, block_rows)
    cols, compact = _columns(lanes)
    sweeps = tcore.plain_sweeps
    got = cuda_blockwise.bcp_fixpoint_plain(*cols[:9], compact[-1],
                                            block_rows=block_rows)
    sweeps = tcore.plain_sweeps - sweeps
    _assert_fixpoints(want, got)
    # The wrapper on the compact tensors runs the same blocks.
    _assert_fixpoints(want, cuda_blockwise.bcp_fixpoint(
        *compact, block_rows=block_rows))
    if case == "conflict":
        assert want[0][0]
    if case == "chain" and block_rows < 8:
        # The chain's links run against row order: more than one sweep.
        assert sweeps > 1


@pytest.mark.parametrize("block_rows", [2, 5])
@pytest.mark.parametrize("case", ["chain", "gvk", "chains"])
def test_fixpoint_tile_rule_matches_pallas_blockwise(case, block_rows):
    """The wrapper's tile (``tile_rows`` of the compact widths) on problems
    with more clause rows than a tile: the plain version at that tile
    against the Pallas kernel at the same block height."""
    problems = [encode(vs) for vs in CASES[case]()]
    lanes = _fixpoint_inputs(problems, with_extras=case != "chain")
    cols, compact = _columns(lanes)
    B, C, K = compact[0].shape
    NA, M = compact[1].shape[1:]
    tile = cuda_blockwise.tile_rows(block_rows, C, K, M, cols[0].shape[2],
                                    NA)
    assert tile == block_rows < C
    _assert_fixpoints(_pallas_fixpoints(lanes, tile),
                      cuda_blockwise.bcp_fixpoint(*compact,
                                                  block_rows=block_rows))


def test_fixpoint_disabled_lane_runs_nothing():
    problems = [encode(vs) for vs in _chain()]
    lane = _fixpoint_inputs(problems, with_extras=False)[0]
    _, compact = _columns([lane])
    compact[-1] = torch.zeros(1, dtype=torch.int32)
    r0, s0 = tcore.plain_rounds, tcore.plain_sweeps
    c, t, f = cuda_blockwise.bcp_fixpoint(*compact, block_rows=2)
    assert (tcore.plain_rounds, tcore.plain_sweeps) == (r0, s0)
    assert int(c[0]) == 0
    assert torch.equal(t, compact[6]) and torch.equal(f, compact[7])


def test_tile_rows_caps_to_shared_memory():
    """``min(block_rows, C, rows whose compact literals fit)``: two tiles
    of int16 rows beside the working words and the AtMost lists."""
    tile_rows = cuda_blockwise.tile_rows
    # The giant catalog's and the 64-catalog batch's dims: the
    # reference's 2048 rows, so 4 tiles and 1.
    assert tile_rows(2048, 8192, 16, 8, 768, 1024) == 2048
    assert tile_rows(2048, 2048, 16, 8, 192, 256) == 2048
    assert tile_rows(7, 256, 16, 8, 12, 32) == 7
    assert tile_rows(2048, 64, 16, 8, 4, 1) == 64
    # Wide rows: the largest tile whose two buffers fit.
    W, NA, M, K = 768, 1024, 8, 256
    cap = tile_rows(1 << 20, 1 << 20, K, M, W, NA)
    fixed = cuda_blockwise._fixed_bytes(W, NA, M, 2)
    assert cap < 2048
    assert fixed + 2 * cap * K * 2 <= cuda_blockwise.SMEM_BYTES
    assert fixed + 2 * (cap + 8) * K * 2 > cuda_blockwise.SMEM_BYTES
    # int32 literals once the planes hold 32,768 variables or more.
    assert cuda_blockwise.lit_bytes(1023) == 2
    assert cuda_blockwise.lit_bytes(1024) == 4
    with pytest.raises(ValueError):  # one row does not fit
        tile_rows(1, 8, 1 << 16, 8, 12, 1)
    with pytest.raises(ValueError):  # nor do the AtMost lists
        tile_rows(1, 8, 16, 1 << 14, 12, 64)
    with pytest.raises(ValueError):
        tile_rows(0, 8, 16, 8, 12, 1)


# --------------------------------------------------------------------------
# compact rows


def _planes_of(rows, card_act, W):
    """Compact rows rebuilt into (pos, neg, mem, card_act_bits) planes."""
    pos, neg = tcore._batch_planes(rows.lits.to(torch.int32), W)
    members = rows.mlits.to(torch.int32) - 1
    mem = tcore._batch_index_planes(members, W)
    act = tcore._batch_index_planes(card_act.unsqueeze(-1), W)
    return pos, neg, mem, act


def _chip_smoke_families():
    """Three lanes of each family chip_smoke.py runs, and one giant
    catalog."""
    import chip_smoke

    fams = [(name, make) for name, _, make in chip_smoke.families(1.0)]
    fams += [("forced_extras", chip_smoke.forced_extras),
             ("repeated", chip_smoke.repeated_literals),
             ("operatorhub", lambda i: tm.operatorhub_catalog(40, 5, seed=i)),
             ("operatorhub_batch",
              lambda i: tm.operatorhub_catalog(*chip_smoke.BATCH, seed=i))]
    out = [(name, [tencode(make(i)) for i in range(3)]) for name, make in fams]
    out.append(("giant", [tencode(tm.operatorhub_catalog(*chip_smoke.GIANT,
                                                         seed=0))]))
    return out


def test_compact_rows_rebuild_the_planes_of_every_family():
    import chip_smoke

    for name, probs in _chip_smoke_families():
        d = tdriver._Dims(probs, len(probs))
        pts = convert.problem_tensors_from_numpy(
            tdriver.pad_stack(probs, d, len(probs)))
        if name == "repeated":
            pts = chip_smoke.with_repeats(pts)
            assert (cuda_blockwise.compact_rows(pts.clauses, pts.card_ids,
                                                d.Wv).lits != 0).sum() < (
                pts.clauses != 0).sum()
        want = tcore.derive_planes(pts.clauses, pts.card_ids, pts.card_act,
                                   pts.n_vars, Wv=d.Wv, Wr=d.Wr, red=False)
        rows = cuda_blockwise.compact_rows(pts.clauses, pts.card_ids, d.Wv)
        assert rows.lits.dtype == torch.int16, name
        assert rows.lits.shape[2] <= d.K and rows.mlits.shape[2] <= d.M + 1
        got = _planes_of(rows, pts.card_act, d.Wv)
        for i, (a, b) in enumerate(zip(want[:4], got)):
            assert torch.equal(a, b), (name, i)


def test_compact_rows_drop_repeated_literals_and_keep_x_or_not_x():
    # Rows: a repeated literal, x | ~x, a literal three times, padding.
    clauses = torch.tensor([[[3, -2, 3, 0], [1, -1, 0, 0],
                             [-4, 2, -4, -4], [0, 0, 0, 0]]], dtype=torch.int32)
    # AtMost rows: a repeated member, and a padded row.
    card_ids = torch.tensor([[[0, 2, 0], [-1, -1, -1]]], dtype=torch.int32)
    card_act = torch.tensor([[5, -1]], dtype=torch.int32)
    rows = cuda_blockwise.compact_rows(clauses, card_ids, 1)
    assert rows.lits.tolist() == [[[-2, 3], [-1, 1], [-4, 2], [0, 0]]]
    assert rows.mlits.tolist() == [[[1, 3], [0, 0]]]
    pos, neg = tcore._batch_planes(clauses, 1)
    mem = tcore._batch_index_planes(card_ids, 1)
    act = tcore._batch_index_planes(card_act.unsqueeze(-1), 1)
    got = _planes_of(rows, card_act, 1)
    for a, b in zip((pos, neg, mem, act), got):
        assert torch.equal(a, b)
    # Each distinct literal counts once among a row's unassigned ones, as
    # the planes' popcounts do: x | ~x has two, the others one and two.
    n_un = (rows.lits != 0).sum(-1)
    pops = (tcore.popcount32(pos) + tcore.popcount32(neg)).sum(-1)
    assert torch.equal(n_un, pops.to(n_un.dtype))
    # Planes of 32,768 variables or more take int32 literals.
    assert cuda_blockwise.compact_rows(clauses, card_ids,
                                       1024).lits.dtype == torch.int32


def _family_batch(make, n=4):
    probs = [tencode(make(i)) for i in range(n)]
    d = tdriver._Dims(probs, n)
    pts = convert.problem_tensors_from_numpy(tdriver.pad_stack(probs, d, n))
    return d, pts


def test_compact_rows_given_once_are_cut_and_checked():
    """The rows a solve builds once: lanes cut by slice or index like the
    batch's own, and rows that do not belong to a batch rejected."""
    d, pts = _family_batch(lambda i: tm.version_pinned_chains(6, 3, seed=i))
    rows = cuda_blockwise.compact_rows(pts.clauses, pts.card_ids, d.Wv)
    sel = torch.tensor([3, 1])
    for cut in (slice(1, 3), sel):
        part = tdriver._rows(pts, cut)
        want = cuda_blockwise.compact_rows(part.clauses, part.card_ids, d.Wv)
        got = cuda_blockwise.rows_for(part.clauses, part.card_ids, d.Wv,
                                      rows.take(cut))
        n = want.lits.shape[2]
        assert torch.equal(got.lits[..., :n], want.lits)
        assert not got.lits[..., n:].any()
        n = want.mlits.shape[2]
        assert torch.equal(got.mlits[..., :n], want.mlits)
        assert not got.mlits[..., n:].any()
    assert cuda_blockwise.rows_for(pts.clauses, pts.card_ids, d.Wv,
                                   rows) is rows
    built = cuda_blockwise.rows_for(pts.clauses, pts.card_ids, d.Wv)
    assert torch.equal(built.lits, rows.lits) and built.placement == "auto"
    for bad in (rows.take(slice(0, 2)),  # another batch's lanes
                rows._replace(lits=rows.lits.to(torch.int32))):  # width
        with pytest.raises(ValueError):
            cuda_blockwise.rows_for(pts.clauses, pts.card_ids, d.Wv, bad)
    with pytest.raises(ValueError):  # int16 rows for int32 planes
        cuda_blockwise.rows_for(pts.clauses, pts.card_ids, 1024, rows)


def test_resident_follows_the_placement():
    """``auto`` keeps the rows resident when one tile holds them all;
    ``resident`` and ``streamed`` force a placement for measurement."""
    d, pts = _family_batch(lambda i: tm.version_pinned_chains(6, 3, seed=i))
    rows = cuda_blockwise.compact_rows(pts.clauses, pts.card_ids, d.Wv)
    resident = cuda_blockwise.resident
    C = d.C
    assert resident(rows, d.Wv, C) and not resident(rows, d.Wv, C - 1)
    forced = rows._replace(placement="resident")
    assert resident(forced, d.Wv, 1)
    assert not resident(rows._replace(placement="streamed"), d.Wv, C)
    assert cuda_blockwise.launch_args(rows, d.Wv, 1)[-1] == 0
    assert cuda_blockwise.launch_args(forced, d.Wv, 1)[-1] == 1
    with pytest.raises(ValueError):
        resident(rows._replace(placement="pinned"), d.Wv, C)


def test_full_activity_matches_card_act_bits():
    """The search wrapper's AtMost activity from ``card_act`` equals the
    dense ``card_act_bits`` rows against the packed assignment."""
    d, pts = _family_batch(lambda i: tm.version_pinned_chains(6, 3, seed=i))
    pts = tcore.with_planes(pts, Wv=d.Wv, Wr=d.Wr, red=False, full=True)
    base = tcore._base_assignment(pts, d.V, d.NCON)
    rng = np.random.default_rng(0)
    for _ in range(4):
        flip = torch.as_tensor(rng.random(base.shape) < 0.5)
        assign = torch.where(flip, tcore.FALSE, base).to(torch.int32)
        t = tcore.pack_mask(assign == tcore.TRUE, d.Wv)
        want = ((pts.card_act_bits & t.unsqueeze(1)) != 0).any(-1)
        got = cuda_search.full_activity(pts, assign)
        assert torch.equal(got, want)
        assert got.any() and not got.all()


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
                                         impl="nope", NCON=d.NCON)
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
        tcore.set_bcp_impl(name)
        assert tcore.resolved_impl() == name
        assert tcore.phases_reduced() == (name == "watched")
    tcore.set_bcp_impl("bits")
    with pytest.raises(ValueError):
        tcore.set_bcp_impl("nope")
    assert tcore.resolved_impl() == "bits"
