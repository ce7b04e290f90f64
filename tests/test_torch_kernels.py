"""Each CUDA kernel's plain version against the JAX function it ports.

On the CPU every kernel wrapper of ``deppy_tpu_torch`` runs its plain
PyTorch version (the tensors lie on the CPU), so these tests pin the
arithmetic the kernels are held to on the card:

* kernel 1, ``cuda_bcp.bcp_fixpoint``, against ``pallas_bcp.bcp_fixpoint``
  in interpret mode, on the cases of ``tests/test_bcp_impls.py``;
* kernels 3-5, ``cuda_search.batched_{search,minimize,core}_fused``,
  against ``core.batched_search`` / ``batched_minimize_gated`` /
  ``batched_core`` on the distributions of ``tests/test_pallas_search.py``
  (random instances of lengths 16 and 24, deep chains, budgets 1/3/17),
  and once each against ``pallas_search.batched_*_fused`` in interpret
  mode.

Both sides receive the same padded numpy arrays; every output is an
integer or a bool and must be equal (tolerance 0): results, models,
guessed sets, cores, step and backtrack counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deppy_tpu import sat
from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.engine import pallas_bcp, pallas_search
from deppy_tpu.models import random_instance, version_pinned_chains
from deppy_tpu.sat.encode import encode
from deppy_tpu.sat.errors import NotSatisfiable
from deppy_tpu.sat.host import HostEngine
from deppy_tpu_torch.engine import convert, cuda_bcp, cuda_search

BUDGET = 1 << 20


def _batch(problems, pack=True):
    """(dims, JAX ProblemTensors, port ProblemTensors, en numpy) for one
    padded batch; trailing lanes are padding."""
    d = jdriver._Dims(problems, len(problems))
    pts = jdriver.pad_stack(problems, d, d.B, pack=pack)
    en = np.arange(d.B) < len(problems)
    jpts = jcore.ProblemTensors(*[jnp.asarray(x) for x in pts])
    return d, jpts, convert.problem_tensors_from_numpy(pts), en


def _assert_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        b = convert.to_numpy(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f"output {i}")


# --------------------------------------------------------------------------
# kernel 1: the BCP fixpoint


def _bcp_case_unit_chain():
    vs = [sat.variable("a", sat.mandatory(), sat.dependency("b")),
          sat.variable("b", sat.dependency("c")), sat.variable("c")]
    return vs, {"a": jcore.TRUE}, (), 0


def _bcp_case_conflict():
    vs = [sat.variable("a", sat.mandatory(), sat.conflict("b")),
          sat.variable("b")]
    return vs, {"a": jcore.TRUE, "b": jcore.TRUE}, (), 0


def _bcp_case_atmost_forces():
    vs = [sat.variable("a", sat.at_most(1, "b", "c")), sat.variable("b"),
          sat.variable("c")]
    return vs, {"b": jcore.TRUE}, (), 0


def _bcp_case_atmost_overflow():
    vs = [sat.variable("a", sat.at_most(1, "b", "c")), sat.variable("b"),
          sat.variable("c")]
    return vs, {"b": jcore.TRUE, "c": jcore.TRUE}, (), 0


def _bcp_case_min_bound(w):
    def case():
        vs = [sat.variable("a", sat.mandatory()), sat.variable("b")]
        return vs, {"b": jcore.TRUE}, ("b",), w
    return case


def _bcp_case_min_saturation():
    vs = [sat.variable("a", sat.mandatory()), sat.variable("b"),
          sat.variable("c")]
    return vs, {"b": jcore.TRUE}, ("b", "c"), 1


_BCP_CASES = {
    "unit_chain": _bcp_case_unit_chain,
    "conflict": _bcp_case_conflict,
    "atmost_forces": _bcp_case_atmost_forces,
    "atmost_overflow": _bcp_case_atmost_overflow,
    "min_bound_0": _bcp_case_min_bound(0),
    "min_bound_1": _bcp_case_min_bound(1),
    "min_saturation": _bcp_case_min_saturation,
}


def _jax_bcp(pts, b, t, f, min_bits, min_w, en=True):
    """pallas_bcp.bcp_fixpoint on lane ``b`` (interpret mode on the CPU),
    with full-space row activity derived from the entry state as
    core.planes_fixpoint does."""
    act_bits = jnp.asarray(pts.card_act_bits[b])
    card_active = ((act_bits & jnp.asarray(t)[None]) != 0).any(
        axis=1, keepdims=True)
    c, t2, f2 = pallas_bcp.bcp_fixpoint(
        jnp.asarray(pts.pos_bits[b]), jnp.asarray(pts.neg_bits[b]),
        jnp.asarray(pts.card_member_bits[b]), card_active,
        jnp.asarray(pts.card_n[b])[:, None], jnp.asarray(min_bits)[None],
        jnp.int32(min_w), jnp.asarray(t)[None], jnp.asarray(f)[None], en)
    return (bool(c), np.asarray(t2)[0], np.asarray(f2)[0],
            np.asarray(card_active)[:, 0].astype(np.int32))


def _port_bcp(pts, t, f, act, min_bits, min_w, en):
    def i32(x):
        return torch.as_tensor(np.array(x, dtype=np.int32))
    return cuda_bcp.bcp_fixpoint(
        i32(pts.pos_bits), i32(pts.neg_bits), i32(pts.card_member_bits),
        i32(act), i32(pts.card_n), i32(min_bits), i32(min_w), i32(t),
        i32(f), i32(en))


@pytest.mark.parametrize("case", sorted(_BCP_CASES))
def test_bcp_plain_matches_pallas_hand_built(case):
    vs, assume, min_ids, min_w = _BCP_CASES[case]()
    p = encode(vs)
    d = jdriver._Dims([p], 1)
    pts = jdriver.pad_stack([p], d, 1, pack=True)
    base = np.array(jcore._base_assignment(
        jcore.ProblemTensors(*[jnp.asarray(x[0]) for x in pts]), d.V,
        d.NCON))
    for ident, val in assume.items():
        base[p.id_to_index[ident]] = val
    mm = np.zeros(d.V, bool)
    for ident in min_ids:
        mm[p.id_to_index[ident]] = True
    t = np.asarray(jcore.pack_mask(jnp.asarray(base == jcore.TRUE), d.Wv))[0]
    f = np.asarray(jcore.pack_mask(jnp.asarray(base == jcore.FALSE), d.Wv))[0]
    mb = np.asarray(jcore.pack_mask(jnp.asarray(mm), d.Wv))[0]
    c, tw, fw, act = _jax_bcp(pts, 0, t, f, mb, min_w)
    got = _port_bcp(pts, t[None], f[None], act[None], mb[None], [min_w], [1])
    assert bool(got[0][0]) == c
    np.testing.assert_array_equal(got[1][0].numpy(), tw)
    np.testing.assert_array_equal(got[2][0].numpy(), fw)


@pytest.mark.parametrize("seed", range(3))
def test_bcp_plain_matches_pallas_random_batch(seed):
    """Random instances under random partial assignments, one padded
    batch for the port (one lane per instance) against per-lane Pallas
    calls; a disabled lane must run zero rounds."""
    rng = np.random.default_rng(7 + seed)
    problems = [encode(random_instance(length=24, seed=4 * seed + i))
                for i in range(4)]
    d = jdriver._Dims(problems, len(problems))
    pts = jdriver.pad_stack(problems, d, len(problems), pack=True)
    B = len(problems)
    ts, fs, acts, want = [], [], [], []
    for b, p in enumerate(problems):
        base = np.array(jcore._base_assignment(
            jcore.ProblemTensors(*[jnp.asarray(x[b]) for x in pts]), d.V,
            d.NCON))
        k = int(rng.integers(0, 4))
        for v in (rng.choice(p.n_vars, size=k, replace=False) if k else []):
            base[v] = rng.choice([jcore.TRUE, jcore.FALSE])
        t = np.asarray(jcore.pack_mask(jnp.asarray(base == jcore.TRUE),
                                       d.Wv))[0]
        f = np.asarray(jcore.pack_mask(jnp.asarray(base == jcore.FALSE),
                                       d.Wv))[0]
        en = b != B - 1
        c, tw, fw, act = _jax_bcp(pts, b, t, f, np.zeros(d.Wv, np.int32), 0,
                                  en)
        ts.append(t)
        fs.append(f)
        acts.append(act)
        want.append((c, tw, fw))
    en = [1] * (B - 1) + [0]
    got = _port_bcp(pts, np.stack(ts), np.stack(fs), np.stack(acts),
                    np.zeros((B, d.Wv), np.int32), [0] * B, en)
    for b, (c, tw, fw) in enumerate(want):
        assert bool(got[0][b]) == c, b
        np.testing.assert_array_equal(got[1][b].numpy(), tw)
        np.testing.assert_array_equal(got[2][b].numpy(), fw)
    np.testing.assert_array_equal(got[1][-1].numpy(), ts[-1])


@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("seed", range(2))
def test_round_and_fixpoint_plain_match_jax(seed, red):
    """core.round_planes / core.planes_fixpoint (the bits path, with its
    t-and-f entry check) against the JAX functions, one lane at a time,
    in both plane spaces; the last lane starts with a variable set both
    ways."""
    from deppy_tpu_torch.engine import core as tcore

    rng = np.random.default_rng(seed)
    problems = [encode(random_instance(length=20, seed=10 * seed + i))
                for i in range(3)]
    d, jpts, tpts, _ = _batch(problems)
    V = d.NV if red else d.V
    W = d.Wr if red else d.Wv
    for b, p in enumerate(problems):
        jp = jcore.ProblemTensors(*[x[b] for x in jpts])
        tp = tcore.lane(tpts, b)
        base = np.array(jcore._base_assignment_red(jp, d.NV) if red
                        else jcore._base_assignment(jp, d.V, d.NCON))
        for v in rng.choice(p.n_vars, size=3, replace=False):
            base[v] = rng.choice([jcore.TRUE, jcore.FALSE])
        t = np.array(jcore.pack_mask(jnp.asarray(base == jcore.TRUE), W))
        f = np.array(jcore.pack_mask(jnp.asarray(base == jcore.FALSE), W))
        if b == len(problems) - 1:
            t = t | f
        mb = np.array(jcore.pack_mask(jnp.asarray(
            np.arange(V) < min(p.n_vars, 4)), W))
        want = jcore.planes_fixpoint(jp, jnp.asarray(t), jnp.asarray(f),
                                     jnp.asarray(mb), jnp.int32(2),
                                     jnp.bool_(True), V, red)
        got = tcore.planes_fixpoint(tp, torch.as_tensor(t[0]),
                                    torch.as_tensor(f[0]),
                                    torch.as_tensor(mb[0]), 2, True, red)
        assert got[0] == bool(want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1])[0])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2])[0])
        if red:
            pos, neg, mem = jp.pos_bits_r, jp.neg_bits_r, jp.card_member_bits_r
            active = (jp.card_valid != 0)[:, None]
        else:
            pos, neg, mem = jp.pos_bits, jp.neg_bits, jp.card_member_bits
            active = ((jp.card_act_bits & jnp.asarray(t)) != 0).any(
                axis=1, keepdims=True)
        want = jcore.round_planes(pos, neg, mem, active, jp.card_n[:, None],
                                  jnp.asarray(mb), jnp.int32(2),
                                  jnp.asarray(t), jnp.asarray(f))
        got = tcore.round_planes(
            torch.as_tensor(np.array(pos)), torch.as_tensor(np.array(neg)),
            torch.as_tensor(np.array(mem)),
            torch.as_tensor(np.array(active)[:, 0]),
            torch.as_tensor(np.array(jp.card_n)), torch.as_tensor(mb[0]),
            2, torch.as_tensor(t[0]), torch.as_tensor(f[0]))
        assert (got[0], got[3]) == (bool(want[0]), bool(want[3]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1])[0])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2])[0])


# --------------------------------------------------------------------------
# kernel 3: phase 1


def _search_problems(kind):
    if kind == "random24":
        return [encode(random_instance(length=24, seed=s)) for s in range(4)]
    if kind == "random16_dense":
        return [encode(random_instance(length=16, seed=s, p_mandatory=0.5,
                                       p_conflict=0.5, n_conflict=4))
                for s in range(4)]
    if kind == "deep_chains":
        return [encode(version_pinned_chains(depth=6, width=3, seed=s))
                for s in range(3)]
    raise ValueError(kind)


def _xla_search(d, jpts, en, budget):
    return jcore.batched_search(d.V, d.NCON, d.NV, 0)(
        jpts, jnp.int32(budget), jnp.asarray(en))


@pytest.mark.parametrize("kind", ["random24", "random16_dense",
                                  "deep_chains"])
def test_search_plain_matches_xla(kind):
    problems = _search_problems(kind)
    d, jpts, tpts, en = _batch(problems)
    want = _xla_search(d, jpts, en, BUDGET)
    got = cuda_search.batched_search_fused(tpts, BUDGET,
                                           torch.as_tensor(en))
    _assert_equal(want, got)


@pytest.mark.parametrize("budget", [1, 3, 17])
def test_search_plain_budget_parity(budget):
    problems = _search_problems("random24")
    d, jpts, tpts, en = _batch(problems)
    want = _xla_search(d, jpts, en, budget)
    got = cuda_search.batched_search_fused(tpts, budget, torch.as_tensor(en))
    _assert_equal(want, got)


def test_search_plain_matches_pallas_interpret():
    problems = [encode(random_instance(length=16, seed=s)) for s in range(2)]
    d, jpts, tpts, en = _batch(problems)
    want = pallas_search.batched_search_fused(jpts, jnp.int32(BUDGET),
                                              jnp.asarray(en))
    got = cuda_search.batched_search_fused(tpts, BUDGET, torch.as_tensor(en))
    _assert_equal(want, got)


# --------------------------------------------------------------------------
# kernel 4: phase 2


def _minimize_inputs(kind, budget=BUDGET):
    problems = _search_problems(kind)
    d, jpts, tpts, en = _batch(problems)
    p1 = _xla_search(d, jpts, en, budget)
    result, guessed, model, steps = convert.phase_outputs_from_numpy(
        [p1[0], p1[1], p1[2], p1[3]])
    return d, jpts, tpts, en, p1, (result, model, guessed, steps)


@pytest.mark.parametrize("kind", ["random24", "random16_dense",
                                  "deep_chains"])
def test_minimize_plain_matches_xla(kind):
    d, jpts, tpts, en, p1, (result, model, guessed, steps) = \
        _minimize_inputs(kind)
    want = jcore.batched_minimize_gated(d.V, d.NCON, d.NV)(
        jpts, p1[0], p1[2], p1[1], jnp.int32(BUDGET), p1[3],
        jnp.asarray(en))
    got = cuda_search.batched_minimize_fused(
        tpts, result, model, guessed, BUDGET, steps, torch.as_tensor(en))
    _assert_equal(want, got)


@pytest.mark.parametrize("budget", [3, 17])
def test_minimize_plain_budget_parity(budget):
    d, jpts, tpts, en, p1, (result, model, guessed, steps) = \
        _minimize_inputs("random24", budget)
    want = jcore.batched_minimize_gated(d.V, d.NCON, d.NV)(
        jpts, p1[0], p1[2], p1[1], jnp.int32(budget), p1[3],
        jnp.asarray(en))
    got = cuda_search.batched_minimize_fused(
        tpts, result, model, guessed, budget, steps, torch.as_tensor(en))
    _assert_equal(want, got)


def test_minimize_plain_matches_pallas_interpret():
    d, jpts, tpts, en, p1, (result, model, guessed, steps) = \
        _minimize_inputs("random24")
    want = pallas_search.batched_minimize_fused(
        jpts, p1[0], p1[2], p1[1], jnp.int32(BUDGET), p1[3],
        jnp.asarray(en))
    got = cuda_search.batched_minimize_fused(
        tpts, result, model, guessed, BUDGET, steps, torch.as_tensor(en))
    _assert_equal(want, got)


# --------------------------------------------------------------------------
# kernel 5: phase 3


def _unsat_problems(n):
    out, seed = [], 0
    while len(out) < n and seed < 400:
        p = encode(random_instance(length=24, seed=seed, p_mandatory=0.3,
                                   p_conflict=0.3))
        try:
            HostEngine(p).solve()
        except NotSatisfiable:
            out.append(p)
        seed += 1
    assert len(out) == n
    return out


def _cardinality_unsat_problems():
    """UNSAT cores through AtMost rows, whose activity must follow each
    probe's activation bits (tests/test_pallas_search.py)."""
    chain = version_pinned_chains(depth=4, width=2, seed=1) + [
        sat.variable("pinA", sat.mandatory(), sat.dependency("l2.v0")),
        sat.variable("pinB", sat.mandatory(), sat.dependency("l2.v1")),
    ]
    return [encode([
        sat.variable("x", sat.mandatory()),
        sat.variable("y", sat.mandatory()),
        sat.variable("g", sat.at_most(1, "x", "y")),
    ]), encode([
        sat.variable("a", sat.mandatory()),
        sat.variable("b", sat.mandatory()),
        sat.variable("c", sat.mandatory()),
        sat.variable("cap", sat.at_most(2, "a", "b", "c")),
        sat.variable("d", sat.dependency("a")),
    ]), encode(chain)]


def _core_case(kind):
    if kind == "random_unsat":
        return _unsat_problems(4), BUDGET, 7
    if kind == "cardinality":
        return _cardinality_unsat_problems(), BUDGET, 0
    if kind == "starved_budget":
        return _unsat_problems(3), 25, 0
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random_unsat", "cardinality",
                                  "starved_budget"])
def test_core_plain_matches_xla(kind):
    problems, budget, steps0 = _core_case(kind)
    d, jpts, tpts, en = _batch(problems)
    steps = np.full(d.B, steps0, np.int32)
    want = jcore.batched_core(d.V, d.NCON, d.NV)(
        jpts, jnp.int32(budget), jnp.asarray(steps), jnp.asarray(en))
    got = cuda_search.batched_core_fused(
        tpts, budget, torch.as_tensor(steps), torch.as_tensor(en),
        NCON=d.NCON)
    _assert_equal(want, got)


def test_core_plain_gated_lanes():
    """Only UNSAT lanes run; the others keep an empty core and their
    carried steps (core.batched_core_gated)."""
    problems = _unsat_problems(2) + [encode(random_instance(length=16,
                                                            seed=3))]
    d, jpts, tpts, en = _batch(problems)
    steps = np.arange(d.B, dtype=np.int32)
    result = np.array([jcore.UNSAT, jcore.UNSAT, jcore.SAT]
                      + [jcore.RUNNING] * (d.B - 3), np.int32)
    want = jcore.batched_core_gated(d.V, d.NCON, d.NV)(
        jpts, jnp.asarray(result), jnp.int32(BUDGET), jnp.asarray(steps),
        jnp.asarray(en))
    gate = torch.as_tensor(en & (result == jcore.UNSAT))
    got = cuda_search.batched_core_fused(tpts, BUDGET,
                                         torch.as_tensor(steps), gate,
                                         NCON=d.NCON)
    _assert_equal(want, got)
    assert not got[0][2].any() and int(got[1][2]) == 2


def test_core_plain_matches_pallas_interpret():
    problems = _cardinality_unsat_problems()[:2]
    d, jpts, tpts, en = _batch(problems)
    steps = np.zeros(d.B, np.int32)
    want = pallas_search.batched_core_fused(
        jpts, jnp.int32(BUDGET), jnp.asarray(steps), jnp.asarray(en),
        V=d.V, NCON=d.NCON, NV=d.NV)
    got = cuda_search.batched_core_fused(
        tpts, BUDGET, torch.as_tensor(steps), torch.as_tensor(en),
        NCON=d.NCON)
    _assert_equal(want, got)


# --------------------------------------------------------------------------
# wrapper argument checks


def test_wrappers_reject_wrong_dtype_and_shape():
    problems = [encode(random_instance(length=12, seed=0))]
    d, _, tpts, en = _batch(problems)
    bad = tpts._replace(card_n=tpts.card_n.to(torch.int64))
    with pytest.raises(TypeError):
        cuda_search.batched_search_fused(bad, BUDGET, torch.as_tensor(en))
    with pytest.raises(ValueError):
        cuda_search.batched_search_fused(
            tpts, BUDGET, torch.as_tensor(np.concatenate([en, en])))
    with pytest.raises(ValueError):
        cuda_search.batched_core_fused(
            tpts, BUDGET, torch.zeros(d.B, dtype=torch.int32),
            torch.as_tensor(en), NCON=d.NCON * 64)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_three_phases_fuzz_deep(seed):
    """Fuzz depth (outside tier-1): phases 1-3 chained on mixed random
    batches, every lane against the JAX programs."""
    problems = [encode(random_instance(length=16 + 2 * seed,
                                       seed=100 * seed + i, p_mandatory=0.4,
                                       p_conflict=0.4))
                for i in range(8)]
    d, jpts, tpts, en = _batch(problems)
    p1 = _xla_search(d, jpts, en, BUDGET)
    got1 = cuda_search.batched_search_fused(tpts, BUDGET,
                                            torch.as_tensor(en))
    _assert_equal(p1, got1)
    result, guessed, model, steps = convert.phase_outputs_from_numpy(
        [p1[0], p1[1], p1[2], p1[3]])
    want2 = jcore.batched_minimize_gated(d.V, d.NCON, d.NV)(
        jpts, p1[0], p1[2], p1[1], jnp.int32(BUDGET), p1[3],
        jnp.asarray(en))
    got2 = cuda_search.batched_minimize_fused(
        tpts, result, model, guessed, BUDGET, steps, torch.as_tensor(en))
    _assert_equal(want2, got2)
    gate = np.asarray(en) & (np.asarray(p1[0]) == jcore.UNSAT)
    want3 = jcore.batched_core(d.V, d.NCON, d.NV)(
        jpts, jnp.int32(BUDGET), p1[3], jnp.asarray(gate))
    got3 = cuda_search.batched_core_fused(
        tpts, BUDGET, steps, torch.as_tensor(gate), NCON=d.NCON)
    _assert_equal(want3, got3)
