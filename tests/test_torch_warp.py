"""The warp team of kernels 4 and 5 (``csrc/warp.cuh``) from the CPU.

The warp kernels run only on the card (``chip_smoke.py`` holds them
against the plain versions and the block kernels there).  Here:

* the shape rule ``cuda_search.team``: the warp team for every bits-path
  launch of the main path's families (``pinned_tenant``, ``gvk_fleet``,
  ``chains``, ``operatorhub``), the block team for every blockwise launch
  and for planes past 32 words; a forced warp team on a shape the rule
  refuses raises, in the wrappers too;
* the per-problem shared-memory arithmetic (``warp_smem_bytes``, the
  Python copy of ``deppy_{core,minimize}_warp_smem_bytes``) against sizes
  counted by hand for three families;
* phases 2 and 3's plain versions (``core.minimize_phase`` and
  ``core.core_phase``, through the wrappers under each ``_team``) against
  the JAX package's ``batched_minimize_gated`` and ``batched_core`` on
  lanes of ``pinned_tenant_catalog`` and ``gvk_conflict_catalog(20, 4,
  10)``, the families the kernels are timed on.  Every output is an
  integer or a bool and must be equal (tolerance 0): installed sets,
  found flags, cores, step counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import gvk_conflict_catalog, pinned_tenant_catalog
from deppy_tpu.sat.encode import encode
from deppy_tpu.sat.errors import NotSatisfiable
from deppy_tpu.sat.host import HostEngine
from deppy_tpu_torch import models as tm
from deppy_tpu_torch.engine import convert, cuda_blockwise, cuda_search
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.sat.encode import encode as tencode

BUDGET = 1 << 20

# The main path's bits families, as chip_smoke.py resolves them.
_FAMILIES = {
    "pinned_tenant": lambda i: tm.pinned_tenant_catalog(seed=i),
    "gvk_fleet": lambda i: tm.gvk_conflict_catalog(20, 4, 10, seed=i),
    "chains": lambda i: tm.version_pinned_chains(20, 3, seed=i),
    "operatorhub": lambda i: tm.operatorhub_catalog(40, 5, seed=i),
}


@pytest.fixture
def warps():
    """Restores ``cuda_search.WARPS`` after a test that sets it."""
    default = cuda_search.WARPS
    yield
    cuda_search.WARPS = default


def _dims(family: str, n: int = 4) -> tdriver._Dims:
    probs = [tencode(_FAMILIES[family](i)) for i in range(n)]
    return tdriver._Dims(probs, len(probs))


def _plans(d: tdriver._Dims, tile: int = 0):
    """(minimize plan, core plan) of a launch at the dims ``d``: phase 2
    in the reduced space, phase 3 in the full one."""
    return (cuda_search._plan("minimize", tile, d.C, d.NA, d.Wr, d.NV, 0,
                              None),
            cuda_search._plan("core", tile, d.C, d.NA, d.Wv, d.NV, d.NCON,
                              None))


# --------------------------------------------------------------------------
# the shape rule


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_bits_launches_take_the_warp_team(family):
    d = _dims(family, 1 if family == "operatorhub" else 4)
    (m_team, m_snaps), (c_team, _) = _plans(d)
    assert (m_team, c_team) == ("warp", "warp")
    # Phase 2's snapshots fit every family's slice beside its planes.
    assert m_snaps


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_blockwise_launches_take_the_block_team(family):
    d = _dims(family, 1 if family == "operatorhub" else 4)
    tile = cuda_blockwise.tile_rows(cuda_blockwise.BLOCK_ROWS, d.C, d.K,
                                    d.M, d.Wv, d.NA)
    assert tile > 0
    assert [p[0] for p in _plans(d, tile)] == ["block", "block"]
    with pytest.raises(ValueError, match="warp team does not take"):
        cuda_search._plan("core", tile, d.C, d.NA, d.Wv, d.NV, d.NCON,
                          "warp")


def test_rule_bounds_words_and_budget(warps):
    assert cuda_search.team(0, 32, 1024) == "warp"
    assert cuda_search.team(0, 33, 1024) == "block"
    assert cuda_search.team(1, 4, 1024) == "block"
    cuda_search.WARPS = 4
    budget = cuda_search.problem_budget()
    assert budget == cuda_blockwise.SMEM_BYTES // 4 // 16 * 16
    assert cuda_search.team(0, 8, budget) == "warp"
    assert cuda_search.team(0, 8, budget + 16) == "block"
    # The block team takes any shape; an unknown team is refused.
    assert cuda_search._plan("core", 0, 64, 1, 40, 64, 64, "block") == (
        "block", False)
    with pytest.raises(ValueError, match="warp team does not take"):
        cuda_search._plan("core", 0, 64, 1, 40, 64, 64, "warp")
    with pytest.raises(ValueError, match="unknown team"):
        cuda_search._plan("core", 0, 64, 1, 4, 64, 64, "grid")


def test_snapshots_leave_the_slice_when_they_do_not_fit(warps):
    """gvk_fleet's core slice: 25,664 bytes without the snapshots and
    39,072 with them.  At 8 warps a block (29,056 bytes a problem) the
    planes still fit and the snapshots go to global scratch; at 4 both
    fit."""
    d = _dims("gvk_fleet")
    cuda_search.WARPS = 4
    assert _plans(d)[1] == ("warp", True)
    cuda_search.WARPS = 8
    assert _plans(d)[1] == ("warp", False)


def test_forced_warp_team_raises_in_the_wrappers():
    """A forced warp team on a blockwise launch raises before anything
    runs, on any device; a forced block team runs."""
    probs = [encode(pinned_tenant_catalog(seed=s)) for s in range(2)]
    d, _, tpts, en = _batch(probs)
    steps = torch.zeros(d.B, dtype=torch.int32)
    kw = dict(NCON=d.NCON, impl="blockwise", block_rows=8)
    with pytest.raises(ValueError, match="warp team does not take"):
        cuda_search.batched_core_fused(tpts, BUDGET, steps,
                                       torch.as_tensor(en), _team="warp",
                                       **kw)
    result = torch.full((d.B,), jcore.SAT, dtype=torch.int32)
    model = torch.zeros((d.B, d.NV), dtype=torch.int32)
    guessed = torch.zeros((d.B, d.NV), dtype=torch.bool)
    with pytest.raises(ValueError, match="warp team does not take"):
        cuda_search.batched_minimize_fused(
            tpts, result, model, guessed, BUDGET, steps,
            torch.as_tensor(en), _team="warp", **kw)
    core, _ = cuda_search.batched_core_fused(
        tpts, 1, steps, torch.as_tensor(en), _team="block", **kw)
    assert core.shape == (d.B, d.NCON)


# --------------------------------------------------------------------------
# the per-problem shared memory


# Hand counts in 4-byte words: the pos and neg planes (C rows of W words
# each), the AtMost planes (NA rows), card_n, the activity source and the
# row activity (NA each); the core adds ``active`` (NCON); the snapshots
# add (NV + 1) levels of t and f (W each) and the NV-entry decision and
# false-phase stacks.  Bytes round up to 16.
@pytest.mark.parametrize("family,kernel,want", [
    # C 64, NA 1, NV 64, NCON 64; reduced W 2, full W 4.
    ("pinned_tenant", "minimize",
     ((2 * 64 + 1) * 2 + 3 * 1, 2 * 65 * 2 + 2 * 64)),
    ("pinned_tenant", "core",
     ((2 * 64 + 1) * 4 + 3 * 1 + 64, 2 * 65 * 4 + 2 * 64)),
    # C 256, NA 1, NV 128, NCON 256; reduced W 4, full W 12.
    ("gvk_fleet", "minimize",
     ((2 * 256 + 1) * 4 + 3 * 1, 2 * 129 * 4 + 2 * 128)),
    ("gvk_fleet", "core",
     ((2 * 256 + 1) * 12 + 3 * 1 + 256, 2 * 129 * 12 + 2 * 128)),
    # C 64, NA 32, NV 128, NCON 128; reduced W 4, full W 8.
    ("chains", "minimize",
     ((2 * 64 + 32) * 4 + 3 * 32, 2 * 129 * 4 + 2 * 128)),
    ("chains", "core",
     ((2 * 64 + 32) * 8 + 3 * 32 + 128, 2 * 129 * 8 + 2 * 128)),
])
def test_warp_smem_bytes_by_hand(family, kernel, want):
    d = _dims(family)
    W = d.Wr if kernel == "minimize" else d.Wv
    lean, snaps = want
    got = [cuda_search.warp_smem_bytes(kernel, d.C, d.NA, W, d.NV, d.NCON,
                                       s) for s in (False, True)]
    assert got == [-(-4 * lean // 16) * 16, -(-4 * (lean + snaps) // 16) * 16]
    assert cuda_search.warp_smem_bytes(kernel, d.C, d.NA, W, d.NV, d.NCON,
                                       False) % 16 == 0


def test_warp_smem_bytes_rejects_other_kernels():
    with pytest.raises(ValueError):
        cuda_search.warp_smem_bytes("search", 64, 1, 4, 64, 64, False)


# --------------------------------------------------------------------------
# phases 2 and 3's plain versions against the JAX package


def _batch(problems):
    d = jdriver._Dims(problems, len(problems))
    pts = jdriver.pad_stack(problems, d, d.B, pack=True)
    en = np.arange(d.B) < len(problems)
    jpts = jcore.ProblemTensors(*[jnp.asarray(x) for x in pts])
    return d, jpts, convert.problem_tensors_from_numpy(pts), en


_JAX_FAMILIES = {
    "pinned_tenant": lambda s: pinned_tenant_catalog(seed=s),
    "gvk_fleet": lambda s: gvk_conflict_catalog(20, 4, 10, seed=s),
}


def _lanes(family):
    """Three lanes of ``family`` from numpy-drawn seeds: the first two
    UNSAT and the first SAT ones for ``pinned_tenant`` (mostly UNSAT), the
    first three for ``gvk_fleet`` (all SAT)."""
    seeds = np.random.default_rng(4).permutation(1000)
    if family == "gvk_fleet":
        return [encode(_JAX_FAMILIES[family](int(s))) for s in seeds[:3]]
    unsat, sat = [], []
    for s in seeds:
        p = encode(_JAX_FAMILIES[family](int(s)))
        try:
            HostEngine(p).solve()
            sat.append(p)
        except NotSatisfiable:
            unsat.append(p)
        if len(unsat) >= 2 and sat:
            return unsat[:2] + sat[:1]
    raise AssertionError("no mix of SAT and UNSAT lanes")


def _phase1(family):
    """The lanes of ``family`` padded to four, and the JAX phase 1's
    outputs on them."""
    d, jpts, tpts, en = _batch(_lanes(family))
    p1 = jcore.batched_search(d.V, d.NCON, d.NV, 0)(
        jpts, jnp.int32(BUDGET), jnp.asarray(en))
    return d, jpts, tpts, en, p1


def _assert_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(convert.to_numpy(b), np.asarray(a),
                                      err_msg=f"output {i}")


@pytest.mark.parametrize("team", [None, "block", "warp"])
@pytest.mark.parametrize("anchors_only", [False, True],
                         ids=["guessed", "anchors"])
@pytest.mark.parametrize("family", sorted(_JAX_FAMILIES))
def test_minimize_phase_matches_jax(family, anchors_only, team):
    """Phase 2 on the lanes' phase-1 outputs; with ``anchors_only`` the
    guessed set is cut to the anchors, so every other installed variable
    is an extra and the binary search's DPLL probes run."""
    d, jpts, tpts, en, p1 = _phase1(family)
    guessed = np.array(p1[1])
    if anchors_only:
        anchors = np.asarray(jpts.anchors)
        mask = np.zeros_like(guessed)
        for b, a in zip(*np.nonzero(anchors >= 0)):
            mask[b, anchors[b, a]] = True
        guessed = guessed & mask
    want = jcore.batched_minimize_gated(d.V, d.NCON, d.NV)(
        jpts, p1[0], p1[2], jnp.asarray(guessed), jnp.int32(BUDGET), p1[3],
        jnp.asarray(en))
    result, _, model, steps = convert.phase_outputs_from_numpy(
        [p1[0], p1[1], p1[2], p1[3]])
    got = cuda_search.batched_minimize_fused(
        tpts, result, model, torch.as_tensor(guessed), BUDGET, steps,
        torch.as_tensor(en), _team=team)
    _assert_equal(want, got)
    extras = (np.asarray(p1[2]) == jcore.TRUE) & ~guessed
    assert extras[np.asarray(p1[0]) == jcore.SAT].any() == anchors_only


@pytest.mark.parametrize("team", [None, "block", "warp"])
@pytest.mark.parametrize("family,budget", [
    ("pinned_tenant", BUDGET), ("pinned_tenant", 25), ("gvk_fleet", 90),
    ("gvk_fleet", 160)])
def test_core_phase_matches_jax(family, budget, team):
    """Phase 3 on every enabled lane (the SAT ones included: each of
    their probes is a full DPLL), from the lanes' phase-1 step counts.
    ``pinned_tenant`` runs to the end and is stopped part way at budget
    25; ``gvk_fleet``'s SAT lanes (some 70 phase-1 steps each) run 20-90
    decisions of probes before their budget stops them."""
    d, jpts, tpts, en, p1 = _phase1(family)
    want = jcore.batched_core(d.V, d.NCON, d.NV)(
        jpts, jnp.int32(budget), p1[3], jnp.asarray(en))
    got = cuda_search.batched_core_fused(
        tpts, budget, torch.as_tensor(np.array(p1[3])),
        torch.as_tensor(en), NCON=d.NCON, _team=team)
    _assert_equal(want, got)
