"""Kernel 1's two teams (``csrc/bcp.cu``) from the CPU.

The warp kernel (``bcp_warp_kernel``) and the block kernel run only on the
card (``chip_smoke.py`` holds both against the plain version and each
other there).  Here:

* the shape rule (``teams.team``, which ``cuda_bcp.bcp_fixpoint`` reads;
  ``cuda_search`` keeps its names, and setting ``cuda_search.WARPS`` sets
  ``teams.WARPS``) gives kernel 1 the warp team on every bits family of the main path
  (``pinned_tenant``, ``gvk_fleet``, ``chains``, ``operatorhub``, at
  their ``driver._Dims``), and the block team at the full-space widths of
  the giant catalog and the 64-catalog batch (Wv 768 and 192) and past
  the per-problem budget; a forced warp team on a refused shape raises in
  the wrapper;
* the per-problem shared memory (``warp_smem_bytes("bcp", ...)``, the
  Python copy of ``deppy_bcp_warp_smem_bytes``) against sizes counted by
  hand for three families;
* ``cuda_bcp.bcp_fixpoint`` on CPU tensors, under each ``_team``, against
  ``pallas_bcp.bcp_fixpoint`` (interpret mode) lane by lane, on seeded
  lanes of ``gvk_conflict_catalog(20, 4, 10)`` and
  ``pinned_tenant_catalog`` at phase 1's baseline (the anchors true, the
  padding false, the reduced planes) and on three hand-built lanes: a
  disabled one, one whose entry sets a variable both ways, one with a
  nonzero extras row and ``min_w`` 1;
* the zero extras row with ``min_w`` 0 that phase 1 passes forces nothing
  and adds no conflict: it gives the fixpoint of ``core.planes_fixpoint``
  under a bound that cannot bind.

Every output is an integer or a bool and must be equal (tolerance 0).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.engine import pallas_bcp
from deppy_tpu.models import gvk_conflict_catalog, pinned_tenant_catalog
from deppy_tpu.sat.encode import encode
from deppy_tpu_torch import models as tm
from deppy_tpu_torch.engine import cuda_bcp, cuda_search, teams
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.sat.encode import encode as tencode

TEAMS = [None, "block", "warp"]

# The main path's bits families, as chip_smoke.py resolves them.
_FAMILIES = {
    "pinned_tenant": lambda i: tm.pinned_tenant_catalog(seed=i),
    "gvk_fleet": lambda i: tm.gvk_conflict_catalog(20, 4, 10, seed=i),
    "chains": lambda i: tm.version_pinned_chains(20, 3, seed=i),
    "operatorhub": lambda i: tm.operatorhub_catalog(40, 5, seed=i),
}


@pytest.fixture
def warps():
    """Restores ``cuda_search.WARPS`` (``teams.WARPS``) after a test that
    sets it."""
    default = cuda_search.WARPS
    yield
    cuda_search.WARPS = default


def _dims(family: str, n: int = 4) -> tdriver._Dims:
    probs = [tencode(_FAMILIES[family](i)) for i in range(n)]
    return tdriver._Dims(probs, len(probs))


def _plan(C: int, NA: int, W: int, forced=None):
    return cuda_search._plan("bcp", 0, C, NA, W, 0, 0, forced)


# --------------------------------------------------------------------------
# the shape rule


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_bits_launches_take_the_warp_team(family):
    d = _dims(family, 1 if family == "operatorhub" else 4)
    assert _plan(d.C, d.NA, d.Wr) == ("warp", False)


@pytest.mark.parametrize("dims,Wv", [((1000, 8), 768), ((250, 8), 192)],
                         ids=["giant", "operatorhub_batch"])
def test_full_space_of_big_catalogs_takes_the_block_team(dims, Wv):
    """chip_smoke.py's blockwise comparison runs kernel 1 on these
    catalogs' full-space planes: the block kernel serves them."""
    d = tdriver._Dims([tencode(tm.operatorhub_catalog(*dims, seed=0))], 1)
    assert d.Wv == Wv
    assert _plan(d.C, d.NA, d.Wv) == ("block", False)
    with pytest.raises(ValueError, match="warp team does not take"):
        _plan(d.C, d.NA, d.Wv, "warp")


def test_block_team_past_the_budget(warps):
    """Planes of 8 words over 2,048 clause rows: a 131,120-byte slice,
    past a quarter of a block's shared memory but within all of it."""
    lean = cuda_search.warp_smem_bytes("bcp", 2048, 1, 8, 0, 0, False)
    assert lean == -(-4 * ((2 * 2048 + 1) * 8 + 3) // 16) * 16
    cuda_search.WARPS = 4
    assert teams.WARPS == 4
    assert lean > cuda_search.problem_budget()
    assert _plan(2048, 1, 8) == ("block", False)
    cuda_search.WARPS = 1
    assert teams.WARPS == cuda_search.WARPS == 1
    assert _plan(2048, 1, 8) == ("warp", False)
    assert _plan(4, 1, 33)[0] == "block"


# Hand counts in 4-byte words: the pos and neg planes (C rows of W words
# each), the AtMost planes (NA rows), card_n, the activity source and the
# row activity (NA each), at the reduced width Wr; no snapshots.  Bytes
# round up to 16.
@pytest.mark.parametrize("family,words", [
    ("pinned_tenant", (2 * 64 + 1) * 2 + 3 * 1),  # C 64, NA 1, Wr 2
    ("gvk_fleet", (2 * 256 + 1) * 4 + 3 * 1),     # C 256, NA 1, Wr 4
    ("chains", (2 * 64 + 32) * 4 + 3 * 32),       # C 64, NA 32, Wr 4
])
def test_warp_smem_bytes_by_hand(family, words):
    d = _dims(family)
    got = cuda_search.warp_smem_bytes("bcp", d.C, d.NA, d.Wr, d.NV, 0, False)
    assert got == -(-4 * words // 16) * 16
    with pytest.raises(ValueError, match="no DPLL snapshots"):
        cuda_search.warp_smem_bytes("bcp", d.C, d.NA, d.Wr, d.NV, 0, True)


def test_forced_warp_team_raises_in_the_wrapper():
    """A forced warp team on planes of 33 words raises before anything
    runs; a forced block team runs."""
    B, C, NA, W = 2, 4, 1, 33

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    args = (z(B, C, W), z(B, C, W), z(B, NA, W), z(B, NA), z(B, NA),
            z(B, W), z(B), z(B, W), z(B, W), torch.ones(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="warp team does not take"):
        cuda_bcp.bcp_fixpoint(*args, _team="warp")
    with pytest.raises(ValueError, match="unknown team"):
        cuda_bcp.bcp_fixpoint(*args, _team="grid")
    conflict, t, f = cuda_bcp.bcp_fixpoint(*args, _team="block")
    assert conflict.tolist() == [0, 0] and t.shape == f.shape == (B, W)


# --------------------------------------------------------------------------
# the function against the JAX package


_JAX_FAMILIES = {
    "pinned_tenant": lambda s: pinned_tenant_catalog(seed=s),
    "gvk_fleet": lambda s: gvk_conflict_catalog(20, 4, 10, seed=s),
}
SEEDED = 3


def _inputs(family):
    """(JAX ProblemTensors per lane, the kernel's numpy inputs) of
    ``SEEDED`` lanes from numpy-drawn seeds at phase 1's baseline, then
    three hand-built lanes on copies of them: lane 0 disabled, lane 1
    with its first anchor also set false, lane 2 with the extras row
    "at most one of the first anchor and the variables that are no
    anchor" (``min_w`` 1), which the true anchor saturates, so that the
    first round forces every other extra false."""
    seeds = np.random.default_rng(5).permutation(1000)[:SEEDED]
    probs = [encode(_JAX_FAMILIES[family](int(s))) for s in seeds]
    probs = probs + probs
    d = jdriver._Dims(probs, len(probs))
    pts = jdriver.pad_stack(probs, d, len(probs), pack=True)
    B, W = len(probs), d.Wr
    pv = np.arange(d.NV) < pts.n_vars[:, None]
    anchor = np.zeros((B, d.NV), bool)
    for b, a in zip(*np.nonzero(pts.anchors >= 0)):
        anchor[b, pts.anchors[b, a]] = True

    def pack(mask):
        return np.concatenate([np.asarray(jcore.pack_mask(jnp.asarray(m), W))
                               for m in np.atleast_2d(mask)])

    t0, f0 = pack(anchor), pack(~pv)
    min_bits = np.zeros((B, W), np.int32)
    min_w = np.zeros(B, np.int32)
    en = np.ones(B, np.int32)
    en[SEEDED] = 0
    first = np.argmax(anchor[SEEDED + 1])
    assert anchor[SEEDED + 1, first]
    f0[SEEDED + 1, first // 32] |= np.int32(
        np.uint32(1 << (first % 32)).view(np.int32))
    extras = pv[SEEDED + 2] & ~anchor[SEEDED + 2]
    extras[np.argmax(anchor[SEEDED + 2])] = True
    min_bits[SEEDED + 2] = pack(extras)
    min_w[SEEDED + 2] = 1
    assert (min_bits[SEEDED + 2] != 0).any()
    lanes = [jcore.ProblemTensors(*[jnp.asarray(x[b]) for x in pts])
             for b in range(B)]
    kin = (pts.pos_bits_r, pts.neg_bits_r, pts.card_member_bits_r,
           pts.card_valid, pts.card_n, min_bits, min_w, t0, f0, en)
    return d, lanes, [np.ascontiguousarray(x, dtype=np.int32) for x in kin]


@pytest.fixture(scope="module")
def cases():
    """Per family: the inputs and ``pallas_bcp.bcp_fixpoint``'s outputs,
    lane by lane, in interpret mode (one JAX run for every team)."""
    out = {}
    for family in sorted(_JAX_FAMILIES):
        d, lanes, kin = _inputs(family)
        pos, neg, mem, act, card_n, min_bits, min_w, t0, f0, en = kin
        want = []
        for b, jp in enumerate(lanes):
            c, t, f = pallas_bcp.bcp_fixpoint(
                jp.pos_bits_r, jp.neg_bits_r, jp.card_member_bits_r,
                (jp.card_valid != 0)[:, None], jp.card_n[:, None],
                jnp.asarray(min_bits[b])[None], jnp.int32(min_w[b]),
                jnp.asarray(t0[b])[None], jnp.asarray(f0[b])[None],
                bool(en[b]))
            want.append((int(c), np.asarray(t)[0], np.asarray(f)[0]))
        out[family] = (d, lanes, kin, want)
    return out


def _port(kin, team):
    return cuda_bcp.bcp_fixpoint(*[torch.from_numpy(x) for x in kin],
                                 _team=team)


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("family", sorted(_JAX_FAMILIES))
def test_bcp_fixpoint_matches_pallas(cases, family, team):
    d, _, kin, want = cases[family]
    got = _port(kin, team)
    for b, (c, t, f) in enumerate(want):
        assert int(got[0][b]) == c, b
        np.testing.assert_array_equal(got[1][b].numpy(), t, err_msg=str(b))
        np.testing.assert_array_equal(got[2][b].numpy(), f, err_msg=str(b))
    # The disabled lane returns its entry state; the hand-built lanes
    # differ from the seeded lanes they copy.
    t0, f0 = kin[7], kin[8]
    assert int(got[0][SEEDED]) == 0
    np.testing.assert_array_equal(got[1][SEEDED].numpy(), t0[SEEDED])
    np.testing.assert_array_equal(got[2][SEEDED].numpy(), f0[SEEDED])
    for b in (1, 2):
        assert (want[b][0] != want[SEEDED + b][0]
                or (want[b][1] != want[SEEDED + b][1]).any()
                or (want[b][2] != want[SEEDED + b][2]).any()), b


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("family", sorted(_JAX_FAMILIES))
def test_zero_extras_row_is_unbounded(cases, family, team):
    """On the seeded lanes (enabled, no variable set both ways) the zero
    extras row with ``min_w`` 0 gives what ``core.planes_fixpoint`` gives
    under an extras row of every variable and a ``min_w`` past the
    variables' count, which can neither force nor conflict."""
    d, lanes, kin, _ = cases[family]
    got = _port(kin, team)
    W = d.Wr
    t0, f0 = kin[7], kin[8]
    for b in range(SEEDED):
        c, t, f = jcore.planes_fixpoint(
            lanes[b], jnp.asarray(t0[b])[None], jnp.asarray(f0[b])[None],
            jnp.full((1, W), -1, jnp.int32), jnp.int32(32 * W + 1),
            jnp.bool_(True), d.NV, True)
        assert int(got[0][b]) == int(c), b
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(t)[0])
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(f)[0])
