"""The port's bitplane primitives, plane derivation and padding against the
JAX package, on the CPU.

Everything compared is an integer or a bool, so every comparison is exact
(tolerance 0).  Inputs come from seeds through the port's own workload
generators and encoder; the JAX side gets the same problems through its
encoder, and both sides receive the same padded numpy arrays.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import (gvk_conflict_catalog, pinned_tenant_catalog,
                              random_instance, version_pinned_chains)
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch.engine import convert
from deppy_tpu_torch.engine import core as tcore
from deppy_tpu_torch.engine import driver as tdriver
from deppy_tpu_torch.models import gvk_conflict_catalog as t_gvk
from deppy_tpu_torch.models import pinned_tenant_catalog as t_pinned
from deppy_tpu_torch.models import random_instance as t_random
from deppy_tpu_torch.models import version_pinned_chains as t_chains
from deppy_tpu_torch.sat.encode import encode as tencode


def _words(seed: int, shape) -> np.ndarray:
    """Random int32 words with bit 31 set in about half of them."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    w[..., 0] |= np.uint64(1 << 31)
    return w.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_popcount32_matches_jax(seed):
    w = _words(seed, (4, 9))
    got = tcore.popcount32(torch.from_numpy(w)).numpy()
    want = np.asarray(jcore.popcount32(jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("shift", [0, 1, 5, 31])
def test_srl_is_logical(shift):
    w = _words(shift, (3, 7))
    got = tcore._srl(torch.from_numpy(w), shift).numpy()
    want = np.asarray(jcore._srl(jnp.asarray(w), shift))
    np.testing.assert_array_equal(got, want)
    # The sign bit shifts in as zero: no negative result past a shift.
    if shift:
        assert (got >= 0).all()


@pytest.mark.parametrize("V,W", [(1, 1), (31, 1), (32, 1), (33, 2), (95, 3),
                                 (128, 4)])
def test_pack_unpack_match_jax(V, W):
    rng = np.random.default_rng(V)
    mask = rng.random(V) < 0.5
    mask[-1] = True  # the last variable: bit 31 when V is a multiple of 32
    got = tcore.pack_mask(torch.from_numpy(mask), W).numpy()
    want = np.asarray(jcore.pack_mask(jnp.asarray(mask), W))[0]
    np.testing.assert_array_equal(got, want)
    back = tcore.unpack_mask(torch.from_numpy(got), V).numpy()
    np.testing.assert_array_equal(back, mask)
    np.testing.assert_array_equal(
        back, np.asarray(jcore.unpack_mask(jnp.asarray(want)[None], V)))


def test_pack_mask_bit31_is_the_sign_bit():
    mask = np.zeros(64, bool)
    mask[31] = mask[63] = True
    got = tcore.pack_mask(torch.from_numpy(mask), 2).numpy()
    assert got.tolist() == [-(1 << 31), -(1 << 31)]


def _mixed_pair(n_each: int = 2):
    """The same seeded problems through both encoders."""
    gens = [
        (lambda s: gvk_conflict_catalog(6, 3, 3, seed=s),
         lambda s: t_gvk(6, 3, 3, seed=s)),
        (lambda s: pinned_tenant_catalog(seed=s),
         lambda s: t_pinned(seed=s)),
        (lambda s: version_pinned_chains(4, 3, seed=s),
         lambda s: t_chains(4, 3, seed=s)),
        (lambda s: random_instance(length=16, seed=s, p_mandatory=0.4,
                                   p_conflict=0.4),
         lambda s: t_random(length=16, seed=s, p_mandatory=0.4,
                            p_conflict=0.4)),
    ]
    jp, tp = [], []
    for jg, tg in gens:
        for s in range(n_each):
            jp.append(jencode(jg(s)))
            tp.append(tencode(tg(s)))
    return jp, tp


_COMPACT = ("clauses", "card_ids", "card_n", "card_act", "anchors",
            "choice_cand", "var_choices", "n_vars", "n_cons", "card_valid")
_DIMS = ("C", "K", "NA", "M", "A", "NC", "Kc", "NV", "W", "NCON", "V", "Wv",
         "Wr", "B")


def test_encoders_agree():
    jp, tp = _mixed_pair()
    for a, b in zip(jp, tp):
        for f in ("clauses", "card_ids", "card_n", "card_act", "anchors",
                  "choice_cand", "var_choices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_vars, a.n_cons) == (b.n_vars, b.n_cons)


@pytest.mark.parametrize("batch,multiple", [(1, 1), (8, 1), (5, 3)])
def test_dims_match_jax(batch, multiple):
    jp, tp = _mixed_pair()
    jd = jdriver._Dims(jp, batch, batch_multiple=multiple)
    td = tdriver._Dims(tp, batch, batch_multiple=multiple)
    for name in _DIMS:
        assert getattr(td, name) == getattr(jd, name), name


@pytest.mark.parametrize("field", _COMPACT)
def test_pad_stack_field_matches_jax(field):
    jp, tp = _mixed_pair()
    jd = jdriver._Dims(jp, len(jp))
    td = tdriver._Dims(tp, len(tp))
    total = jd.B + 2  # trailing empty lanes
    want = getattr(jdriver.pad_stack(jp, jd, total, pack=False), field)
    got = getattr(tdriver.pad_stack(tp, td, total), field)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.int32


def test_partition_buckets_matches_jax():
    # A heterogeneous fleet large enough to be partitioned: two size
    # classes and a cost jump inside one of them.
    jp, tp = [], []
    for s in range(20):
        jp.append(jencode(random_instance(length=12, seed=s)))
        tp.append(tencode(t_random(length=12, seed=s)))
        jp.append(jencode(version_pinned_chains(6, 3, seed=s)))
        tp.append(tencode(t_chains(6, 3, seed=s)))
    for s in range(4):
        jp.append(jencode(gvk_conflict_catalog(20, 4, 10, seed=s)))
        tp.append(tencode(t_gvk(20, 4, 10, seed=s)))
    want = jdriver.partition_buckets(jp)
    assert len(want) > 1
    assert tdriver.partition_buckets(tp) == want


_PLANES = ("pos_bits", "neg_bits", "card_member_bits", "card_act_bits",
           "pos_bits_r", "neg_bits_r", "card_member_bits_r")


@pytest.mark.parametrize("plane", _PLANES)
def test_derive_planes_matches_jax_packing(plane):
    """Device-side derivation against the JAX driver's host packing
    (``pad_stack(..., pack=True)``), full and reduced spaces."""
    jp, _ = _mixed_pair()
    d = jdriver._Dims(jp, len(jp))
    packed = jdriver.pad_stack(jp, d, d.B, pack=True)
    compact = convert.problem_tensors_from_numpy(
        jdriver.pad_stack(jp, d, d.B, pack=False))
    derived = tcore.with_planes(compact, Wv=d.Wv, Wr=d.Wr, red=True,
                                full=True)
    np.testing.assert_array_equal(getattr(derived, plane).numpy(),
                                  getattr(packed, plane))


def test_derive_planes_placeholders():
    jp, _ = _mixed_pair(1)
    d = jdriver._Dims(jp, len(jp))
    compact = convert.problem_tensors_from_numpy(
        jdriver.pad_stack(jp, d, d.B, pack=False))
    pos, neg, mem, act, pos_r, neg_r, mem_r = tcore.derive_planes(
        compact.clauses, compact.card_ids, compact.card_act, compact.n_vars,
        Wv=d.Wv, Wr=d.Wr, red=True, full=False)
    assert pos.shape == (d.B, d.C, 1) and not pos.any()
    assert act.shape == (d.B, d.NA, 1) and not act.any()
    assert pos_r.shape == (d.B, d.C, d.Wr)


def test_problem_tensors_from_numpy_ignores_clause_bank_fields():
    jp, _ = _mixed_pair(1)
    d = jdriver._Dims(jp, len(jp))
    pts = convert.problem_tensors_from_numpy(
        jdriver.pad_stack(jp, d, d.B, pack=True))
    assert pts._fields == tcore.ProblemTensors._fields
    assert all(x.dtype == torch.int32 for x in pts)
