"""The clause path's fixpoint a card (``cuda_shard.CardShards``,
``core.ClauseShards.fixpoint``) against the JAX package's rounds under
``clause_axis``, bit for bit (tolerance 0).

``tests/conftest.py`` gives the reference 8 virtual CPU devices; the
port's counterpart is a clause mesh that names the CPU device more than
once, whose shards run the kernels' plain versions.

  * the mode a ``ClauseShards`` takes from its slots' devices and group,
    decided from fake devices: one device and no group the fixpoint
    kernel, devices or ranks one round kernel a card (a CPU card runs
    the plain versions either way); the slots grouped one ``CardShards``
    a device;
  * the per-card fold (``card_round_plain`` over 1-4 shards of one
    device) and the replicated tail equal the reference's
    ``round_planes`` under ``clause_axis`` over as many devices;
  * ``ClauseShards.fixpoint`` over 8 CPU slots equals the reference's
    ``planes_fixpoint`` under ``clause_axis`` on 8 devices: the same
    (conflict, t, f) and the same round count, from seeded mid-search
    states in both plane spaces, in both modes and at every slot count,
    past 16 slots too;
  * the counters: a sharded solve counts its fixpoints and their rounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from deppy_tpu.engine import core as jcore
from deppy_tpu.engine import driver as jdriver
from deppy_tpu.models import operatorhub_catalog as jcatalog
from deppy_tpu.parallel import clause_shard as jclause
from deppy_tpu.parallel._compat import shard_map
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch.engine import core, cuda_shard, driver
from deppy_tpu_torch.models import operatorhub_catalog
from deppy_tpu_torch.parallel import clause_mesh, clause_shard, solve_sharded
from deppy_tpu_torch.sat.encode import encode

CPU = torch.device("cpu")
CUDA0 = torch.device("cuda", 0)
CUDA1 = torch.device("cuda", 1)


@pytest.fixture(autouse=True)
def bits_impl(monkeypatch):
    monkeypatch.setattr(jcore, "_BCP_IMPL", "bits")
    monkeypatch.setattr(core, "_BCP_IMPL", "bits")


# -- the mode, from the slots' devices ----------------------------------------

GROUP = object()


@pytest.mark.parametrize("devices,group,mode", [
    ([CUDA0], None, "fixpoint"),
    ([CUDA0] * 4, None, "fixpoint"),
    ([CUDA0, CUDA1], None, "rounds"),
    ([CUDA0, CUDA0, CUDA1, CUDA1], None, "rounds"),
    ([CUDA0] * 2, GROUP, "rounds"),
    ([CPU, CUDA0], None, "rounds"),
    ([CPU], None, "fixpoint"),
    ([CPU] * 4, None, "fixpoint"),
    ([CPU] * 2, GROUP, "rounds"),
], ids=["one-card", "one-card-4", "two-cards", "two-cards-4", "group",
        "cpu-and-card", "cpu", "cpu-4", "cpu-group"])
def test_shard_mode(devices, group, mode):
    assert core.shard_mode(devices, group) == mode


class _FakeCard:
    def __init__(self, shards, W):
        self.shards, self.W = tuple(shards), W


def _fake_slot(dev, tag, W=3):
    z = torch.full((2, W), tag, dtype=torch.int32)
    n = torch.zeros(1, dtype=torch.int32)
    return core.ShardSlot(dev, z, z, z[:1], n, n)


@pytest.mark.parametrize("devices,group,mode,cards", [
    ([CUDA0] * 4, None, "fixpoint", [[0, 1, 2, 3]]),
    ([CUDA0, CUDA1, CUDA0, CUDA1], None, "rounds", [[0, 2], [1, 3]]),
    ([CUDA0] * 2, GROUP, "rounds", [[0, 1]]),
    ([CPU] * 3, None, "fixpoint", [[0, 1, 2]]),
], ids=["one-card", "two-cards", "group", "cpu"])
def test_clause_shards_group_slots_by_device(devices, group, mode, cards,
                                             monkeypatch):
    """One ``CardShards`` a device, its shards in slot order; the mode
    from the devices and the group (the cards faked: no card is
    touched)."""
    monkeypatch.setattr(cuda_shard, "CardShards", _FakeCard)
    X = core.ClauseShards([_fake_slot(d, i) for i, d in enumerate(devices)],
                          group=group)
    assert X.mode == mode
    assert [[int(s.pos[0, 0]) for s in c.shards] for c in X.cards] == cards
    assert all(c.W == 3 for c in X.cards)


def test_forced_modes(monkeypatch):
    """``_mode="rounds"`` replaces the fixpoint mode of one device and no
    other mode; no other mode can be forced."""
    monkeypatch.setattr(cuda_shard, "CardShards", _FakeCard)
    for dev in (CUDA0, CPU):
        X = core.ClauseShards([_fake_slot(dev, 0)] * 2, _mode="rounds")
        assert X.mode == "rounds"
    for devices, forced in (([CUDA0], "plain"), ([CPU], "plain"),
                            ([CUDA0, CUDA1], "fixpoint"),
                            ([CUDA0], "fixpoint")):
        with pytest.raises(ValueError):
            core.ClauseShards([_fake_slot(d, 0) for d in devices],
                              _mode=forced)


# -- the per-card fold against the reference's round --------------------------

def _round_inputs(seed: int, C: int = 24, NA: int = 12, W: int = 3):
    rng = np.random.default_rng(seed)
    V = W * 32
    pos = rng.random((C, V)) < 0.04
    neg = (rng.random((C, V)) < 0.04) & ~pos
    mem = rng.random((NA, V)) < 0.08
    a = rng.random(V)
    t = a < 0.25
    f = (a >= 0.25) & (a < 0.45)
    min_bits = rng.random(V) < 0.2
    act = rng.random(NA) < 0.8
    card_n = rng.integers(0, 3, NA)
    min_w = int((min_bits & t).sum()) + int(rng.integers(-1, 2))

    def pack(bits):
        words = np.zeros(bits.shape[:-1] + (W,), np.uint32)
        for v in range(V):
            words[..., v // 32] |= bits[..., v].astype(np.uint32) << (v % 32)
        return words.view(np.int32)

    return dict(pos=pack(pos), neg=pack(neg), mem=pack(mem),
                act=act.astype(np.int32), card_n=card_n.astype(np.int32),
                min_bits=pack(min_bits), t=pack(t), f=pack(f), min_w=min_w)


def _reference_round(x: dict, n: int):
    """``round_planes`` under ``clause_axis`` over the first ``n``
    reference devices, the rows cut into ``n`` equal shards."""
    mesh = JMesh(np.array(jax.devices()[:n]), ("clause",))
    row, rep = P("clause"), P()
    with jcore.clause_axis("clause"):
        fn = jax.jit(shard_map(
            jcore.round_planes, mesh=mesh,
            in_specs=(row, row, row, row, row, rep, rep, rep, rep),
            out_specs=(rep, rep, rep, rep), check_vma=False))
        c, nt, nf, ch = fn(
            x["pos"], x["neg"], x["mem"], (x["act"] != 0)[:, None],
            x["card_n"][:, None], x["min_bits"][None], np.int32(x["min_w"]),
            x["t"][None], x["f"][None])
    return (bool(c), np.asarray(nt)[0].tolist(), np.asarray(nf)[0].tolist(),
            bool(ch))


def _card(x: dict, n: int) -> cuda_shard.CardShards:
    """The rows of ``x`` cut into ``n`` shards of one (CPU) card."""
    cut = [np.split(np.arange(x[k].shape[0]), n) for k in ("pos", "mem")]
    shards = [core.ShardSlot(
        CPU,
        *[torch.from_numpy(np.ascontiguousarray(x[k][rc]))
          for k in ("pos", "neg")],
        torch.from_numpy(np.ascontiguousarray(x["mem"][ra])),
        torch.from_numpy(x["card_n"][ra].copy()),
        torch.from_numpy(x["act"][ra].copy())) for rc, ra in zip(*cut)]
    return cuda_shard.CardShards(shards, x["t"].shape[0])


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_card_fold_equals_reference_round(n):
    for seed in range(4):
        x = _round_inputs(seed)
        card = _card(x, n)
        card.state.copy_(torch.from_numpy(np.stack([
            x["t"], x["f"], x["min_bits"], x["t"]])))
        buf = card.round(x["min_w"])
        assert buf.tolist() == cuda_shard.card_round_plain(
            cuda_shard.card_rows(card.shards), card.state,
            x["min_w"]).tolist()
        W = x["t"].shape[0]
        u = core._to_u
        c, nt, nf, ch = core._round_tail_u(
            u(buf[:W]), u(buf[W:2 * W]), bool(buf[2 * W]),
            u(torch.from_numpy(x["min_bits"])), x["min_w"],
            u(torch.from_numpy(x["t"])), u(torch.from_numpy(x["f"])))
        got = (bool(c), core._to_i32(nt).tolist(), core._to_i32(nf).tolist(),
               bool(ch))
        assert got == _reference_round(x, n), f"seed {seed}"


# -- the fixpoint against the reference's planes_fixpoint ---------------------

N_DEV = 8


def _states(problem, d, red: bool, seed: int, n: int = 4) -> list:
    """Seeded mid-search states (t, f, min_bits, min_w) of one padded
    problem, int32 words: the anchors true (in the full space the
    activation variables too, the padding false), a share of the open
    variables assigned each way, an extras row bound at its count, one
    above it and none."""
    V, W = (d.NV, d.Wr) if red else (d.V, d.Wv)
    rng = np.random.default_rng(seed)
    idx = np.arange(V)
    live = problem.n_vars if red else problem.n_vars + problem.n_cons
    t0 = np.isin(idx, problem.anchors) | ((idx >= problem.n_vars)
                                         & (idx < live))
    f0 = idx >= live
    pv = idx < problem.n_vars

    def pack(bits):
        return core.pack_mask(torch.from_numpy(bits), W).numpy()

    out = [(pack(t0), pack(f0), pack(np.zeros(V, bool)), 0)]
    for k in range(n - 1):
        share = rng.random(V)
        t = t0 | ((share < 0.1 + 0.05 * k) & ~f0 & pv)
        f = f0 | ((share > 0.9 - 0.05 * k) & ~t & pv)
        extras = (rng.random(V) < 0.2) & pv & (k < n - 2)
        out.append((pack(t), pack(f), pack(extras),
                    int((extras & t).sum()) + k % 2))
    return out


def _reference_fixpoint(jp, red: bool, states, monkeypatch):
    """``planes_fixpoint`` under ``clause_axis`` on 8 reference devices:
    (conflict, t, f, rounds) a state, the rounds counted by a callback in
    ``round_planes`` (once a round on each device)."""
    d = jclause._ShardDims([jp], N_DEV)
    pts = jdriver.pad_problem(jp, d, pack=True)
    V = d.NV if red else d.V
    calls = []
    real = jcore.round_planes

    def counted(*args):
        jax.debug.callback(lambda: calls.append(1))
        return real(*args)

    monkeypatch.setattr(jcore, "round_planes", counted)
    mesh = jclause.clause_mesh(jax.devices()[:N_DEV])
    with jcore.clause_axis(jclause.CLAUSE_AXIS):
        fn = jax.jit(shard_map(
            lambda pt, t, f, mb, mw: jcore.planes_fixpoint(
                pt, t, f, mb, mw, jnp.bool_(True), V, red),
            mesh=mesh, in_specs=(jclause._specs(jclause.CLAUSE_AXIS), P(),
                                 P(), P(), P()),
            out_specs=(P(), P(), P()), check_vma=False))
        out = []
        for t, f, mb, mw in states:
            del calls[:]
            c, nt, nf = fn(pts, t[None], f[None], mb[None], np.int32(mw))
            jax.effects_barrier()
            assert len(calls) % N_DEV == 0
            out.append((bool(c), np.asarray(nt)[0].tolist(),
                        np.asarray(nf)[0].tolist(), len(calls) // N_DEV))
    return out


def _port_fixpoints(problem, red: bool, states, slots: int,
                    mode=None) -> list:
    """``ClauseShards.fixpoint`` over ``slots`` CPU slots (the rows padded
    to a multiple of 8 and of ``slots``), in its own mode or forced to
    one round a call (``mode="rounds"``)."""
    d = clause_shard._ShardDims([problem], np.lcm(N_DEV, slots))
    pts_np = driver.pad_stack([problem], d, 1)
    X = clause_shard._shards(pts_np, d, clause_mesh([CPU] * slots), red,
                             _mode=mode)
    assert X.mode == (mode or "fixpoint") and len(X.cards) == 1
    out = []
    for t, f, mb, mw in states:
        u = core._to_u
        c, nt, nf, rounds = X.fixpoint(u(torch.from_numpy(t)),
                                       u(torch.from_numpy(f)),
                                       u(torch.from_numpy(mb)), mw)
        out.append((c, core._to_i32(nt).tolist(), core._to_i32(nf).tolist(),
                    rounds))
    return out


@pytest.mark.parametrize("space", ["reduced", "full"])
def test_fixpoint_equals_reference_planes_fixpoint(space, monkeypatch):
    red = space == "reduced"
    jp = jencode(jcatalog(12, 3, seed=1))
    tp = encode(operatorhub_catalog(12, 3, seed=1))
    d = clause_shard._ShardDims([tp], N_DEV)
    states = _states(tp, d, red, seed=3 + int(red))
    want = _reference_fixpoint(jp, red, states, monkeypatch)
    assert max(w[3] for w in want) > 1      # the states propagate
    assert any(w[0] for w in want) and not all(w[0] for w in want)
    assert _port_fixpoints(tp, red, states, N_DEV) == want
    assert _port_fixpoints(tp, red, states, N_DEV, "rounds") == want
    for slots in (1, 2, 4, 20):
        assert _port_fixpoints(tp, red, states, slots) == want, slots


def test_sharded_solve_counts_fixpoints_and_rounds():
    """Every fixpoint of a sharded solve is counted once, its rounds in
    ``sharded_rounds`` (at least one each), and none runs the unsharded
    plain rounds."""
    p = encode(operatorhub_catalog(12, 3, seed=4))
    f0, r0, p0 = core.sharded_fixpoints, core.sharded_rounds, \
        core.plain_rounds
    res = solve_sharded(p, mesh=clause_mesh([CPU] * 4))
    assert res.outcome == core.SAT
    fixpoints = core.sharded_fixpoints - f0
    rounds = core.sharded_rounds - r0
    assert 0 < fixpoints < rounds
    assert core.plain_rounds == p0
