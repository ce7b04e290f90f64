"""The port's clause-sharded solve against the JAX package's: the
counterpart of ``tests/test_clause_shard.py`` and of
``tests/test_shard.py::TestBackendCapability``.

``tests/conftest.py`` gives the reference 8 virtual CPU devices; the
port's counterpart is a clause mesh that names the CPU device more than
once (``clause_mesh([cpu] * n)``), whose slots run the round kernel's
plain version (``cuda_shard.shard_round_plain``) and fold their buffers
as the reference's all-gather does.

  * the reference's cases on CPU clause meshes of 4 and 8 slots;
  * ``solve_sharded`` on 8 slots equals ``deppy_tpu.parallel
    .solve_sharded`` on the 8-device mesh, bit for bit (outcome,
    installed set, core, steps, backtracks), on a SAT, an UNSAT and a
    catalog problem;
  * the round's shard parts folded over D shards equal the reference's
    ``round_planes`` (and, over 3 shards, the port's unsharded round);
  * the answer does not depend on the slot count;
  * ``BackendCapabilityError`` under every other impl, and the service's
    400; ``clause_mesh()`` without a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deppy_tpu import sat as jsat
from deppy_tpu.engine import core as jcore
from deppy_tpu.models import operatorhub_catalog as jcatalog
from deppy_tpu.models import random_instance as jrandom
from deppy_tpu.parallel import clause_shard as jclause
from deppy_tpu.sat.encode import encode as jencode
from deppy_tpu_torch import sat
from deppy_tpu_torch.engine import core, cuda_shard, driver
from deppy_tpu_torch.models import operatorhub_catalog, random_instance
from deppy_tpu_torch.parallel import (clause_mesh, solve_one_sharded,
                                      solve_sharded)
from deppy_tpu_torch.sat.encode import encode

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def bits_impl(monkeypatch):
    """Both packages on the bits impl, whatever the environment says."""
    monkeypatch.setattr(jcore, "_BCP_IMPL", "bits")
    monkeypatch.setattr(core, "_BCP_IMPL", "bits")


def _mesh(n):
    return clause_mesh([CPU] * n)


def _host(vs):
    try:
        return sorted(v.identifier
                      for v in sat.Solver(vs, backend="host").solve())
    except sat.NotSatisfiable as e:
        return str(e)


def _sharded(vs, mesh):
    try:
        return sorted(v.identifier for v in solve_one_sharded(vs, mesh=mesh))
    except sat.NotSatisfiable as e:
        return str(e)


def _lane(p, r):
    return (int(r.outcome), np.asarray(r.installed)[: p.n_vars].tolist(),
            np.asarray(r.core)[: p.n_cons].tolist(), int(r.steps),
            int(r.trace_n))


# -- the reference's cases (tests/test_clause_shard.py) ---------------------

@pytest.mark.parametrize("slots", [4, 8])
def test_preference_and_sat(slots):
    out = solve_one_sharded([
        sat.variable("A", sat.mandatory(), sat.dependency("B", "C")),
        sat.variable("B", sat.conflict("D")),
        sat.variable("C", sat.dependency("D")),
        sat.variable("D"),
    ], mesh=_mesh(slots))
    assert sorted(v.identifier for v in out) == ["A", "B"]


@pytest.mark.parametrize("slots", [4, 8])
def test_unsat_core_exact(slots):
    with pytest.raises(sat.NotSatisfiable) as ei:
        solve_one_sharded([
            sat.variable("a", sat.mandatory(), sat.conflict("b")),
            sat.variable("b", sat.mandatory()),
        ], mesh=_mesh(slots))
    assert str(ei.value) == (
        "constraints not satisfiable: a is mandatory, "
        "a conflicts with b, b is mandatory"
    )


@pytest.mark.parametrize("slots", [4, 8])
def test_atmost_rows_across_shards(slots):
    vs = [sat.variable("root", sat.mandatory(),
                       *[sat.dependency(f"g{g}.a", f"g{g}.b")
                         for g in range(16)])]
    for g in range(16):
        vs.append(sat.variable(f"g{g}.a",
                               sat.at_most(1, f"g{g}.a", f"g{g}.b")))
        vs.append(sat.variable(f"g{g}.b"))
    out = solve_one_sharded(vs, mesh=_mesh(slots))
    names = {v.identifier for v in out}
    assert "root" in names
    for g in range(16):
        assert len(names & {f"g{g}.a", f"g{g}.b"}) == 1


@pytest.mark.parametrize("slots", [4, 8])
def test_host_parity_random(slots):
    for seed in range(8):
        vs = random_instance(length=24, seed=seed)
        assert _sharded(vs, _mesh(slots)) == _host(vs), f"seed {seed}"


@pytest.mark.parametrize("slots", [4, 8])
def test_large_catalog_spans_shards(slots):
    vs = operatorhub_catalog(n_packages=30, versions_per_package=4, seed=1)
    p = encode(vs)
    assert p.clauses.shape[0] > slots  # rows genuinely split
    res = solve_sharded(p, mesh=_mesh(slots))
    assert res.outcome == core.SAT
    assert _sharded(vs, _mesh(slots)) == _host(vs)


@pytest.mark.parametrize("slots", [4, 8])
def test_giant_unsat_host_routed_core(slots, monkeypatch):
    """Above ``driver.HOST_CORE_NCONS`` the core routes to the host
    engine; forced down, a small instance takes that route, forced up the
    device route: the same error and core either way."""
    vs = operatorhub_catalog(n_packages=8, versions_per_package=3, seed=2)
    vs = list(vs) + [
        sat.variable("pin-a", sat.mandatory(), sat.conflict("pin-b")),
        sat.variable("pin-b", sat.mandatory()),
    ]
    mesh = _mesh(slots)
    monkeypatch.setattr(driver, "HOST_CORE_NCONS", 1 << 30)
    r0 = core.sharded_rounds
    dev_msg = _sharded(vs, mesh)
    dev_rounds = core.sharded_rounds - r0
    monkeypatch.setattr(driver, "HOST_CORE_NCONS", 0)
    r0 = core.sharded_rounds
    host_msg = _sharded(vs, mesh)
    host_rounds = core.sharded_rounds - r0
    assert dev_msg == host_msg
    assert "pin-a is mandatory" in host_msg
    # The device route's core phase ran sharded rounds the host route
    # left to the host engine.
    assert dev_rounds > host_rounds > 0


# -- bit for bit against the reference's sharded solve ------------------------

def _sat_problem():
    return [
        ("A", "mandatory", ("dep", "B", "C")), ("B", ("conflict", "D")),
        ("C", ("dep", "D")), ("D",)]


def _build(pkg, spec):
    out = []
    for name, *cons in spec:
        made = []
        for c in cons:
            if c == "mandatory":
                made.append(pkg.mandatory())
            elif c[0] == "dep":
                made.append(pkg.dependency(*c[1:]))
            else:
                made.append(pkg.conflict(*c[1:]))
        out.append(pkg.variable(name, *made))
    return out


_UNSAT = [("a", "mandatory", ("conflict", "b")), ("b", "mandatory"),
          ("c", ("dep", "a"))]


@pytest.mark.parametrize("which", ["sat", "unsat", "catalog"])
def test_matches_reference_sharded_solve(which):
    if which == "catalog":
        jvs, tvs = jcatalog(30, 4, seed=1), operatorhub_catalog(30, 4, seed=1)
    else:
        spec = _sat_problem() if which == "sat" else _UNSAT
        jvs, tvs = _build(jsat, spec), _build(sat, spec)
    jp, tp = jencode(jvs), encode(tvs)
    want = jclause.solve_sharded(jp, mesh=jclause.clause_mesh())
    got = solve_sharded(tp, mesh=_mesh(8))
    assert _lane(tp, got) == _lane(jp, want)
    assert got.outcome == {"sat": core.SAT, "unsat": core.UNSAT,
                           "catalog": core.SAT}[which]


# -- the round's shard parts against the reference's round ------------------

def _round_inputs(seed: int, C: int = 24, NA: int = 9, W: int = 3):
    rng = np.random.default_rng(seed)
    V = W * 32

    def plane(rows, p):
        bits = rng.random((rows, V)) < p
        return bits

    pos = plane(C, 0.04)
    neg = plane(C, 0.04) & ~pos
    mem = plane(NA, 0.08)
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


def _fold(x: dict, n_shards: int):
    """(conflict, new_t, new_f, changed) from the shards' buffers folded
    and the replicated tail."""
    W = x["t"].shape[0]
    buf = None
    for rc, ra in zip(np.array_split(np.arange(x["pos"].shape[0]), n_shards),
                      np.array_split(np.arange(x["mem"].shape[0]), n_shards)):
        part = cuda_shard.shard_round_plain(
            torch.from_numpy(x["pos"][rc]), torch.from_numpy(x["neg"][rc]),
            torch.from_numpy(x["mem"][ra]), torch.from_numpy(x["act"][ra]),
            torch.from_numpy(x["card_n"][ra]),
            torch.from_numpy(x["min_bits"]), torch.from_numpy(x["t"]),
            torch.from_numpy(x["f"]), x["min_w"])
        buf = part if buf is None else buf | part
    u = core._to_u
    c, nt, nf, ch = core._round_tail_u(
        u(buf[:W]), u(buf[W:2 * W]), buf[2 * W] != 0,
        u(torch.from_numpy(x["min_bits"])), x["min_w"],
        u(torch.from_numpy(x["t"])), u(torch.from_numpy(x["f"])))
    return (bool(c), core._to_i32(nt).numpy().tolist(),
            core._to_i32(nf).numpy().tolist(), bool(ch))


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_fold_equals_reference_round(n_shards):
    for seed in range(6):
        x = _round_inputs(seed)
        c, nt, nf, ch = jcore.round_planes(
            x["pos"], x["neg"], x["mem"], (x["act"] != 0)[:, None],
            x["card_n"][:, None], x["min_bits"][None], np.int32(x["min_w"]),
            x["t"][None], x["f"][None])
        want = (bool(c), np.asarray(nt)[0].tolist(), np.asarray(nf)[0].tolist(),
                bool(ch))
        assert _fold(x, n_shards) == want, f"seed {seed}"


def test_shard_fold_over_three_equals_unsharded_round():
    for seed in range(6):
        x = _round_inputs(seed)
        c, nt, nf, ch = core.round_planes(
            torch.from_numpy(x["pos"]), torch.from_numpy(x["neg"]),
            torch.from_numpy(x["mem"]), torch.from_numpy(x["act"]),
            torch.from_numpy(x["card_n"]), torch.from_numpy(x["min_bits"]),
            x["min_w"], torch.from_numpy(x["t"]), torch.from_numpy(x["f"]))
        assert _fold(x, 3) == (c, nt.tolist(), nf.tolist(), ch), \
            f"seed {seed}"


def test_shard_round_checks_its_inputs():
    """A card's shards are checked once, where ``CardShards`` binds them:
    int32, contiguous, of the planes' width, on one device; a bound
    card's round equals the plain version of the shard's round."""
    x = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in _round_inputs(0).items()}
    W = x["t"].shape[0]
    slot = core.ShardSlot(CPU, x["pos"], x["neg"], x["mem"], x["card_n"],
                          x["act"])
    card = cuda_shard.CardShards([slot], W)
    card.state.copy_(torch.stack([x["t"], x["f"], x["min_bits"], x["t"]]))
    assert card.round(x["min_w"]).tolist() == cuda_shard.shard_round_plain(
        x["pos"], x["neg"], x["mem"], x["act"], x["card_n"], x["min_bits"],
        x["t"], x["f"], x["min_w"]).tolist()
    with pytest.raises(TypeError):
        cuda_shard.CardShards([slot._replace(pos=x["pos"].to(torch.int64))],
                              W)
    with pytest.raises(ValueError):
        cuda_shard.CardShards([slot._replace(mem=x["mem"][:, :2])], W)
    with pytest.raises(ValueError):
        cuda_shard.CardShards(
            [slot._replace(pos=x["pos"].t().contiguous().t())], W)
    with pytest.raises(ValueError):
        cuda_shard.CardShards([slot, slot._replace(
            card_act=torch.zeros_like(x["act"]))], W)


def test_bound_launcher_reads_its_refilled_state():
    """``CardShards`` (a card's shards bound for the rounds of a solve)
    reads its state and activity at every call: refilled in place, each
    round equals the plain version of the shard's round on the new
    inputs."""
    x0 = _round_inputs(0)
    W = x0["t"].shape[0]
    act = torch.from_numpy(x0["act"].copy())
    planes = [torch.from_numpy(x0[k]) for k in ("pos", "neg", "mem")]
    card_n = torch.from_numpy(x0["card_n"])
    card = cuda_shard.CardShards(
        [core.ShardSlot(CPU, *planes, card_n, act)], W)
    for seed in range(4):
        x = _round_inputs(seed)
        card.state.copy_(torch.from_numpy(np.stack([
            x["t"], x["f"], x["min_bits"], x["t"]])))
        act.copy_(torch.from_numpy(x["act"]))
        want = cuda_shard.shard_round_plain(
            *planes, act, card_n, torch.from_numpy(x["min_bits"]),
            torch.from_numpy(x["t"]), torch.from_numpy(x["f"]), x["min_w"])
        assert card.round(x["min_w"]).tolist() == want.tolist(), \
            f"seed {seed}"
    with pytest.raises(ValueError):
        cuda_shard.CardShards(
            [core.ShardSlot(CPU, planes[0], planes[1], planes[2][:, :2],
                           card_n, act)], W)


# -- slot counts, capability, devices ----------------------------------------

def test_results_identical_over_slot_counts():
    problems = [encode(random_instance(length=24, seed=s)) for s in range(3)]
    problems.append(encode(operatorhub_catalog(12, 3, seed=4)))
    for p in problems:
        lanes = {n: _lane(p, solve_sharded(p, mesh=_mesh(n)))
                 for n in (1, 2, 4, 8)}
        assert len({repr(v) for v in lanes.values()}) == 1, lanes


@pytest.mark.parametrize("impl", ["blockwise", "watched", "gather",
                                  "pallas"])
def test_clause_shard_requires_bits_impl(impl, monkeypatch):
    monkeypatch.setattr(core, "_BCP_IMPL", impl)
    with pytest.raises(sat.BackendCapabilityError) as ei:
        solve_sharded(encode(random_instance(length=8, seed=1)),
                      mesh=_mesh(2))
    assert "clause_shard" in str(ei.value)
    assert impl in str(ei.value)
    assert "DEPPY_GPU_BCP" in str(ei.value)
    monkeypatch.setattr(jcore, "_BCP_IMPL", impl)
    with pytest.raises(jsat.errors.BackendCapabilityError) as ej:
        jclause.solve_sharded(jencode(jrandom(length=8, seed=1)))
    assert str(ej.value).split(":")[0] == str(ei.value).split(":")[0]


def test_service_renders_capability_error_as_400(monkeypatch):
    """The typed error is a clean client-facing verdict at the service
    boundary, as the reference's (service.py:599-605)."""
    from deppy_tpu_torch.resolution import facade
    from deppy_tpu_torch.service import Server

    assert not issubclass(sat.BackendCapabilityError,
                          sat.InternalSolverError)
    err = sat.BackendCapabilityError("clause_shard", "blockwise",
                                     hint="select bits")

    def refuse(self, problems):
        raise err

    monkeypatch.setattr(facade.BatchResolver, "solve", refuse)
    srv = Server(device="cpu", bind_address="127.0.0.1:0",
                 probe_address="127.0.0.1:0", sched="off")
    doc = {"variables": [{"id": "a", "constraints": [{"type": "mandatory"}]}]}
    status, body = srv.resolve_document(doc)
    assert (status, body) == (400, {"error": str(err)})


def test_clause_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(driver.NoDeviceError):
        clause_mesh()
    with pytest.raises(driver.NoDeviceError):
        clause_mesh([torch.device("cuda", 0)] * 2)
