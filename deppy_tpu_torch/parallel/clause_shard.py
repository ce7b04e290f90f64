"""Clause-sharded solve: ONE problem's clause rows over the slots of a mesh (port of ``deppy_tpu/parallel/clause_shard.py:1-171``).

The batch axis (:mod:`.mesh`) scales many problems; this module scales
one problem whose clause planes outgrow one device: its clause and
AtMost rows are cut into equal shards, one a slot of a clause mesh, and
every round of propagation combines the shards' forced-literal masks and
row conflicts with one OR exchange.  That is the whole communication
pattern: a ``[2W+1]`` int32 buffer a round.

The reference runs its replicated control (``core.solve_full``: the
baseline, the guess search with DPLL leaves, the minimization, the core)
on every device under ``shard_map``, BCP's rows sharded.  The port keeps
that control on the host, once a process: the phase code of
:mod:`deppy_tpu_torch.engine.core` (``search_phase``, ``minimize_phase``,
``core_phase``), which equals the reference's XLA phases bit for bit,
over the replicated ``[W]``-word assignment planes.  The fixpoints run
on the slots: each slot's shard is uploaded once a solve to the slot's
device, and :class:`core.ClauseShards` groups the slots by device.  When
every slot is on one card and there is one process, a fixpoint is one
cooperative launch over all of them (``CardShards.fixpoint``: the
rounds, the exchange and the tail on the card).  Otherwise each round is
one launch a card (``CardShards.round``; the plain version on the CPU)
and the host folds the cards' buffers and then, over a process group,
the ranks' by a gloo all-gather, and runs the round's tail.

After :func:`~.mesh.initialize_distributed` the clause mesh spans every
rank: the shard count is ranks x slots, rank *r* owns shards
``r*L ... r*L + L - 1``, and every rank runs the same control and
returns the same result.

Only the ``bits`` impl's dense rounds carry the exchange, as in the
reference; any other impl raises :class:`BackendCapabilityError`.  Giant
UNSAT problems (more than ``driver.HOST_CORE_NCONS`` constraints) route
their core to the host engine, exactly as the reference's
(clause_shard.py:138-154).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..engine import core, driver
from ..sat.constraints import Variable
from ..sat.encode import Problem, encode
from ..sat.errors import (BackendCapabilityError, Incomplete,
                          InternalSolverError)
from .mesh import Mesh, spanning

CLAUSE_AXIS = "clause"


def clause_mesh(devices=None) -> Mesh:
    """A 1-D mesh of clause slots over ``devices`` (default: every visible
    CUDA device; none raises ``NoDeviceError``).  A list may name one
    device more than once.  After ``initialize_distributed`` the mesh
    spans every rank, ``devices`` being this rank's slots."""
    if devices is None:
        driver.resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return spanning([driver.resolve_device(d) for d in devices])


# ProblemTensors fields whose leading axis is the clause (C) or
# cardinality (NA) row axis — these shard; everything else replicates.
_ROW_SHARDED = {
    "clauses", "card_ids", "card_n", "card_act", "card_valid",
    "pos_bits", "neg_bits", "card_member_bits", "card_act_bits",
    "pos_bits_r", "neg_bits_r", "card_member_bits_r",
}


class _ShardDims(driver._Dims):
    """One problem's dims with the row axes padded to a multiple of the
    shard count (clause_shard.py:62-72)."""

    def __init__(self, problems, n_shards: int):
        super().__init__(problems, 1)
        for f in ("C", "NA"):
            v = getattr(self, f)
            setattr(self, f, -(-v // n_shards) * n_shards)


def _shard_rows(pts_np: core.ProblemTensors, g: int,
                n_shards: int) -> dict:
    """Shard ``g`` of ``n_shards`` of a padded lane's row-sharded fields
    (host arrays, the batch axis kept): each cut on its row axis."""
    out = {}
    for f in _ROW_SHARDED:
        a = getattr(pts_np, f)
        n = a.shape[1] // n_shards
        out[f] = np.ascontiguousarray(a[:, g * n:(g + 1) * n])
    return out


def _shards(pts_np: core.ProblemTensors, d: _ShardDims, mesh: Mesh,
            red: bool, _mode: Optional[str] = None) -> core.ClauseShards:
    """This rank's shards of the padded problem ``pts_np`` (one lane,
    host arrays) in the reduced (``red``) or the full plane space: each
    slot's compact rows cross to its device once and its planes are
    derived there.  In the full space each slot keeps its rows'
    activation variables, so AtMost-row activity follows each fixpoint's
    entry state on the slot's device.  ``_mode="rounds"`` forces one
    launch a round on one card (``core.ClauseShards``), for a
    measurement."""
    slots = []
    for i, dev in enumerate(mesh.devices):
        g = mesh.first_shard + i
        rows = {f: torch.from_numpy(a).to(dev)
                for f, a in _shard_rows(pts_np, g, mesh.shards).items()}
        pos, neg, mem, _, pos_r, neg_r, mem_r = core.derive_planes(
            rows["clauses"], rows["card_ids"], rows["card_act"],
            torch.from_numpy(pts_np.n_vars).to(dev), Wv=d.Wv, Wr=d.Wr,
            red=red, full=not red)
        if red:
            pos, neg, mem = pos_r, neg_r, mem_r
        slots.append(core.ShardSlot(
            dev, pos[0].contiguous(), neg[0].contiguous(),
            mem[0].contiguous(), rows["card_n"][0], rows["card_valid"][0],
            None if red else rows["card_act"][0].contiguous()))
    group = None
    if mesh.ranks > 1:
        import torch.distributed as dist

        group = dist.group.WORLD
    return core.ClauseShards(slots, group=group, _mode=_mode)


def solve_sharded(
    problem: Problem,
    mesh: Optional[Mesh] = None,
    max_steps: Optional[int] = None,
) -> core.SolveResult:
    """Solve ONE lowered problem with its clause rows sharded over the
    mesh (clause_shard.py:102-154).  Use for problems too large for one
    device; for fleets of normal-sized problems use the batched driver.
    Every rank of a mesh that spans a process group must call it with
    the same problem, and every rank gets the same result.  A mesh on
    one card runs each fixpoint as one launch (``core.shard_mode``)."""
    if problem.errors:
        raise InternalSolverError(problem.errors)
    impl = core.resolved_impl()
    if impl != "bits":
        # Only the bits impl's dense rounds carry the per-round OR
        # exchange; the others would propagate per shard with no combine.
        # Typed, so the facade and the service render a clean verdict.
        raise BackendCapabilityError(
            "clause_shard", impl,
            hint="clause-sharded solve carries its per-round OR "
            "exchange only in the 'bits' BCP round kernel; unset "
            "DEPPY_GPU_BCP or select bits",
        )
    if mesh is None:
        mesh = clause_mesh()
    for dev in mesh.distinct():
        driver.resolve_device(dev)
    d = _ShardDims([problem], mesh.shards)
    pts_np = driver.pad_stack([problem], d, 1)
    pt = core.lane(core.ProblemTensors(*[torch.from_numpy(a)
                                         for a in pts_np]), 0)
    budget = driver._budget(max_steps)

    X = _shards(pts_np, d, mesh, red=True)
    result, guessed, model, steps, _, tr_n = core.search_phase(
        pt, budget, True, red=True, NCON=d.NCON, shards=X)
    sat = result == core.SAT
    installed, found, min_steps = core.minimize_phase(
        pt, model, guessed, budget, steps, sat, red=True, NCON=d.NCON,
        shards=X)
    if sat:
        steps = min_steps
    cores = torch.zeros(d.NCON, dtype=torch.bool)
    if result == core.UNSAT:
        if problem.n_cons > driver.HOST_CORE_NCONS:
            # Giant problems route their core to the host engine, as the
            # batched driver does (clause_shard.py:138-154).
            hc, hs = driver._host_core_rows([problem], np.array([0]),
                                            d.NCON, budget,
                                            np.array([steps]))
            cores = torch.from_numpy(hc[0])
            steps += int(hs[0])
        else:
            cores, steps = core.core_phase(
                pt, budget, steps, True, NCON=d.NCON,
                shards=_shards(pts_np, d, mesh, red=False))
    incomplete = (steps > budget or result == core.RUNNING
                  or (sat and not found))
    return core.SolveResult(
        core.RUNNING if incomplete else result, installed, cores, steps,
        torch.zeros((0, d.NC + 1), dtype=torch.int32), tr_n)


def solve_one_sharded(
    variables: List[Variable],
    mesh: Optional[Mesh] = None,
    max_steps: Optional[int] = None,
) -> List[Variable]:
    """End-to-end single-problem entry with clause sharding: the contract
    of ``Solver.solve()`` — installed variables, or :class:`NotSatisfiable`
    with the minimal constraint core, or :class:`Incomplete`."""
    problem = encode(variables)
    res = solve_sharded(problem, mesh=mesh, max_steps=max_steps)
    if res.outcome == core.SAT:
        return driver._decode_installed(problem, res.installed)
    if res.outcome == core.UNSAT:
        raise driver._decode_core(problem, res.core)
    raise Incomplete()
