"""The clause path's kernels: a clause-sharded fixpoint a card and one round a card, CUDA wrappers and plain versions (no ``pallas_call`` counterpart: ``deppy_tpu/engine/core.py:361`` ``round_planes`` under ``clause_axis`` inside ``planes_fixpoint``).

A clause-sharded solve (:mod:`deppy_tpu_torch.parallel.clause_shard`)
keeps its phase control on the host and cuts the problem's clause and
AtMost rows over the slots of a clause mesh.  :class:`core.ClauseShards`
groups the slots by device, one :class:`CardShards` a device: the
device's slots bound once a solve, with the state, output and exchange
buffers the kernels read and write.

* :meth:`CardShards.fixpoint`: a whole fixpoint over the card's slots
  (``csrc/shard_round.cu`` ``grid_fixpoint_kernel``, one cooperative
  launch; :func:`fixpoint_plain` on the CPU), returning (conflict,
  rounds, t, f).  The mode of a mesh on one card in one process.
* :meth:`CardShards.round`: one round's row part over the card's slots,
  folded into the int32 buffer ``[2W+1]`` (forced-true mask, forced-false
  mask, row conflict) that the host folds with the other cards' and
  ranks' before the replicated tail (``card_round_kernel``;
  :func:`card_round_plain` on the CPU).  The mode of a mesh that spans
  cards or ranks.

A card's slots are one table on the card (``deppy_card_table``), so a
card takes any number of them.  A CUDA tensor goes to the hand-written
kernel, each launch counted once in :mod:`.counts` under
``shard_round``; a CPU tensor goes to the plain version, the same
function in PyTorch (``core._round_partial_u`` over the card's rows
taken together, :func:`card_rows`, and ``core._round_loop``).  AtMost-row
activity is static
(``card_valid``, the reduced space) or, in the full space, follows the
fixpoint's entry ``t`` through each row's activation variable
(``card_act``, core.py:900-902), on the card as in the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build, core, counts

KERNEL = "shard_round"

# Calls of the plain version of a round's row part (on a CPU card, or a
# comparison's); a card solve must leave it still.
plain_calls = 0


def _check(tensors: dict, shapes: dict) -> torch.device:
    dev = None
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shapes[name]}")
        if dev is None:
            dev = x.device
        elif x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_shard(s: core.ShardSlot, W: int) -> torch.device:
    C, NA = s.pos.shape[0], s.mem.shape[0]
    tensors = dict(pos=s.pos, neg=s.neg, mem=s.mem, card_n=s.card_n,
                   card_valid=s.card_valid)
    shapes = dict(pos=(C, W), neg=(C, W), mem=(NA, W), card_n=(NA,),
                  card_valid=(NA,))
    if s.card_act is not None:
        tensors["card_act"] = s.card_act
        shapes["card_act"] = (NA,)
    return _check(tensors, shapes)


def _activity(s: core.ShardSlot, t_entry: torch.Tensor) -> torch.Tensor:
    """int32 [NA]: the shard's active AtMost rows for a fixpoint from
    ``t_entry`` (int32 words)."""
    if s.card_act is None:
        return s.card_valid
    ca = s.card_act.to(torch.int64)
    idx = ca.clamp(min=0)
    bit = (t_entry.to(torch.int64)[idx >> 5] >> (idx & 31)) & 1
    return ((ca >= 0) & (bit != 0)).to(torch.int32)


class CardShards:
    """The shards of one device (``core.ShardSlot``), bound for the
    rounds of a solve: each shard's tensors are checked once, here.
    ``state`` (int32 [4, W]: t, f, min_bits and the fixpoint's entry t)
    is read at every call, so the caller refills it in place; ``xbuf``
    holds the kernels' three exchange buffers ([3, 2W+1], ``k`` the next
    one, zero) and ``out`` the fixpoint kernel's output ([2W+2]:
    conflict, rounds, t, f).  On a card a call launches a kernel and
    counts the launch, the shards named by a slot table copied to the
    card here; on the CPU it runs the plain version over ``plain``, the
    shards' rows taken together here (:func:`card_rows`)."""

    def __init__(self, shards: Sequence[core.ShardSlot], W: int):
        self.shards = tuple(shards)
        if not self.shards:
            raise ValueError("a card needs at least one shard")
        devs = {_check_shard(s, W) for s in self.shards}
        if len(devs) != 1:
            raise ValueError("a card's shards lie on "
                             f"{sorted(map(str, devs))}")
        if len({s.card_act is None for s in self.shards}) != 1:
            raise ValueError("a card's shards mix static and entry-state "
                             "AtMost activity")
        self.dev = devs.pop()
        self.W = W
        self.state = torch.zeros((4, W), dtype=torch.int32, device=self.dev)
        self.xbuf = torch.zeros((3, 2 * W + 1), dtype=torch.int32,
                                device=self.dev)
        self.out = torch.zeros(2 * W + 2, dtype=torch.int32, device=self.dev)
        self.k = 0
        self.rows = sum(s.pos.shape[0] + s.mem.shape[0] for s in self.shards)
        self._blocks: dict = {}
        if self.dev.type == "cpu":
            self.plain = card_rows(self.shards)
            return
        ptrs = []
        for s in self.shards:
            static = s.card_act is None
            ptrs += [s.pos.data_ptr(), s.neg.data_ptr(), s.mem.data_ptr(),
                     s.card_n.data_ptr(),
                     s.card_valid.data_ptr() if static else None,
                     None if static else s.card_act.data_ptr()]
        n = len(self.shards)
        dims = (ctypes.c_int * (2 * n))(*[
            d for s in self.shards for d in (s.pos.shape[0], s.mem.shape[0])])
        lib = _build.load()
        table = torch.empty(lib.deppy_card_table_bytes(n), dtype=torch.uint8)
        _build.check(lib.deppy_card_table(
            (ctypes.c_void_p * len(ptrs))(*ptrs), dims, n,
            table.data_ptr()), KERNEL)
        self.table = table.to(self.dev)
        planes = [x for s in self.shards for x in (s.pos, s.neg, s.mem)]
        self.vec = 4 if W % 4 == 0 and all(
            x.data_ptr() % 16 == 0 for x in planes) else 1

    def blocks(self, fixpoint: bool) -> int:
        """The grid of a launch: for the fixpoint kernel every block the
        card holds at once (the occupancy API's blocks an SM times the
        SMs); for the round kernel one warp a row, at most as many."""
        if fixpoint not in self._blocks:
            lib = _build.load()
            n = ctypes.c_int(0)
            with torch.cuda.device(self.dev):
                rc = lib.deppy_card_plan(self.W, int(fixpoint), self.vec,
                                         ctypes.byref(n))
            _build.check(rc, KERNEL)
            most = n.value
            if not fixpoint:
                most = max(1, min(most, -(-self.rows // 16)))
            self._blocks[fixpoint] = most
        return self._blocks[fixpoint]

    def round(self, min_w: int) -> torch.Tensor:
        """The card's part of one round from ``state``: int32 [2W+1] on
        the card's device (an exchange buffer of the card, valid until
        its second launch after this one)."""
        if self.dev.type == "cpu":
            return card_round_plain(self.plain, self.state, min_w)
        blocks = self.blocks(False)
        k = self.k
        with torch.cuda.device(self.dev):
            rc = _build.load().deppy_card_round(
                self.table.data_ptr(), len(self.shards), self.W, self.vec,
                self.state.data_ptr(), int(min_w), self.xbuf.data_ptr(), k,
                blocks, torch.cuda.current_stream(self.dev).cuda_stream)
        counts.count(KERNEL, "bits", "round", None)
        _build.check(rc, KERNEL)
        self.k = (k + 1) % 3
        return self.xbuf[k]

    def fixpoint(self, min_w: int):
        """A fixpoint over the card's shards from ``state`` rows 0-2 (t,
        f, min_bits; t is the entry t): (conflict: bool, rounds: int,
        t, f) with t and f int32 [W] on the host."""
        if self.dev.type == "cpu":
            return fixpoint_plain(self.plain, self.state[:3], min_w)
        blocks = self.blocks(True)
        with torch.cuda.device(self.dev):
            rc = _build.load().deppy_grid_fixpoint(
                self.table.data_ptr(), len(self.shards), self.W, self.vec,
                self.state.data_ptr(), int(min_w), self.xbuf.data_ptr(),
                self.k, self.out.data_ptr(), blocks,
                torch.cuda.current_stream(self.dev).cuda_stream)
        counts.count(KERNEL, "bits", "fixpoint", None)
        _build.check(rc, KERNEL)
        out = self.out.cpu()
        conflict, rounds = out[:2].tolist()
        self.k = (self.k + rounds) % 3
        W = self.W
        return bool(conflict), rounds, out[2:2 + W], out[2 + W:]


def shard_round_plain(pos, neg, mem, act, card_n, min_bits, t, f,
                      min_w: int) -> torch.Tensor:
    """The plain version of one shard's round part, on any device."""
    global plain_calls
    plain_calls += 1
    u = core._to_u
    wpos, wneg, conflict = core._round_partial_u(
        u(pos), u(neg), u(mem), act != 0, card_n.to(torch.int64),
        u(min_bits), int(min_w), u(t), u(f))
    return torch.cat([core._to_i32(wpos), core._to_i32(wneg),
                      conflict.to(torch.int32).reshape(1)])


def card_rows(shards: Sequence[core.ShardSlot]) -> core.ShardSlot:
    """The card's shards as one shard, their rows in slot order (the one
    shard itself when there is one).  A card's part of a round is its
    shards' parts folded by OR, which is the part of their rows taken
    together (the replicated extras part is idempotent under OR)."""
    if len(shards) == 1:
        return shards[0]
    s0 = shards[0]
    return core.ShardSlot(
        s0.device, *[torch.cat([getattr(s, k) for s in shards])
                     for k in ("pos", "neg", "mem", "card_n", "card_valid")],
        None if s0.card_act is None else torch.cat(
            [s.card_act for s in shards]))


def card_round_plain(rows: core.ShardSlot, state: torch.Tensor,
                     min_w: int) -> torch.Tensor:
    """The plain version of :meth:`CardShards.round`, on any device: the
    part of one round of the card's rows (:func:`card_rows`) from
    ``state`` (int32 [4, W])."""
    t, f, min_bits, t_entry = state
    return shard_round_plain(rows.pos, rows.neg, rows.mem,
                             _activity(rows, t_entry), rows.card_n,
                             min_bits, t, f, min_w)


def fixpoint_plain(rows: core.ShardSlot, state: torch.Tensor, min_w: int):
    """The plain version of :meth:`CardShards.fixpoint`, on any device:
    the part of a round of the card's rows (:func:`card_rows`) and the
    replicated tail from ``state`` (int32 [3, W]: t, f, min_bits) until a
    conflict or no change.  Returns (conflict, rounds, t, f), t and f
    int32 [W] on the host."""
    u, i32 = core._to_u, core._to_i32
    pos, neg, mem = u(rows.pos), u(rows.neg), u(rows.mem)
    active = _activity(rows, state[0]) != 0
    card_n = rows.card_n.to(torch.int64)
    min_bits = u(state[2])

    def part(t, f):
        global plain_calls
        plain_calls += 1
        wpos, wneg, conflict = core._round_partial_u(
            pos, neg, mem, active, card_n, min_bits, int(min_w), t, f)
        return wpos, wneg, bool(conflict)

    c, t, f, rounds = core._round_loop(part, u(state[0]), u(state[1]),
                                       min_bits, min_w)
    return c, rounds, i32(t).cpu(), i32(f).cpu()
