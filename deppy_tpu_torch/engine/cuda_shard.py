"""One BCP round over one clause shard: CUDA kernel wrapper and plain version (no ``pallas_call`` counterpart: ``deppy_tpu/engine/core.py:361`` ``round_planes`` under ``clause_axis``).

A clause-sharded solve (:mod:`deppy_tpu_torch.parallel.clause_shard`)
keeps its control on the host and cuts the problem's clause and AtMost
rows over the slots of a clause mesh.  Each round, every slot computes
its shard's part of the round (a :class:`ShardRound`, the wrapper bound
once a solve to the slot's resident tensors), and
:class:`core.ClauseShards` folds the parts (the reference's fused OR
all-gather, ``core.py:343-358``) before the replicated tail
(``core._round_tail_u``).

:func:`shard_round` (the unbound call) and :class:`ShardRound` return the
int32 buffer ``[2W+1]`` the exchange folds: the shard's forced-true mask,
its forced-false mask and its row conflict (see ``csrc/shard_round.cu``).
A CUDA tensor goes to the hand-written kernel, each launch counted once
in :mod:`.counts` under ``shard_round``; a CPU tensor goes to
:func:`shard_round_plain`, the same function in PyTorch
(``core._round_partial_u``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, core, counts

KERNEL = "shard_round"

# Calls of the plain version (on a CPU slot, or a comparison's); a card
# solve must leave it still.
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


def shard_round(pos, neg, mem, act, card_n, min_bits, t, f, min_w: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round's row part over one shard.  int32 inputs: pos/neg
    [C, W], mem [NA, W], the rows' activity ``act`` and bounds ``card_n``
    [NA], min_bits/t/f [W]; ``min_w`` an int.  Returns int32 [2W+1]
    (``out`` when given, written in place): wpos, wneg, row conflict."""
    W = pos.shape[1]
    _check(dict(min_bits=min_bits, t=t, f=f),
           dict(min_bits=(W,), t=(W,), f=(W,)))
    if out is None:
        out = torch.empty(2 * W + 1, dtype=torch.int32, device=pos.device)
    return ShardRound(pos, neg, mem, act, card_n,
                      torch.stack([t, f, min_bits]), out)(min_w)


class ShardRound:
    """:func:`shard_round` bound to one slot's resident tensors, for the
    rounds of a solve: the inputs are checked once, here, and each call
    runs one round into ``out``.  ``state`` is int32 [3, W], its rows t,
    f and min_bits; ``act`` and ``state`` are read at every call, so the
    caller refills them in place between rounds.  On a card a call
    launches the kernel and counts the launch; on the CPU it runs the
    plain version."""

    def __init__(self, pos, neg, mem, act, card_n, state, out):
        C, W = pos.shape
        NA = mem.shape[0]
        self.args = (pos, neg, mem, act, card_n, state[2], state[0],
                     state[1])
        self.out = out
        self.dev = _check(
            dict(zip(("pos", "neg", "mem", "act", "card_n", "min_bits", "t",
                      "f"), self.args), out=out),
            dict(pos=(C, W), neg=(C, W), mem=(NA, W), act=(NA,),
                 card_n=(NA,), min_bits=(W,), t=(W,), f=(W,),
                 out=(2 * W + 1,)))
        self.dims = (C, NA, W)
        self.ptrs = [x.data_ptr() for x in self.args]

    def __call__(self, min_w: int) -> torch.Tensor:
        if self.dev.type == "cpu":
            return self.out.copy_(shard_round_plain(*self.args, min_w))
        lib = _build.load()
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        rc = lib.deppy_shard_round(*self.ptrs, int(min_w), *self.dims,
                                   self.out.data_ptr(), stream)
        counts.count(KERNEL, "bits", "grid", None)
        _build.check(rc, KERNEL)
        return self.out


def shard_round_plain(pos, neg, mem, act, card_n, min_bits, t, f,
                      min_w: int) -> torch.Tensor:
    """The plain version of :func:`shard_round`, on any device."""
    global plain_calls
    plain_calls += 1
    u = core._to_u
    wpos, wneg, conflict = core._round_partial_u(
        u(pos), u(neg), u(mem), act != 0, card_n.to(torch.int64),
        u(min_bits), int(min_w), u(t), u(f))
    return torch.cat([core._to_i32(wpos), core._to_i32(wneg),
                      conflict.to(torch.int32).reshape(1)])
