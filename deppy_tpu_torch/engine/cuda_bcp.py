"""Batched BCP fixpoint: CUDA kernel wrapper and plain version (port of ``deppy_tpu/engine/pallas_bcp.py:79-110``).

:func:`bcp_fixpoint` takes a batch of problems' planes and runs the
propagation round to a fixpoint for each.  A CUDA tensor goes to the
hand-written kernel ``csrc/bcp.cu`` (one thread block per problem); a CPU
tensor goes to :func:`bcp_fixpoint_plain`, the same computation one
problem at a time in PyTorch.  Like the Pallas kernel it has no
entry-overlap check; :func:`planes_fixpoint` adds it, as
``core.planes_fixpoint`` does around ``pallas_bcp.bcp_fixpoint``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import core

THREADS = 128

# Kernel launches since the count was last reset (one per launch).
launches = 0


def _check_args(tensors: dict, shapes: dict) -> torch.device:
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


def bcp_fixpoint(pos, neg, mem, card_active, card_n, min_bits, min_w, t0,
                 f0, en) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched fixpoint.  int32 inputs: pos/neg [B, C, W], mem [B, NA, W],
    card_active/card_n [B, NA], min_bits/t0/f0 [B, W], min_w/en [B].
    Returns (conflict int32[B], t, f int32[B, W])."""
    global launches
    B, C, W = pos.shape
    NA = mem.shape[1]
    args = dict(pos=pos, neg=neg, mem=mem, card_active=card_active,
                card_n=card_n, min_bits=min_bits, min_w=min_w, t0=t0, f0=f0,
                en=en)
    shapes = dict(pos=(B, C, W), neg=(B, C, W), mem=(B, NA, W),
                  card_active=(B, NA), card_n=(B, NA), min_bits=(B, W),
                  min_w=(B,), t0=(B, W), f0=(B, W), en=(B,))
    dev = _check_args(args, shapes)
    if dev.type == "cpu":
        return bcp_fixpoint_plain(**args)
    lib = _build.load()
    conflict = torch.empty(B, dtype=torch.int32, device=dev)
    t = torch.empty((B, W), dtype=torch.int32, device=dev)
    f = torch.empty((B, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.deppy_bcp_fixpoint(
        pos.data_ptr(), neg.data_ptr(), mem.data_ptr(),
        card_active.data_ptr(), card_n.data_ptr(), min_bits.data_ptr(),
        min_w.data_ptr(), t0.data_ptr(), f0.data_ptr(), en.data_ptr(),
        conflict.data_ptr(), t.data_ptr(), f.data_ptr(), B, C, NA, W,
        THREADS, stream)
    launches += 1
    _build.check(rc, "bcp_fixpoint")
    return conflict, t, f


def bcp_fixpoint_plain(pos, neg, mem, card_active, card_n, min_bits, min_w,
                       t0, f0, en):
    """The plain version of :func:`bcp_fixpoint`, on any device."""
    B, W = t0.shape
    conflict = torch.zeros(B, dtype=torch.int32, device=t0.device)
    t = t0.clone()
    f = f0.clone()
    for b in range(B):
        S = core._Space(core._to_u(pos[b]), core._to_u(neg[b]),
                        core._to_u(mem[b]), card_n[b].to(torch.int64),
                        card_active[b] != 0, None)
        c, tb, fb = core._fixpoint_u(S, core._to_u(t0[b]), core._to_u(f0[b]),
                                     core._to_u(min_bits[b]), int(min_w[b]),
                                     bool(en[b]), pre_check=False)
        conflict[b] = int(c)
        t[b] = core._to_i32(tb)
        f[b] = core._to_i32(fb)
    return conflict, t, f


def planes_fixpoint(pos, neg, mem, card_active, card_n, t0, f0, en):
    """Batched ``core.planes_fixpoint`` with no extras bound: a lane whose
    entry state sets a variable both ways is a conflict and runs no
    round; every other enabled lane runs :func:`bcp_fixpoint`.  ``en`` is
    bool[B].  Returns (conflict bool[B], t, f)."""
    B, W = t0.shape
    pre = en & ((t0 & f0) != 0).any(-1)
    zeros_w = torch.zeros((B, W), dtype=torch.int32, device=t0.device)
    zeros_b = torch.zeros(B, dtype=torch.int32, device=t0.device)
    conflict, t, f = bcp_fixpoint(
        pos, neg, mem, card_active, card_n, zeros_w, zeros_b, t0, f0,
        (en & ~pre).to(torch.int32))
    return (conflict != 0) | pre, t, f
